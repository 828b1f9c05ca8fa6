"""The PyTorch port stands alone: its carried host modules are its own
files (no links) holding the same code as the JAX package's (the same
syntax tree once docstrings are dropped: the copies cite the upstream
halo2-rsa sources by their relative paths), no file of it names an absolute
path of the checkout, it imports neither ``jax`` nor ``halo2_rsa_tpu`` nor
``cryptography``, and it proves on the CPU with all three blocked.
Comparisons are exact (syntax trees, bytes)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "halo2_rsa_tpu")
PORT = os.path.join(ROOT, "halo2_rsa_tpu_torch")

CARRIED = [
    "fields/field.py",
    "fields/limbs.py",
    "circuit/builder.py",
    "circuit/main_gate.py",
    "circuit/range_chip.py",
    "bigint/__init__.py",
    "bigint/chip.py",
    "bigint/types.py",
    "bigint/utils.py",
    "rsa/__init__.py",
    "rsa/chip.py",
    "rsa/types.py",
    "rsa/verifier.py",
    "sha256/__init__.py",
    "sha256/chip.py",
    "prover/curve.py",
    "prover/transcript.py",
]


def _code_without_docstrings(path: str) -> str:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_file_is_byte_identical(rel):
    """Same code (the name is kept from when the copies were links)."""
    port = os.path.join(PORT, rel)
    assert not os.path.islink(port), f"{rel} is a link, not the port's own file"
    assert _code_without_docstrings(port) == _code_without_docstrings(os.path.join(REF, rel)), \
        f"{rel} drifted from the JAX package's code"


def test_port_has_no_links_and_no_checkout_paths():
    here = os.path.abspath(ROOT)
    parent = os.path.dirname(here)
    needles = [here + os.sep] + ([parent + os.sep] if parent != os.sep else [])
    for dirpath, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in dirs + files:
            path = os.path.join(dirpath, name)
            assert not os.path.islink(path), f"{path} is a link"
            if name in files:
                with open(path, "rb") as f:
                    text = f.read().decode("utf-8", "replace")
                for needle in needles:
                    assert needle not in text, f"{path} names the absolute path {needle}"


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_port_imports_no_jax_reference_or_cryptography():
    banned = ("jax", "jaxlib", "halo2_rsa_tpu", "cryptography")
    sources = list(_port_sources())
    assert os.path.join(PORT, "bench", "vpu_ops.py") in sources
    assert os.path.join(PORT, "bench", "mont_layout.py") in sources
    for path in sources + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"


_BLOCKED_PROVE = r"""
import random, sys
sys.modules["jax"] = None
sys.modules["cryptography"] = None
sys.modules["halo2_rsa_tpu"] = None
import torch
torch.set_num_threads(1)
import halo2_rsa_tpu_torch
from halo2_rsa_tpu_torch import convert, golden, pipelines
from halo2_rsa_tpu_torch.circuit import checker
from halo2_rsa_tpu_torch.prover import kzg, plonk
meta, want = golden.load("arith_k5")
b, pubs = golden.build_circuit("arith_k5")
srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device="cpu")
pk, vk = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
proof = plonk.prove(pk, b.values, pubs, rng=random.Random(meta["seed"]))
assert proof == want, "proof differs from the JAX-made golden proof"
assert plonk.verify(vk, proof, pubs, device="cpu")
assert not plonk.verify(vk, proof, [pubs[0] + 1], device="cpu")
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m, v in sys.modules.items() if v)
print("OK", len(proof))
"""


def test_port_proves_k5_with_jax_and_cryptography_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_PROVE], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "OK 1280"

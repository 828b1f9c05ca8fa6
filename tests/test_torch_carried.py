"""The PyTorch port stands alone: its carried host modules are the JAX
package's files byte for byte (kept as relative symlinks, so they cannot
drift), it imports neither ``jax`` nor ``halo2_rsa_tpu`` nor
``cryptography``, and it proves on the CPU with all three blocked.
Comparisons are exact (bytes)."""

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


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_file_is_byte_identical(rel):
    with open(os.path.join(REF, rel), "rb") as a, open(os.path.join(PORT, rel), "rb") as b:
        assert a.read() == b.read(), f"{rel} drifted from the JAX package's copy"
    # a relative link, so any checkout or copy of the tree keeps it working
    link = os.path.join(PORT, rel)
    if os.path.islink(link):
        assert not os.path.isabs(os.readlink(link))


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_port_imports_no_jax_reference_or_cryptography():
    banned = ("jax", "jaxlib", "halo2_rsa_tpu", "cryptography")
    for path in _port_sources():
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
srs = kzg.setup(meta["srs_n"], tau=meta["tau"])
pk, vk = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
proof = plonk.prove(pk, b.values, pubs, rng=random.Random(meta["seed"]))
assert proof == want, "proof differs from the JAX-made golden proof"
assert plonk.verify(vk, proof, pubs)
assert not plonk.verify(vk, proof, [pubs[0] + 1])
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

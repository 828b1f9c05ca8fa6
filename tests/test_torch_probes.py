"""The probes P1 (integer op rates) and P2 (K1's memory layouts) of the
PyTorch port against the JAX package, on the CPU.

P1's plain version is held against the script's own ``body_*`` functions,
read from ``scripts/bench_vpu_ops.py`` with ``ast`` (the script runs its
benchmark when imported) and run with ``jnp`` on uint32. P2's plain
versions are held against ``pallas_mont.mont_mul_any`` run in interpret
mode, the function the script's in-kernel-transpose kernel computes. Inputs
come from seeded numpy generators; every comparison is bitwise.
"""

import ast
import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_rsa_tpu.fields import BN254_FQ, BN254_FR
from halo2_rsa_tpu.fields import pallas_mont
from halo2_rsa_tpu.fields import vecfield as jvf
from halo2_rsa_tpu_torch.bench import mont_layout, vpu_ops
from halo2_rsa_tpu_torch.fields import ALL_FIELDS as PORT_FIELDS
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.utils import cuda_build, profiling

torch.set_num_threads(1)
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "bench_vpu_ops.py")
REPS = 8


def _script():
    """(the script's body functions run with REPS, {probe name: (body
    function name, ops per rep)} from its results table)."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read(), SCRIPT)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("body_")]
    ns = {"jnp": jnp, "np": np, "REPS": REPS, "MASK": np.uint32(0xFFFF)}
    exec(compile(ast.Module(body=defs, type_ignores=[]), SCRIPT, "exec"), ns)
    loop = next(n for n in tree.body if isinstance(n, ast.For))
    table = {}
    for row in loop.iter.elts:
        name, call, ops = row.elts
        table[name.value] = (call.args[0].id, ops.value)
    return ns, table


@pytest.fixture(scope="module")
def script():
    return _script()


def test_p1_bodies_and_accounting_match_the_script(script):
    _, table = script
    assert vpu_ops.BODIES == {name: ops for name, (_, ops) in table.items()}
    assert list(vpu_ops.BODIES) == list(table)


@pytest.mark.parametrize("body", list(vpu_ops.BODIES))
def test_p1_plain_matches_the_script_body(script, body):
    ns, table = script
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 32, (16, 256), dtype=np.uint32)
    y = rng.integers(0, 1 << 32, (16, 256), dtype=np.uint32)
    x[0, :4] = [0, 1, 0xFFFFFFFF, 0xFFFF0000]  # wraparound edges
    y[0, :4] = [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFF]
    want = np.asarray(ns[table[body][0]](jnp.asarray(x), jnp.asarray(y)))
    xt = torch.from_numpy(x.view(np.int32))
    yt = torch.from_numpy(y.view(np.int32))
    got = vpu_ops.int_ops(body, xt, yt, REPS)  # a CPU tensor takes the plain version
    assert got.dtype == torch.int32 and got.shape == (16, 256)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def _port(field):
    return next(f for f in PORT_FIELDS if f.name == field.name)


@pytest.mark.parametrize("field", [BN254_FR, BN254_FQ], ids=lambda f: f.name)
def test_p2_plain_layouts_match_pallas_interpret(field):
    fct = tvf.consts(_port(field))
    n = 256
    a = mont_layout.random_elements(fct, n, 3, "cpu")
    b = mont_layout.random_elements(fct, n, 4, "cpu")
    a[:3] = tvf.from_ints(fct, [0, 1, field.p - 1], mont=False, device="cpu")
    b[:3] = tvf.from_ints(fct, [field.p - 1] * 3, mont=False, device="cpu")
    want = np.asarray(pallas_mont.mont_mul_any(
        jvf.consts(field), jnp.asarray(tvf.limbs_to_ref(a)), jnp.asarray(tvf.limbs_to_ref(b)),
        interpret=True))
    lm = mont_layout.mont_mul_lm(fct, a.t().contiguous(), b.t().contiguous())
    assert lm.shape == (8, n)
    assert np.array_equal(tvf.limbs_to_ref(lm.t()), want)
    for t in mont_layout.THREADS:
        staged = mont_layout.mont_mul_staged(fct, a, b, t)
        assert np.array_equal(tvf.limbs_to_ref(staged), want)
    assert np.array_equal(tvf.limbs_to_ref(mont_layout.mont_mul_lm_plain(
        fct, a.t().contiguous(), b.t().contiguous()).t()), want)
    assert np.array_equal(tvf.limbs_to_ref(mont_layout.mont_mul_staged_plain(fct, a, b)), want)


def test_p2_random_elements_are_canonical():
    for field in PORT_FIELDS:
        fc = tvf.consts(field)
        xs = tvf.to_ints(fc, mont_layout.random_elements(fc, 512, 9, "cpu"), mont=False)
        assert all(0 <= v < field.p for v in xs)
        assert len(set(xs)) == 512


def test_p1_run_on_cpu_returns_every_body():
    before = dict(vpu_ops.LAUNCHES)
    res = vpu_ops.run(log_n=8, reps=REPS, iters=1, device="cpu")
    assert res["device"] == "cpu" and res["reps"] == REPS
    assert list(res["bodies"]) == list(vpu_ops.BODIES)
    for r in res["bodies"].values():
        assert r["ms"] > 0 and r["tops"] > 0 and r["tsteps"] > 0
    assert vpu_ops.LAUNCHES == before  # the plain version is no launch


def test_p2_run_on_cpu_returns_every_variant():
    before = dict(mont_layout.LAUNCHES)
    res = mont_layout.run(log_n=8, iters=1, device="cpu")
    assert res["device"] == "cpu" and res["field"] == "bn254_fr"
    assert list(res["variants"]) == ["a", "b'", "c"] + [f"d'{t}" for t in mont_layout.THREADS]
    for r in res["variants"].values():
        assert r["ms"] > 0 and r["mel_s"] > 0 and r["gb_s"] > 0
    assert mont_layout.LAUNCHES == before


def test_probe_wrappers_reject_bad_arguments_everywhere():
    x = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        vpu_ops.int_ops("fma", x, x, REPS)
    with pytest.raises(ValueError):
        vpu_ops.int_ops_plain("fma", x, x, REPS)
    fc = tvf.consts(PORT_FIELDS[0])
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        mont_layout.mont_mul_staged(fc, a, a, threads=64)


def test_pipe_counts_split_sass_by_pipe():
    ops = collections.Counter({"IMAD.WIDE.U32": 3, "IMAD.MOV.U32": 1, "IADD3.X": 2,
                               "LOP3.LUT": 1, "LDG.E.CONSTANT": 2, "ULDC.64": 1, "NOP": 4})
    assert cuda_build.pipe_counts(ops) == dict(fma=4, alu=3, issued=10)
    assert cuda_build.int_instructions(ops) == 7


def test_chain_ms_feeds_tensors_and_tuples_back():
    seen = []

    def step(p):
        seen.append(int(p[0][0]))
        return (p[0] + 1, p[1])

    t = torch.zeros(4, dtype=torch.int64)
    assert profiling.chain_ms(step, (t, t), 3) >= 0
    assert seen == [0, 1, 2, 3]  # one warm-up call, then the chain
    assert profiling.chain_ms(lambda x: x + 1, t, 2) >= 0

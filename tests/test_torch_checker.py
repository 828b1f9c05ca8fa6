"""The PyTorch port's constraint checker (the MockProver analog) against the
JAX package's, on the CPU.

The same circuits are built by both packages' carried gadgets: a
``BigIntChip`` ``mul_mod`` at 256 bits over two fields, and the three golden
circuits of ``halo2_rsa_tpu_torch/golden.py``. ``run``, ``check``,
``failing_gates``, ``explain`` and ``format_failures`` must give exactly the
JAX package's results on each valid witness and on seeded corruptions of it
(gate cells and lookup cells). ``eval_lookup`` is held against the JAX
function and against Python ints at every bit width's edges, with limbs
whose bit 31 is set (negative in the port's int32 storage); ``eval_gates``
over a batch of witnesses equals one check per witness; and
``Pkcs1v15Circuit.check`` equals the JAX package's on the RSA-1024
SHA-disabled circuit, valid and with a wrong public input.
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_rsa_tpu import pipelines as jpipe
from halo2_rsa_tpu.bigint import BigIntChip as JBigIntChip
from halo2_rsa_tpu.circuit import Builder as JBuilder
from halo2_rsa_tpu.circuit import MainGate as JMainGate
from halo2_rsa_tpu.circuit import RangeChip as JRangeChip
from halo2_rsa_tpu.circuit import checker as jchecker
from halo2_rsa_tpu.fields import field as jfield
from halo2_rsa_tpu_torch import golden
from halo2_rsa_tpu_torch import pipelines as tpipe
from halo2_rsa_tpu_torch.bigint import BigIntChip
from halo2_rsa_tpu_torch.circuit import Builder
from halo2_rsa_tpu_torch.circuit import checker
from halo2_rsa_tpu_torch.fields import field as tfield
from halo2_rsa_tpu_torch.fields import vecfield

torch.set_num_threads(1)

JAX_CLASSES = dict(Builder=JBuilder, MainGate=JMainGate, RangeChip=JRangeChip,
                   BigIntChip=JBigIntChip, field=jfield.BN254_FR)
FIELDS = ("BN254_FR", "PASTA_FP")


def _mul_mod(builder_cls, chip_cls, field, bits=256, seed=0):
    """bench.py's config #1 circuit at ``bits``: a * b mod n, asserted equal
    to a fresh assignment of the answer."""
    rng = random.Random(0)
    n_v = 0
    while n_v.bit_length() != bits:
        n_v = rng.getrandbits(bits)
    r = random.Random(seed)
    a_v = r.getrandbits(bits) % n_v
    b_v = r.getrandbits(bits) % n_v
    b = builder_cls(field)
    chip = chip_cls(b, 64, bits)
    res = chip.mul_mod(chip.assign_integer(a_v), chip.assign_integer(b_v),
                       chip.assign_integer(n_v))
    chip.assert_equal_fresh(res, chip.assign_integer((a_v * b_v) % n_v))
    return b


def _pair(name):
    """(port builder, JAX builder) of one test circuit."""
    if name.startswith("mul_mod"):
        f = name.split(":")[1]
        return (_mul_mod(Builder, BigIntChip, getattr(tfield, f)),
                _mul_mod(JBuilder, JBigIntChip, getattr(jfield, f)))
    return golden.build_circuit(name)[0], golden.build_circuit(name, JAX_CLASSES)[0]


CIRCUITS = [f"mul_mod:{f}" for f in FIELDS] + list(golden.CASES)


def _corrupt(builder, seed: int) -> list:
    """A copy of the builder's values with 3 gate cells and 3 lookup cells
    changed (numpy rng ``seed``): gate cells get a random canonical value,
    lookup cells 2^bits, 2^31 + 5 (bit 31 of limb 0 set) and 2^63 + 1."""
    rng = np.random.default_rng(seed)
    p = builder.field.p
    vals = list(builder.values)
    gate_cells = np.unique(np.asarray(builder.gate_idx))
    for c in rng.choice(gate_cells, 3, replace=False):
        vals[int(c)] = int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 1 << 62)) % p
    if builder.lookups:
        picks = rng.choice(len(builder.lookups), min(3, len(builder.lookups)), replace=False)
        for j, new in zip(picks, ("edge", 1 << 31 | 5, 1 << 63 | 1)):
            cell, bits = builder.lookups[int(j)]
            vals[cell] = (1 << bits) if new == "edge" else new
    return vals


def _ref_limbs(vals) -> np.ndarray:
    return jchecker.witness_limbs(list(vals))


@pytest.mark.parametrize("name", CIRCUITS)
def test_run_matches_reference(name):
    tb, jb = _pair(name)
    assert tb.values == jb.values
    want = jchecker.run(jb)
    assert want["ok"]
    assert checker.run(tb, device="cpu") == want
    # the builder's own witness, corrupted: run reads it from the builder
    bad = _corrupt(tb, 7)
    tb.values[:] = bad
    jb.values[:] = bad
    want = jchecker.run(jb)
    assert not want["ok"]
    assert checker.run(tb, device="cpu") == want


@pytest.mark.parametrize("name", CIRCUITS)
def test_check_failing_gates_explain_match_reference(name):
    tb, jb = _pair(name)
    bad = _corrupt(tb, 11)
    w = checker.witness_limbs(bad)
    assert np.array_equal(vecfield.limbs_to_ref(w), _ref_limbs(bad))
    tc, jc = checker.compile_circuit(tb), jchecker.compile_circuit(jb)
    want = jchecker.check(jc, _ref_limbs(bad))
    assert checker.check(tc, w, device="cpu") == want
    assert want["gate_violations"] > 0
    assert want["lookup_violations"] > 0 or not jb.lookups
    got_rows = checker.failing_gates(tc, w, limit=50, device="cpu")
    assert got_rows == jchecker.failing_gates(jc, _ref_limbs(bad), limit=50)
    report = checker.explain(tb, w, limit=64, device="cpu")
    assert report == jchecker.explain(jb, _ref_limbs(bad), limit=64)
    assert checker.format_failures(report) == jchecker.format_failures(report)
    kinds = {f["kind"] for f in report}
    assert "gate" in kinds and ("lookup" in kinds or not jb.lookups)
    assert all(isinstance(v, int) for f in report for v in f.get("values", [f.get("value", 0)]))
    # a valid witness explains to nothing
    assert checker.explain(tb, device="cpu") == [] == jchecker.explain(jb)


def test_explain_limit_matches_reference():
    tb, jb = _pair("mul_mod:BN254_FR")
    bad = _corrupt(tb, 3)
    for limit in (1, 4):
        report = checker.explain(tb, checker.witness_limbs(bad), limit=limit, device="cpu")
        assert len(report) == limit
        assert report == jchecker.explain(jb, _ref_limbs(bad), limit=limit)


LOOKUP_BITS = [1, 3, 4, 5, 8, 16, 31, 32, 33, 63, 64, 65, 96, 128, 200, 253]


def _edge_values(bits: int, p: int) -> list:
    vals = {0, 1, (1 << bits) - 1, 1 << bits, (1 << bits) + 1, 1 << 31, (1 << 31) | 7,
            (1 << 32) - 1, 1 << 63, (1 << 63) | 3, (1 << 64) - 1, p - 1,
            ((1 << bits) - 1) | (1 << 31), (1 << bits) | (1 << 31)}
    for j in range(8):  # bit 31 of each limb
        vals.add(1 << (32 * j + 31))
    return sorted(v for v in vals if v < p)


@pytest.mark.parametrize("bits", LOOKUP_BITS)
def test_eval_lookup_edges_match_reference(bits):
    p = tfield.BN254_FR.p
    vals = _edge_values(bits, p)
    got = checker.eval_lookup(torch.from_numpy(checker.witness_limbs(vals)), bits)
    want = np.asarray(jchecker.eval_lookup(jnp.asarray(_ref_limbs(vals)), bits))
    assert got.tolist() == want.tolist() == [v < (1 << bits) for v in vals]
    # leading batch axes
    batched = checker.eval_lookup(torch.from_numpy(checker.witness_limbs(vals)).reshape(
        1, len(vals), 8).expand(2, -1, -1), bits)
    assert batched.tolist() == [got.tolist()] * 2


def test_eval_gates_batch_equals_single_checks():
    builders = [_mul_mod(Builder, BigIntChip, tfield.BN254_FR, seed=s) for s in range(4)]
    vals = [list(b.values) for b in builders]
    vals[2] = _corrupt(builders[2], 5)
    vals[3] = _corrupt(builders[3], 6)
    compiled = checker.compile_circuit(builders[0])
    fc = compiled.fc
    w4 = torch.from_numpy(np.stack([checker.witness_limbs(v) for v in vals]))
    gate_idx = torch.from_numpy(compiled.gate_idx.astype(np.int64))
    coef = torch.from_numpy(compiled.coef_table)[torch.from_numpy(
        compiled.gate_coef_id.astype(np.int64))]
    ok = checker.eval_gates(fc, gate_idx, coef, vecfield.to_mont(fc, w4))
    assert ok.shape == (4, compiled.num_gates)
    for i in range(4):
        single = checker.eval_gates(fc, gate_idx, coef, vecfield.to_mont(fc, w4[i]))
        assert torch.equal(ok[i], single)
        lv = sum(int((~checker.eval_lookup(w4[i, torch.from_numpy(idx.astype(np.int64))],
                                            bits)).sum())
                 for bits, idx in compiled.lookup_groups)
        want = jchecker.check(jchecker.compile_circuit(
            _mul_mod(JBuilder, JBigIntChip, jfield.BN254_FR, seed=i)), _ref_limbs(vals[i]))
        assert (int((~ok[i]).sum()), lv) == (want["gate_violations"], want["lookup_violations"])
        assert want["ok"] == (i < 2)


@pytest.fixture(scope="module")
def rsa1024():
    msg = bytes(random.Random(7).randrange(256) for _ in range(32))
    n, sig = tpipe.sign_fixture(1024, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    return (tpipe.Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed),
            jpipe.Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed))


@pytest.mark.parametrize("wrong_input", [False, True])
def test_pkcs1v15_check_matches_reference(rsa1024, wrong_input):
    port, ref = rsa1024
    pubs = list(port.public_inputs)
    if wrong_input:
        pubs[0] += 1
    tcirc = tpipe.Pkcs1v15Circuit(builder=port.builder, public_inputs=pubs, bits=1024)
    jcirc = jpipe.Pkcs1v15Circuit(builder=ref.builder, public_inputs=pubs, bits=1024)
    want = jcirc.check()
    assert tcirc.check(device="cpu") == want
    assert want["ok"] is not wrong_input and want["instance_ok"] is not wrong_input

"""The PyTorch port's batched witness replay against the JAX package's, on
the CPU.

The JAX replay tests' three circuits (a ``BigIntChip`` ``mul_mod`` at 256
bits with 4 instances; select / is_equal / to_bits / or / a range chip with
a source, 4 cases; ``pow_mod_fixed_exp`` e = 257 at 128 bits, 3 instances)
are built by both packages' carried gadgets. Each JAX program is built and
run once per module; the port's ``generate(device="cpu")`` must equal its
output bit for bit (through ``vecfield.limbs_to_ref``), equal each
builder's ``checker.witness_limbs``, and pass the port's checker. Then:
``shrmask`` on 32-bit limbs against Python ints across the limb edges;
``inv0`` of zero and non-zero values; two RSA-1024 flagship instances
(SHA disabled) against synthesis (JAX's CPU replay of that circuit takes
minutes, so it is not run); every product reaching K1 with its constant
rows read in place; and the error cases.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.bigint import BigIntChip as JBigIntChip
from halo2_rsa_tpu.circuit import Builder as JBuilder
from halo2_rsa_tpu.circuit import MainGate as JMainGate
from halo2_rsa_tpu.circuit import RangeChip as JRangeChip
from halo2_rsa_tpu.fields import BN254_FR as J_BN254_FR
from halo2_rsa_tpu.witness import WitnessProgram as JWitnessProgram
from halo2_rsa_tpu_torch.bigint import BigIntChip
from halo2_rsa_tpu_torch.circuit import Builder, MainGate, RangeChip, checker
from halo2_rsa_tpu_torch.fields import BN254_FR, cuda_mont, vecfield
from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture
from halo2_rsa_tpu_torch.witness import WitnessProgram

torch.set_num_threads(1)

PORT = dict(Builder=Builder, MainGate=MainGate, RangeChip=RangeChip, BigIntChip=BigIntChip,
            field=BN254_FR)
JAX = dict(Builder=JBuilder, MainGate=JMainGate, RangeChip=JRangeChip, BigIntChip=JBigIntChip,
           field=J_BN254_FR)


def _modulus(rng, bits):
    n_v = 0
    while n_v.bit_length() != bits:
        n_v = rng.getrandbits(bits)
    return n_v


def _mul_mod_case(pkg):
    """tests/test_witness_replay.py's mul_mod circuit: 4 instances at 256
    bits under one n."""
    rng = random.Random(0)
    bits = 256
    n_v = _modulus(rng, bits)

    def build(a_v, b_v):
        b = pkg["Builder"](pkg["field"])
        chip = pkg["BigIntChip"](b, 64, bits)
        res = chip.mul_mod(chip.assign_integer(a_v), chip.assign_integer(b_v),
                           chip.assign_integer(n_v))
        chip.assert_equal_fresh(res, chip.assign_integer((a_v * b_v) % n_v))
        return b

    return [build(rng.getrandbits(bits) % n_v, rng.getrandbits(bits) % n_v) for _ in range(4)]


def _logic_case(pkg):
    """select / is_zero / to_bits / or in one circuit, with a range chip fed
    from a source cell; the template is the first case."""

    def build(x, y):
        b = pkg["Builder"](pkg["field"])
        mg = pkg["MainGate"](b)
        a = mg.assign_value(x)
        c = mg.assign_value(y)
        eqb = mg.is_equal(a, c)
        sel = mg.select(a, c, eqb)
        bits = mg.to_bits(sel, 16)
        o = mg.or_(bits[0], bits[1])
        mg.assert_bit(o)
        rc = pkg["RangeChip"](b)
        rc.assign(x & 0xFF, 4, 8, source=a)
        return b

    return [build(x, y) for x, y in [(0xAB, 0xAB), (3, 5), (0, 0), (65535, 1)]]


def _pow_mod_case(pkg):
    """pow_mod_fixed_exp with e = 257 at 128 bits, 3 instances."""
    rng = random.Random(7)
    bits = 128
    n_v = _modulus(rng, bits)

    def build(x_v):
        b = pkg["Builder"](pkg["field"])
        chip = pkg["BigIntChip"](b, 64, bits)
        x = chip.assign_integer(x_v)
        n = chip.assign_integer(n_v)
        chip.assert_in_field(x, n)
        powed = chip.pow_mod_fixed_exp(x, 257, n)
        chip.assert_equal_fresh(powed, chip.assign_integer(pow(x_v, 257, n_v)))
        return b

    return [build(rng.getrandbits(bits) % n_v) for _ in range(3)]


CASES = {"mul_mod_256": _mul_mod_case, "logic_ops": _logic_case, "pow_mod_257": _pow_mod_case}


def _instances(template, builders):
    """Input values of synthesized instances keyed by the template's cells."""
    return [{i: b.values[i] for i in template.input_cells()} for b in builders]


@pytest.fixture(scope="module")
def replayed():
    """{case: (port builders, the port's replay on the CPU, the JAX
    package's replay)}, each program built and run once."""
    out = {}
    for name, make in CASES.items():
        tbs, jbs = make(PORT), make(JAX)
        assert [b.values for b in tbs] == [b.values for b in jbs]
        want = np.asarray(JWitnessProgram(jbs[0]).generate(_instances(jbs[0], jbs)))
        got = WitnessProgram(tbs[0]).generate(_instances(tbs[0], tbs), device="cpu")
        out[name] = (tbs, got, want)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_replay_equals_jax(replayed, name):
    tbs, got, want = replayed[name]
    assert got.dtype == np.int32 and got.shape == (len(tbs), tbs[0].num_witness, 8)
    assert np.array_equal(vecfield.limbs_to_ref(got), want)


@pytest.mark.parametrize("name", list(CASES))
def test_replay_equals_synthesis(replayed, name):
    tbs, got, _ = replayed[name]
    for bi, b in enumerate(tbs):
        assert np.array_equal(got[bi], checker.witness_limbs(b)), f"instance {bi}"


@pytest.mark.parametrize("name", list(CASES))
def test_replayed_witnesses_pass_the_checker(replayed, name):
    tbs, got, _ = replayed[name]
    compiled = checker.compile_circuit(tbs[0])
    for bi in range(len(tbs)):
        assert checker.check(compiled, got[bi], device="cpu")["ok"], f"instance {bi}"


def _limb_edge_values():
    """Values below BN254 Fr's p with bit 31 and bit 63 set in their limbs
    (negative limbs in int32 storage), and the edges 0 and p - 1."""
    rng = random.Random(5)
    p = BN254_FR.p
    every = sum(((1 << 31) | rng.getrandbits(31)) << (32 * j) for j in range(7))
    return [0, 1, p - 1, (1 << 31) | 5, (1 << 63) | (1 << 31) | 1, every,
            every | (1 << 253), (1 << 64) - 1, rng.randrange(p), rng.randrange(p)]


@pytest.mark.parametrize("mask", [0, 1, 8, 31, 32, 33, 64])
@pytest.mark.parametrize("shift", [0, 1, 16, 31, 32, 33, 63, 64, 65, 120, 200])
def test_shrmask_across_limb_edges(shift, mask):
    """A cell ("shrmask", x, shift, mask) replays as (x >> shift) & (2^mask
    - 1) (mask 0: no mask) over 32-bit limbs."""
    b = Builder(BN254_FR)
    x = b.new_cell(0, ("in",))
    y = b.new_cell(0, ("shrmask", x.idx, shift, mask))
    vals = _limb_edge_values()
    w = WitnessProgram(b).generate([{x.idx: v} for v in vals], device="cpu")
    got = vecfield.to_ints(vecfield.consts(BN254_FR), w[:, y.idx], mont=False)
    keep = (1 << mask) - 1 if mask else -1
    assert got == [(v >> shift) & keep for v in vals]


def _is_equal(pkg, x, y):
    b = pkg["Builder"](pkg["field"])
    mg = pkg["MainGate"](b)
    mg.is_equal(mg.assign_value(x), mg.assign_value(y))
    return b


def test_inv0_of_zero_and_nonzero():
    """is_equal's inverse hint: the inverse of x - y, and 0 where x = y."""
    pairs = [(5, 5), (3, 9), (0, 0), (BN254_FR.p - 1, 1), (7, 7)]
    builders = [_is_equal(PORT, x, y) for x, y in pairs]
    prog = WitnessProgram(builders[0])
    assert [g.kind for g in prog.groups].count("inv0") == 1
    w = prog.generate(_instances(builders[0], builders), device="cpu")
    for bi, b in enumerate(builders):
        assert np.array_equal(w[bi], checker.witness_limbs(b)), pairs[bi]
    jb = [_is_equal(JAX, x, y) for x, y in pairs]
    want = np.asarray(JWitnessProgram(jb[0]).generate(_instances(jb[0], jb)))
    assert np.array_equal(vecfield.limbs_to_ref(w), want)


def _flagship(s):
    """An RSA-1024 SHA-disabled instance under the key of
    ``sign_fixture(1024, ., random.Random(7))``, its 32 B message from
    random.Random(s)."""
    msg = bytes(random.Random(s).randrange(256) for _ in range(32))
    n, sig = sign_fixture(1024, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    return Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed)


def test_flagship_instances_replay_to_synthesis():
    circs = [_flagship(s) for s in range(2)]
    template = circs[0].builder
    w = WitnessProgram(template).generate(
        _instances(template, [c.builder for c in circs]), device="cpu")
    compiled = circs[0].compile()
    for bi, c in enumerate(circs):
        assert np.array_equal(w[bi], checker.witness_limbs(c.builder)), f"instance {bi}"
        assert checker.check(compiled, w[bi], device="cpu")["ok"]


def test_products_reach_k1_with_constant_rows_in_place(monkeypatch):
    """Every product of a replay is one K1 call on operands of equal shape
    or on a group's constant rows read as "cycle" broadcast rows (never
    materialised), and the inversion is one K1-pow call."""
    calls, pows = [], []
    real_mul, real_pow = cuda_mont.mont_mul, cuda_mont.mont_pow

    def mul(fc, a, b, bcast=None):
        calls.append((tuple(a.shape), tuple(b.shape), bcast))
        return real_mul(fc, a, b, bcast)

    def pow_(fc, a, e):
        pows.append((tuple(a.shape), e))
        return real_pow(fc, a, e)

    monkeypatch.setattr(cuda_mont, "mont_mul", mul)
    monkeypatch.setattr(cuda_mont, "mont_pow", pow_)
    builders = _logic_case(PORT)
    prog = WitnessProgram(builders[0])
    prog.generate(_instances(builders[0], builders), device="cpu")
    assert calls and all(bcast in (None, "cycle") for _, _, bcast in calls)
    for a, b, bcast in calls:
        assert b == a if bcast is None else b in ((8,), a[1:])
    inv = [g for g in prog.groups if g.kind == "inv0"]
    assert pows == [((4, len(inv[0].dst), 8), BN254_FR.p - 2)]


def test_opaque_cell_raises():
    b = Builder(BN254_FR)
    b.new_cell(3)  # no provenance
    with pytest.raises(ValueError, match="lack provenance"):
        WitnessProgram(b)


def test_mismatched_instance_keys_raise():
    builders = _logic_case(PORT)
    prog = WitnessProgram(builders[0])
    inst = _instances(builders[0], builders[:1])[0]
    inst.pop(next(iter(inst)))
    with pytest.raises(AssertionError, match="input cells mismatch"):
        prog.generate([inst], device="cpu")

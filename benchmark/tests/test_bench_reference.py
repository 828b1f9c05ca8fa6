"""The reference's arithmetic on tiny inputs: G1's group law, the Lagrange
basis at tau, the verifier on the committed golden proofs (byte for byte the
JAX package's), the violation counts."""

from __future__ import annotations

import json
import os
import random

import pytest

from refimpl import checks, g1, plonk
from refimpl.synth.bigint import BigIntChip
from refimpl.synth.circuit import Builder, MainGate, RangeChip
from refimpl.synth.fields import BN254_FR

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CASES = {"arith_k5": (5, 111222333), "lookup_k5": (5, 777888999), "mulmod_k10": (10, 13579)}


def golden_circuit(name: str):
    """The golden cases' circuits (``halo2_rsa_tpu_torch/golden.py``)."""
    b = Builder(BN254_FR)
    if name == "arith_k5":
        mg = MainGate(b)
        a, c = mg.assign_value(3), mg.assign_value(5)
        m = mg.mul(a, c)
        b.expose_public(mg.mul_add(mg.add(m, a), c, m))
        return b, [(3 * 5 + 3) * 5 + 3 * 5]
    if name == "lookup_k5":
        rc, mg = RangeChip(b), MainGate(b)
        b.expose_public(mg.add(rc.assign(0xAB, 4, 8), rc.assign(0x3C, 4, 8)))
        return b, [0xAB + 0x3C]
    rng = random.Random(5)
    n_v = 0
    while n_v.bit_length() != 128:
        n_v = rng.getrandbits(128)
    a_v, b_v = rng.getrandbits(128) % n_v, rng.getrandbits(128) % n_v
    chip = BigIntChip(b, 64, 128)
    res = chip.mul_mod(chip.assign_integer(a_v), chip.assign_integer(b_v),
                       chip.assign_integer(n_v))
    for limb in res.limbs:
        b.expose_public(limb)
    want = a_v * b_v % n_v
    return b, [(want >> (64 * i)) & ((1 << 64) - 1) for i in range(2)]


def load(name: str):
    with open(os.path.join(DATA, f"golden_{name}.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DATA, f"golden_{name}.bin"), "rb") as f:
        return meta, f.read()


def test_g1_group_law():
    p3 = g1.mul_gen(3)
    assert p3 == g1.add(g1.add(g1.GEN, g1.GEN), g1.GEN)
    assert g1.on_curve(p3) and g1.mul_gen(g1.R) is None
    assert g1.msm([5, 7], [g1.GEN, p3]) == g1.mul_gen(26)
    assert g1.add(p3, g1.neg(p3)) is None
    assert g1.msm([2], [p3]) == g1.mul_gen(6)  # the doubling path


def test_decompress_rejects_bad_encodings():
    x_bytes = (1).to_bytes(32, "little")
    assert g1.decompress(x_bytes) in ((1, 2), (1, g1.Q - 2))
    with pytest.raises(ValueError):
        g1.decompress(bytes(31) + b"\x40")
    with pytest.raises(ValueError):
        g1.decompress(g1.Q.to_bytes(32, "little"))


def test_lagrange_basis_at_tau():
    k, tau = 3, 12345
    lag, pows = plonk.lagrange_at(k, tau)
    assert sum(lag) % plonk.R == 1  # the constant 1 interpolates to 1
    assert sum(l * w for l, w in zip(lag, pows)) % plonk.R == tau  # X interpolates to X
    assert pow(plonk.omega(k), 8, plonk.R) == 1 and pow(plonk.omega(k), 4, plonk.R) != 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_proofs(name):
    k, tau = CASES[name]
    meta, proof = load(name)
    builder, pubs = golden_circuit(name)
    vk = plonk.verifying_key(plonk.Structure(builder), k, tau)
    pts = lambda key: [None if p is None else (int(p[0]), int(p[1]))  # noqa: E731
                       for p in meta["vk"][key]]
    assert vk.fixed_commitments == pts("fixed_commitments")
    assert vk.sigma_commitments == pts("sigma_commitments")
    assert vk.table_commitments == pts("table_commitments")
    assert plonk.verify(vk, proof, pubs, tau)
    assert not plonk.verify(vk, proof, [pubs[0] + 1] + pubs[1:], tau)
    assert not plonk.verify(vk, proof[:-32], pubs, tau)
    flipped = bytearray(proof)
    flipped[-40] ^= 1  # inside the last evaluation-point opening
    assert not plonk.verify(vk, bytes(flipped), pubs, tau)
    assert not plonk.verify(vk, proof, pubs, tau + 1)


def test_violation_counts():
    b, _ = golden_circuit("lookup_k5")
    st = plonk.Structure(b)
    assert checks.violations(st, b.values) == (0, 0)
    vals = list(b.values)
    cell, bits = b.lookups[0]
    vals[cell] = 1 << bits  # one past the table
    gates, lookups = checks.violations(st, vals)
    assert lookups == 1 and gates >= 1

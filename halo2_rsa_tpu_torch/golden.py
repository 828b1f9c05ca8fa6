"""The golden proofs: two small circuits whose JAX-made proofs are committed
under ``tests/data`` and that the port must reproduce byte for byte.

``scripts/make_torch_golden.py`` proves them once with the JAX package; the
CPU tests, the card tests (``pytest -m cuda``) and the first entries of the
card gate's path table (``chip_smoke.CONFIGS``) rebuild the same circuits
with the port's carried builder and compare. The circuit code takes the
builder classes as arguments, so one definition serves both packages.
"""

from __future__ import annotations

import json
import os
import random

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")

# name -> (k, SRS size, tau, rng seed of the blinding draws)
CASES = {
    "arith_k5": dict(k=5, srs_n=1 << 7, tau=111222333, seed=1),
    "lookup_k5": dict(k=5, srs_n=1 << 7, tau=777888999, seed=3),
    "mulmod_k10": dict(k=10, srs_n=(1 << 10) + 8, tau=13579, seed=5),
}


def _port_classes():
    from .bigint import BigIntChip
    from .circuit.builder import Builder
    from .circuit.main_gate import MainGate
    from .circuit.range_chip import RangeChip
    from .fields.field import BN254_FR

    return dict(Builder=Builder, MainGate=MainGate, RangeChip=RangeChip,
                BigIntChip=BigIntChip, field=BN254_FR)


def build_circuit(name: str, classes: dict | None = None):
    """(builder, public_inputs) of golden case ``name``. ``classes`` maps
    Builder / MainGate / RangeChip / BigIntChip / field to one package's objects
    (default: this package's)."""
    c = classes or _port_classes()
    b = c["Builder"](c["field"])
    if name == "arith_k5":
        # tests/test_plonk.py::_small_arith_builder
        x, y = 3, 5
        mg = c["MainGate"](b)
        a = mg.assign_value(x)
        cc = mg.assign_value(y)
        m = mg.mul(a, cc)
        s = mg.add(m, a)
        out = mg.mul_add(s, cc, m)
        b.expose_public(out)
        return b, [(x * y + x) * y + x * y]
    if name == "lookup_k5":
        # tests/test_plonk.py::test_prove_verify_with_lookups
        rc = c["RangeChip"](b)
        mg = c["MainGate"](b)
        cell = rc.assign(0xAB, 4, 8)
        cell2 = rc.assign(0x3C, 4, 8)
        b.expose_public(mg.add(cell, cell2))
        return b, [0xAB + 0x3C]
    if name == "mulmod_k10":
        # tests/test_plonk.py::test_prove_verify_bigint_mulmod
        rng = random.Random(5)
        bits = 128
        n_v = 0
        while n_v.bit_length() != bits:
            n_v = rng.getrandbits(bits)
        a_v = rng.getrandbits(bits) % n_v
        b_v = rng.getrandbits(bits) % n_v
        chip = c["BigIntChip"](b, 64, bits)
        a = chip.assign_integer(a_v)
        bb = chip.assign_integer(b_v)
        n = chip.assign_integer(n_v)
        res = chip.mul_mod(a, bb, n)
        for limb in res.limbs:
            b.expose_public(limb)
        want = (a_v * b_v) % n_v
        return b, [(want >> (64 * i)) & ((1 << 64) - 1) for i in range(2)]
    raise KeyError(name)


def points_to_json(points) -> list:
    """Host affine points -> JSON (decimal strings; None = identity)."""
    return [None if p is None else [str(p[0]), str(p[1])] for p in points]


def load(name: str) -> tuple[dict, bytes]:
    """(metadata, proof bytes) of a committed golden case."""
    with open(os.path.join(DATA_DIR, f"torch_golden_{name}.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DATA_DIR, f"torch_golden_{name}.bin"), "rb") as f:
        proof = f.read()
    return meta, proof

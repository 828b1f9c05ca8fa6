"""The field layer's own K1 kernels against the JAX package: K1-pow (the
exponentiation in one launch) through its plain version and
``vecfield.pow_const`` / ``inv``; K1-prefix (the prefix and suffix product
in at most three launches) through its plain version and
``vecfield.prefix_mul``, ``batch_inv_nz`` and ``pow_series``, at row lengths
around K1-prefix's tile; and K1 with a broadcast operand read in place
(``vecfield.broadcast_pattern``, which classifies a pair of shapes, and
``vecfield.mont_mul`` on each pattern).

Inputs are made from a seeded numpy generator and go through both packages
on BN254 Fr and Fq; every comparison is bitwise (the port's (..., 8) limbs
in the reference's (..., 16) layout, ``np.array_equal``). On the CPU every
wrapper takes its plain version, which the card gate holds its kernel
against.
"""

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.fields import BN254_FQ, BN254_FR
from halo2_rsa_tpu.fields import vecfield as jvf
from halo2_rsa_tpu_torch.fields import ALL_FIELDS as PORT_FIELDS
from halo2_rsa_tpu_torch.fields import cuda_mont
from halo2_rsa_tpu_torch.fields import vecfield as tvf

torch.set_num_threads(1)
FIELDS = [BN254_FR, BN254_FQ]


def _port(field):
    return next(f for f in PORT_FIELDS if f.name == field.name)


def _consts(field):
    return jvf.consts(field), tvf.consts(_port(field))


def _elements(field, shape, seed, edges=(0, 1, -1)):
    """The same Montgomery elements in both packages, ``edges`` (-1 is p -
    1) first, the rest nonzero: (jax array (..., 16), port tensor (..., 8))."""
    fcj, fct = _consts(field)
    n = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    xs = [int.from_bytes(w.astype("<u4").tobytes(), "little") % (field.p - 1) + 1 for w in words]
    xs[: len(edges)] = [e % field.p for e in edges][:n]
    port = tvf.from_ints_np(fct, xs).reshape(tuple(shape) + (8,))
    return jvf.from_ints(fcj, xs).reshape(tuple(shape) + (16,)), torch.from_numpy(port)


def _same(port_t, jax_a):
    assert np.array_equal(tvf.limbs_to_ref(port_t), np.asarray(jax_a))


def _exponent(field, name):
    if name == "rand253":
        rng = np.random.default_rng(253)
        return int.from_bytes(rng.bytes(32), "little") % (1 << 253) | 1 << 252
    return {"0": 0, "1": 1, "2": 2, "p-2": field.p - 2}[name]


@pytest.mark.parametrize("e_name", ["0", "1", "2", "p-2", "rand253"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_pow_matches_jax(field, e_name):
    fcj, fct = _consts(field)
    e = _exponent(field, e_name)
    aj, at = _elements(field, (2, 9), 7)
    want = jvf.pow_const(fcj, aj, e)
    _same(cuda_mont.mont_pow_plain(fct, at, e), want)
    _same(tvf.pow_const(fct, at, e), want)
    got = tvf.to_ints(fct, tvf.pow_const(fct, at, e))
    assert got == [pow(x, e, field.p) for x in tvf.to_ints(fct, at)]  # 0^0 = 1, 0^e = 0


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_inv_matches_jax_and_maps_zero_to_zero(field):
    fcj, fct = _consts(field)
    aj, at = _elements(field, (13,), 8)
    got = tvf.inv(fct, at)
    _same(got, jvf.inv(fcj, aj))
    assert tvf.to_ints(fct, got)[0] == 0
    prods = tvf.to_ints(fct, tvf.mont_mul(fct, got, at))
    assert prods[1:] == [1] * 12


def test_pow_wrapper_rejects_exponents_outside_256_bits():
    fct = tvf.consts(_port(BN254_FR))
    a = torch.zeros((2, 8), dtype=torch.int32)
    for e in (-1, 1 << 256):
        with pytest.raises(ValueError):
            cuda_mont.mont_pow(fct, a, e)


def test_pow_on_cpu_counts_no_launch():
    fct = tvf.consts(_port(BN254_FR))
    _, at = _elements(BN254_FR, (5,), 9)
    before = dict(cuda_mont.LAUNCHES)
    assert torch.equal(cuda_mont.mont_pow(fct, at, 12345), cuda_mont.mont_pow_plain(fct, at, 12345))
    assert cuda_mont.LAUNCHES == before


TILE = cuda_mont.PREFIX_TILE
LENGTHS = [1, 2, 3, 37, TILE - 1, TILE, TILE + 1, 2 * TILE + 3, (1 << 12) + 4]


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", LENGTHS)
def test_prefix_and_suffix_products_match_jax(n, rows):
    field = BN254_FR if n % 2 else BN254_FQ
    fcj, fct = _consts(field)
    aj, at = _elements(field, (rows, n), n, edges=(1, -1))
    want = jvf.prefix_mul(fcj, aj)
    _same(cuda_mont.mont_prefix_plain(fct, at), want)
    _same(tvf.prefix_mul(fct, at), want)
    want = jvf.prefix_mul(fcj, aj[:, ::-1])[:, ::-1]
    _same(cuda_mont.mont_prefix_plain(fct, at, reverse=True), want)
    _same(tvf.prefix_mul(fct, at, reverse=True), want)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", LENGTHS)
def test_batch_inv_and_pow_series_match_jax(n, rows):
    field = BN254_FQ if n % 2 else BN254_FR
    fcj, fct = _consts(field)
    aj, at = _elements(field, (rows, n), n + 1, edges=(1, -1))
    _same(tvf.batch_inv_nz(fct, at), jvf.batch_inv_nz(fcj, aj))
    x = (n * 0x9E3779B97F4A7C15 + rows) % field.p
    _same(tvf.pow_series(fct, x, n, device="cpu"), jvf.pow_series(fcj, x, n))


def test_prefix_on_cpu_counts_no_launch_and_keeps_empty_rows():
    fct = tvf.consts(_port(BN254_FR))
    _, at = _elements(BN254_FR, (2, 5), 10)
    before = dict(cuda_mont.LAUNCHES)
    assert torch.equal(cuda_mont.mont_prefix(fct, at, reverse=True),
                       cuda_mont.mont_prefix_plain(fct, at, reverse=True))
    assert tvf.prefix_mul(fct, at[:, :0]).shape == (2, 0, 8)
    assert cuda_mont.LAUNCHES == before
    assert [cuda_mont.prefix_launches(n) for n in (1, TILE, TILE + 1, 1 << 18)] == [1, 1, 3, 3]


# (a's shape, b's shape, what vecfield.broadcast_pattern says) without the
# limb axis: K1 reads the broadcast operand in place as "cycle" (its rows over
# the leading axes) or "repeat" (each row over the trailing axes), swapping
# the operands when a is the broadcast one; None materialises both
PATTERNS = [
    ((4,), (4,), (False, None)),
    ((5, 16), (16,), (False, "cycle")),
    ((16,), (5, 16), (True, "cycle")),
    ((5, 16), (1, 16), (False, "cycle")),
    ((5, 16), (), (False, "cycle")),
    ((1, 16), (16,), (False, "cycle")),
    ((2, 3, 16), (3, 16), (False, "cycle")),
    ((5, 16), (5, 1), (False, "repeat")),
    ((2, 1), (2, 16), (True, "repeat")),
    ((2, 3, 16), (2, 3, 1), (False, "repeat")),
    ((2, 3, 16), (2, 1, 1), (False, "repeat")),
    ((5, 1), (1, 16), None),
    ((2, 3, 16), (2, 1, 16), None),
]


@pytest.mark.parametrize("sa, sb, want", PATTERNS, ids=lambda v: str(v).replace(" ", ""))
def test_broadcast_pattern_classifies_shape_pairs(sa, sb, want):
    assert tvf.broadcast_pattern(sa + (8,), sb + (8,)) == want


@pytest.mark.parametrize("sa, sb, want", PATTERNS[1:], ids=lambda v: str(v).replace(" ", ""))
def test_mont_mul_with_a_broadcast_operand_matches_jax(sa, sb, want):
    field = BN254_FR if len(sa) % 2 else BN254_FQ
    fcj, fct = _consts(field)
    aj, at = _elements(field, sa, 11)
    bj, bt = _elements(field, sb, 12, edges=(-1,))
    before = dict(cuda_mont.LAUNCHES)
    _same(tvf.mont_mul(fct, at, bt), jvf.mont_mul(fcj, aj, bj))
    _same(tvf.mont_mul(fct, bt, at), jvf.mont_mul(fcj, bj, aj))
    assert cuda_mont.LAUNCHES == before


def test_broadcast_rows_stand_for_their_elements():
    fct = tvf.consts(_port(BN254_FR))
    _, a = _elements(BN254_FR, (6, 4), 13)
    _, rows = _elements(BN254_FR, (2,), 14)
    cycle = cuda_mont.mont_mul_plain(fct, a, rows, "cycle")
    repeat = cuda_mont.mont_mul_plain(fct, a, rows, "repeat")
    for i in range(24):
        for got, j in ((cycle, i % 2), (repeat, i // 12)):
            want = cuda_mont.mont_mul_plain(fct, a.reshape(24, 8)[i], rows[j])
            assert torch.equal(got.reshape(24, 8)[i], want)
    with pytest.raises(ValueError):
        cuda_mont.expand_rows(rows[:1].expand(5, 8), 24, "cycle")  # 5 rows do not divide 24
    with pytest.raises(ValueError):
        cuda_mont.mont_mul_plain(fct, a, rows, "spread")

"""Field layer of the PyTorch port against the JAX package.

Inputs are made from a seeded numpy generator and go through both
packages; every comparison is bitwise (the port's (..., 8) int32 limbs are
converted to the reference's (..., 16) uint32 layout and compared with
``np.array_equal``), over all four fields. K1's plain version is also held
against the Pallas kernel run in interpret mode, as the JAX tests run it on
the CPU.
"""

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.fields import ALL_FIELDS
from halo2_rsa_tpu.fields import pallas_mont
from halo2_rsa_tpu.fields import vecfield as jvf
from halo2_rsa_tpu_torch.fields import ALL_FIELDS as PORT_FIELDS
from halo2_rsa_tpu_torch.fields import cuda_mont
from halo2_rsa_tpu_torch.fields import vecfield as tvf

torch.set_num_threads(1)
N = 61


def _ints(field, n, seed):
    """Seeded field elements with the edge values 0, 1, p-1 up front."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [int.from_bytes(w.astype("<u4").tobytes(), "little") % field.p for w in words]
    return [0, 1, field.p - 1] + vals


def _pair(field, seed, mont=True):
    """The same values in both packages: (jax array, port tensor, ints)."""
    xs = _ints(field, N, seed)
    return (
        jvf.from_ints(jvf.consts(field), xs, mont=mont),
        tvf.from_ints(tvf.consts(_port(field)), xs, mont=mont, device="cpu"),
        xs,
    )


def _port(field):
    return next(f for f in PORT_FIELDS if f.name == field.name)


def _same(port_t, jax_a):
    assert np.array_equal(tvf.limbs_to_ref(port_t), np.asarray(jax_a))


@pytest.fixture(params=ALL_FIELDS, ids=lambda f: f.name)
def field(request):
    return request.param


def test_k1_plain_matches_jax_and_pallas_interpret(field):
    fcj, fct = jvf.consts(field), tvf.consts(_port(field))
    aj, at, xs = _pair(field, 1, mont=False)
    bj, bt, ys = _pair(field, 2, mont=False)
    # edge products 0*x, 1*x, (p-1)(p-1) sit in the first rows
    bj, bt = bj.at[2].set(aj[2]), bt.clone()
    bt[2] = at[2]
    got = cuda_mont.mont_mul_plain(fct, at, bt)
    _same(got, jvf.mont_mul(fcj, aj, bj))
    _same(got, pallas_mont.mont_mul_any(fcj, aj, bj, interpret=True))
    rinv = pow(1 << 256, -1, field.p)
    ys = ys[:2] + [xs[2]] + ys[3:]
    assert tvf.to_ints(fct, got, mont=False) == [x * y * rinv % field.p for x, y in zip(xs, ys)]


def test_mont_mul_dispatches_to_plain_on_cpu(field):
    fct = tvf.consts(_port(field))
    _, at, _ = _pair(field, 3)
    _, bt, _ = _pair(field, 4)
    before = dict(cuda_mont.LAUNCHES)
    assert torch.equal(tvf.mont_mul(fct, at, bt), cuda_mont.mont_mul_plain(fct, at, bt))
    assert cuda_mont.LAUNCHES == before  # a CPU tensor never counts a launch


@pytest.mark.parametrize("op", ["add", "sub", "neg", "to_mont", "from_mont", "is_zero", "eq"])
def test_elementwise_ops_match_jax(field, op):
    fcj, fct = jvf.consts(field), tvf.consts(_port(field))
    aj, at, _ = _pair(field, 5)
    bj, bt, _ = _pair(field, 6)
    bj, bt = bj.at[4].set(aj[4]), bt.clone()
    bt[4] = at[4]  # one equal pair
    if op in ("add", "sub"):
        _same(getattr(tvf, op)(fct, at, bt), getattr(jvf, op)(fcj, aj, bj))
    elif op in ("neg", "to_mont", "from_mont"):
        _same(getattr(tvf, op)(fct, at), getattr(jvf, op)(fcj, aj))
    elif op == "is_zero":
        assert np.array_equal(tvf.is_zero(at).numpy(), np.asarray(jvf.is_zero(aj)))
    else:
        assert np.array_equal(tvf.eq(at, bt).numpy(), np.asarray(jvf.eq(aj, bj)))


def test_inverses_and_powers_match_jax(field):
    fcj, fct = jvf.consts(field), tvf.consts(_port(field))
    aj, at, _ = _pair(field, 7)
    _same(tvf.inv(fct, at[:9]), jvf.inv(fcj, aj[:9]))
    _same(tvf.pow_const(fct, at, 0x1234567), jvf.pow_const(fcj, aj, 0x1234567))
    _same(tvf.batch_inv_nz(fct, at[3:]), jvf.batch_inv_nz(fcj, aj[3:]))


@pytest.mark.parametrize("op", ["prefix_mul", "prefix_add", "suffix_add", "reduce_add"])
def test_scans_match_jax(op):
    field = ALL_FIELDS[0]
    fcj, fct = jvf.consts(field), tvf.consts(_port(field))
    aj, at, _ = _pair(field, 8)
    aj2, at2 = aj[:60].reshape(4, 15, 16), at[:60].reshape(4, 15, 8)
    if op == "reduce_add":
        _same(tvf.reduce_add(fct, at), jvf.reduce_add(fcj, aj))
        _same(tvf.reduce_add(fct, at2), jvf.reduce_add(fcj, aj2))
    else:
        _same(getattr(tvf, op)(fct, at2), getattr(jvf, op)(fcj, aj2))


def test_pow_series_matches_jax():
    field = ALL_FIELDS[0]
    fcj, fct = jvf.consts(field), tvf.consts(_port(field))
    for x, n in ((7, 1), (123456789, 37), (field.p - 2, 64)):
        _same(tvf.pow_series(fct, x, n, device="cpu"), jvf.pow_series(fcj, x, n))


def test_layout_converters_round_trip(field):
    fcj, fct = jvf.consts(field), tvf.consts(_port(field))
    xs = _ints(field, N, 9)
    ref = jvf.from_ints_np(fcj, xs, mont=True)
    port = tvf.from_ints_np(fct, xs, mont=True)
    assert np.array_equal(tvf.limbs_from_ref(ref), port)
    assert np.array_equal(tvf.limbs_to_ref(port), ref)
    assert np.array_equal(tvf.limbs_to_ref(torch.from_numpy(port)), ref)
    assert tvf.to_ints(fct, port) == [x % field.p for x in xs]
    assert tvf.to_ints(fct, tvf.from_ints(fct, xs, mont=False, device="cpu"), mont=False) == xs


def test_field_consts_n0inv_is_32_bit(field):
    fct = tvf.consts(_port(field))
    assert (field.p * fct.n0inv32) % (1 << 32) == (1 << 32) - 1
    assert (field.p * field.n0inv) % (1 << 16) == (1 << 16) - 1  # the 16-bit reference constant


@pytest.mark.parametrize("bits", [16, 32])
def test_carry_normalize_resolves_long_carry_chains(bits):
    """All-ones runs force the carry lookahead through many limbs."""
    m = (1 << bits) - 1
    rows = [
        [m] * 8,  # no carry in: stays
        [m + 1] + [m] * 7,  # carry ripples out of the top
        [m + 1] + [m] * 3 + [0] * 4,
        [0, m + 1, m, m, 5, m, m + 1, m],
        [m] * 4 + [m + 1] + [m] * 3,
    ]
    x = torch.tensor(rows, dtype=torch.int64)
    got, carry = cuda_mont.carry_normalize(x, bits)
    for row, g, c in zip(rows, got.tolist(), carry.tolist()):
        v = sum(int(d) << (bits * j) for j, d in enumerate(row))
        assert sum(int(d) << (bits * j) for j, d in enumerate(g)) + (c << (bits * 8)) == v
        assert all(0 <= d <= m for d in g)


@pytest.mark.parametrize("bits", [16, 32])
def test_carry_normalize_random_boundary_limbs(bits):
    """Limbs drawn from {0, 1, m-1, m, m+1} (m = 2^bits - 1): every mix of
    generate, propagate and kill, against Python ints."""
    m = (1 << bits) - 1
    rng = np.random.default_rng(bits)
    choices = np.array([0, 1, m - 1, m, m + 1], dtype=np.int64)
    for width in (8, 16, 32):
        x = torch.from_numpy(choices[rng.integers(0, 5, size=(400, width))])
        got, carry = cuda_mont.carry_normalize(x, bits)
        for row, g, c in zip(x.tolist(), got.tolist(), carry.tolist()):
            v = sum(d << (bits * j) for j, d in enumerate(row))
            assert sum(d << (bits * j) for j, d in enumerate(g)) + (c << (bits * width)) == v

"""NTT and MSM of the PyTorch port against the JAX package.

Inputs come from a seeded numpy generator and go through both packages.
NTT outputs are compared bitwise at 2^2..2^10 and against the host DFT;
MSM results are compared bitwise in projective coordinates (the bucket
pipeline runs the reference's steps in the reference's order) and as
affine points against the host double-and-add sum, in both ``z_one``
modes and across a point-axis segment boundary (``_SEG`` set small in both
packages, as ``__graft_entry__.py`` does for its segmented MSM check).
"""

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.fields import vecfield as jvf
from halo2_rsa_tpu.prover import g1_vec as jg1
from halo2_rsa_tpu.prover import msm as jmsm
from halo2_rsa_tpu.prover import ntt as jntt
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.prover import curve
from halo2_rsa_tpu_torch.prover import g1_vec as tg1
from halo2_rsa_tpu_torch.prover import msm as tmsm
from halo2_rsa_tpu_torch.prover import ntt as tntt
from halo2_rsa_tpu_torch.utils import profiling

torch.set_num_threads(1)
R = curve.R


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") % R for w in words]


def _same(port, jax_arr):
    assert np.array_equal(tvf.limbs_to_ref(port), np.asarray(jax_arr))


@pytest.mark.parametrize("log_n", range(2, 11))
def test_ntt_matches_jax(log_n):
    vals = _scalars(1 << log_n, log_n)
    aj = jvf.from_ints(jntt.FR, vals)
    at = tvf.from_ints(tntt.FR, vals, device="cpu")
    fwd = tntt.ntt(at, log_n)
    _same(fwd, jntt.ntt(aj, log_n))
    back = tntt.intt(fwd, log_n)
    _same(back, jntt.intt(jntt.ntt(aj, log_n), log_n))
    assert torch.equal(back, at)
    if log_n <= 4:
        assert tvf.to_ints(tntt.FR, fwd) == tntt.ntt_host(vals)


def test_ntt_batch_and_stage_twiddles_match_jax():
    log_n = 6
    vals = _scalars(3 << log_n, 99)
    aj = jvf.from_ints(jntt.FR, vals).reshape(3, 1 << log_n, 16)
    at = tvf.from_ints(tntt.FR, vals, device="cpu").reshape(3, 1 << log_n, 8)
    _same(tntt.ntt_batch(at, log_n), jntt.ntt_batch(aj, log_n))
    _same(tntt.intt_batch(at, log_n), jntt.intt_batch(aj, log_n))
    for inverse in (False, True):
        _same(tntt._twiddles_full(log_n, inverse, "cpu"), jntt._twiddles_full(log_n, inverse))
        # the on-the-fly stage twiddles (used above _TW_FULL_MAX_LOG_N)
        tw = tntt._ntt_graph(at, log_n, inverse, None)
        assert torch.equal(tw, tntt._ntt_graph(at, log_n, inverse, tntt._twiddles_full(log_n, inverse, "cpu")))


def _brev64(x: int) -> int:
    return int(f"{x:064b}"[::-1], 2)


def _kernel_model(a, log_n, inverse):
    """csrc/ntt.cu's index arithmetic in plain torch: (stage outputs, the
    stage twiddles it forms, the last stage's output positions)."""
    fr = tntt.FR
    h, lo, hi = tntt._twiddle_tables(log_n, inverse)
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    half = 1 << (log_n - 1)
    i = torch.arange(half)
    src, twiddles = a, []
    for t in range(log_n):
        x, y = src[:, i], src[:, i + half]
        s, d = tvf.add(fr, x, y), tvf.sub(fr, x, y)
        dst = torch.empty_like(src)
        if t + 1 < log_n:
            e = (i >> t) << t
            w = hi[e >> h]
            if t < h:
                w = tvf.mont_mul(fr, w, lo[e & ((1 << h) - 1)])
            twiddles.append(w)
            d = tvf.mont_mul(fr, d, w[None])
            dst[:, 2 * i], dst[:, 2 * i + 1] = s, d
        else:
            if inverse:
                n_inv = torch.from_numpy(tntt._n_inv_mont(log_n))
                s, d = tvf.mont_mul(fr, s, n_inv), tvf.mont_mul(fr, d, n_inv)
            r = torch.tensor([_brev64(v) >> (65 - log_n) if log_n > 1 else 0 for v in range(half)])
            dst[:, r], dst[:, r + half] = s, d
        src = dst
    return src, twiddles, r


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", range(1, 13))
def test_ntt_kernel_model_matches_loop(log_n, inverse):
    """The CUDA kernel's index arithmetic, emulated on the CPU: its in-kernel
    twiddles hi[e >> h] * lo[e & mask] (hi alone from stage h on) equal
    ``_stage_twiddles``; its last stage (twiddle 1) stores at ``_bitrev``'s
    positions and scales an inverse by N^-1; the whole equals the torch loop."""
    vals = _scalars(3 << log_n, 1000 + log_n)
    a = tvf.from_ints(tntt.FR, vals, device="cpu").reshape(3, 1 << log_n, 8)
    got, twiddles, r = _kernel_model(a, log_n, inverse)
    for t, w in enumerate(twiddles):
        assert torch.equal(w, tntt._stage_twiddles(log_n, inverse, t, "cpu")), t
    one = tvf.from_ints(tntt.FR, [1], device="cpu")
    assert torch.equal(tntt._stage_twiddles(log_n, inverse, log_n - 1, "cpu"),
                       one.expand(1 << (log_n - 1), 8))
    rev = torch.from_numpy(tntt._bitrev(log_n))
    assert torch.equal(rev[r], 2 * torch.arange(1 << (log_n - 1)))
    assert torch.equal(rev[r + (1 << (log_n - 1))], 2 * torch.arange(1 << (log_n - 1)) + 1)
    assert torch.equal(got, tntt._ntt_loop(a, log_n, inverse))
    assert torch.equal(got, tntt._ntt_graph(a, log_n, inverse,
                                            tntt._twiddles_full(log_n, inverse, "cpu")))


@pytest.mark.parametrize("wb", [4, 8])
def test_digits_match_jax(wb):
    vals = _scalars(37, wb)
    dj = jmsm.digits_from_scalar_limbs(jvf.from_ints(jntt.FR, vals, mont=False), wb)
    dt = tmsm.digits_from_scalar_limbs(tvf.from_ints(tntt.FR, vals, mont=False, device="cpu"), wb)
    assert np.array_equal(dt.numpy(), np.asarray(dj))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [curve.g1_mul(curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, size=n)]


def _msm_case(p, n, seed, z_one):
    pts = _points(n, seed)
    scs = [_scalars(n, seed + 1 + i) for i in range(p)]
    scs[0][:3] = [0, 1, R - 1]
    flat = [s for row in scs for s in row]
    sj = jvf.from_ints(jntt.FR, flat, mont=False).reshape(p, n, 16)
    st = tvf.from_ints(tntt.FR, flat, mont=False, device="cpu").reshape(p, n, 8)
    pj, pt = jg1.points_to_device(pts), tg1.points_to_device(pts, device="cpu")
    got = tmsm.msm_many(st, pt, z_one=z_one)
    for c_t, c_j in zip(got, jmsm.msm_many(sj, pj, z_one=z_one)):
        _same(c_t, c_j)
    assert tg1.points_from_device(got) == [tmsm.msm_host(row, pts) for row in scs]


def test_msm_many_affine_bases_matches_jax_and_host():
    _msm_case(p=3, n=40, seed=5, z_one=True)


def test_msm_many_segmented_matches_jax_and_host(monkeypatch):
    monkeypatch.setattr(jmsm, "_SEG", 32)
    monkeypatch.setattr(tmsm, "_SEG", 32)
    _msm_case(p=2, n=70, seed=7, z_one=False)


@pytest.mark.parametrize("z_one", [True, False])
def test_msm_span_counts_indexed_or_gathered_rows(z_one):
    """The span ``msm`` counts the points K2 read through the sort's
    permutation (affine bases) or the rows gathered in sorted order (any
    other bases): P x W x N, here 2 polys x 64 windows of 4 bits x 64
    points (40 padded)."""
    pts = _points(40, 3)
    st = tvf.from_ints(tntt.FR, _scalars(80, 4), mont=False, device="cpu").reshape(2, 40, 8)
    with profiling.tracing() as trace:
        tmsm.msm_many(st, tg1.points_to_device(pts, device="cpu"), z_one=z_one)
    counts = trace.totals()["msm"]
    key, other = ("indexed_rows", "gathered_rows") if z_one else ("gathered_rows", "indexed_rows")
    assert counts[key] == 2 * 64 * 64 and other not in counts


def test_msm_many_host_matches_host_sums():
    pts = _points(37, 13)
    scs = [_scalars(37, 14 + i) for i in range(2)]
    st = tvf.from_ints(tntt.FR, [s for row in scs for s in row], mont=False,
                       device="cpu").reshape(2, 37, 8)
    got = tmsm.msm_many_host(st, tg1.points_to_device(pts, device="cpu"))
    assert got == [tmsm.msm_host(row, pts) for row in scs]


def test_run_msm_matches_jax_and_host():
    pts = _points(45, 11)
    pts[7] = None
    scs = _scalars(45, 12)
    want = tmsm.msm_host(scs, pts)
    assert tmsm.run_msm(scs, pts, device="cpu") == want == jmsm.run_msm(scs, pts)


def test_chunk_helpers_match_jax():
    for n in (32, 100, 4096, 1 << 15, 1 << 18):
        assert tmsm._pick_chunk(n) == jmsm._pick_chunk(n)
        assert tmsm._pick_pchunk(n) == jmsm._pick_pchunk(n)
        assert tmsm._window_bits_for(n) == jmsm._window_bits_for(n)
    for p in range(1, 20):
        assert tmsm._chunk_plan(p, 4) == jmsm._chunk_plan(p, 4)

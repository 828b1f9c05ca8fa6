"""K3's row scans (the MSM's Hillis–Steele scans and halving trees) and its
bucket splice, of the PyTorch port against the JAX package.

``cuda_g1.point_scan_plain`` and ``point_scan_sum_plain`` are held bitwise
against the JAX package's ``msm._hs_point_scan`` and ``msm._bucket_reduce``
on the CPU, over rows that hold the identity, runs of one point (P+P in the
first round) and P, -P neighbours, all with random Z (numpy seed). The row
length bound of the kernel is checked against every MSM size the prover
runs. ``msm._bucket_sums``, which ends in ``cuda_g1.bucket_splice``, is
held bitwise against the JAX package's, with empty buckets first and with
windows padded to whole chunks; its K2 call (the points read through the
sort's permutation) reads as the benchmark's recorder expects.
"""

import os
import sys

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.prover import g1_vec as jg1
from halo2_rsa_tpu.prover import msm as jmsm
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.prover import cuda_g1, curve
from halo2_rsa_tpu_torch.prover import g1_vec as tg1
from halo2_rsa_tpu_torch.prover import msm as tmsm

torch.set_num_threads(1)
ROWS = 3
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")


def _rows(length: int, seed: int):
    """(ROWS, length) projective points in both layouts: row 0 draws from a
    pool of 12 points and the identity, row 1 repeats one point (P+P in
    round 0), row 2 alternates P and -P (P+(-P) in round 0)."""
    rng = np.random.default_rng(seed)
    pool = [curve.g1_mul(curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, size=12)]
    pool.append(None)
    p = pool[0]
    pts = [pool[int(i)] for i in rng.integers(0, len(pool), size=length)]
    pts += [p] * length
    pts += [p if j % 2 == 0 else curve.g1_neg(p) for j in range(length)]
    zs = [int(z) % curve.Q or 1 for z in rng.integers(1, 1 << 62, size=len(pts))]
    coords = [[0 if a is None else a[0] * z % curve.Q for a, z in zip(pts, zs)],
              [z if a is None else a[1] * z % curve.Q for a, z in zip(pts, zs)],
              [0 if a is None else z for a, z in zip(pts, zs)]]
    t = tuple(tvf.from_ints(tg1.FQ, c, device="cpu").reshape(ROWS, length, 8) for c in coords)
    j = tuple(np.asarray(jg1.vecfield.from_ints(jg1.FQ, c)).reshape(ROWS, length, 16)
              for c in coords)
    return pts, t, j


def _same(port, jax_pt):
    for pc, jc in zip(port, jax_pt):
        assert np.array_equal(tvf.limbs_to_ref(pc), np.asarray(jc))


@pytest.mark.parametrize("length", [1, 2, 5, 8, 255])
def test_point_scan_plain_matches_jax_hs_scan_and_bucket_reduce(length):
    pts, t, j = _rows(length, length)
    scan = cuda_g1.point_scan_plain(tg1.FQ, t)
    assert all(c.shape == (ROWS, length, 8) for c in scan)
    _same(scan, jmsm._hs_point_scan(j, length))
    for g, w in zip(tg1.point_scan(t), scan):  # CPU tensors take the plain version
        assert torch.equal(g, w)
    host = [[None] * length for _ in range(ROWS)]
    for r in range(ROWS):
        acc = None
        for i in range(length):
            acc = curve.g1_add(acc, pts[r * length + i])
            host[r][i] = acc
    assert tg1.points_from_device(tuple(c.reshape(-1, 8) for c in scan)) == sum(host, [])

    # _bucket_reduce scans the buckets b >= 1 from the last: give it the rows
    # reversed behind a bucket 0 it skips
    buckets = tuple(np.concatenate([c[:, :1], c[:, ::-1]], axis=1) for c in j)
    total = cuda_g1.point_scan_sum_plain(tg1.FQ, t)
    assert all(c.shape == (ROWS, 8) for c in total)
    _same(total, jmsm._bucket_reduce(buckets))
    for g, w in zip(tg1.point_scan_sum(t), total):
        assert torch.equal(g, w)
    tbuckets = tuple(torch.cat([c[:, :1], c.flip(1)], dim=1) for c in t)
    for g, w in zip(tmsm._bucket_reduce(tbuckets), total):
        assert torch.equal(g, w)
    want = []
    for r in range(ROWS):
        acc = None
        for s in host[r]:
            acc = curve.g1_add(acc, s)
        want.append(acc)
    assert tg1.points_from_device(total) == want


def test_point_scan_rejects_bad_shapes_and_long_rows():
    t = tg1.identity((2, 4), device="cpu")
    for bad in (
        tuple(c[0, 0] for c in t),  # (8,): no row axis
        t[:2],  # no Z
        (t[0], t[1][:, :3], t[2]),  # coordinates of other shapes
        tuple(c[..., :4] for c in t),  # not 8 limbs
        tuple(c[:, :0] for c in t),  # rows of no point
        tg1.identity((1, cuda_g1.MAX_ROW + 1), device="cpu"),
    ):
        for fn in (cuda_g1.point_scan_plain, cuda_g1.point_scan_sum_plain,
                   cuda_g1.point_scan, cuda_g1.point_scan_sum):
            with pytest.raises(ValueError):
                fn(tg1.FQ, bad)


def test_msm_rows_fit_the_scan_kernel():
    """Every row the MSM hands the scan kernel has at most MAX_ROW points:
    the chunk totals (npow / C for npow from 32 to _SEG = 2^15; a larger
    MSM runs in segments of _SEG points) and the buckets b >= 1."""
    assert tmsm._SEG == 1 << 15
    for log_n in range(5, 16):
        npow = 1 << log_n
        c_len = tmsm._pick_chunk(npow)
        assert npow % c_len == 0 and npow // c_len <= cuda_g1.MAX_ROW, npow
        assert (1 << tmsm._window_bits_for(npow)) - 1 <= cuda_g1.MAX_ROW
    assert tmsm._SEG // tmsm._pick_chunk(tmsm._SEG) == cuda_g1.MAX_ROW


@pytest.mark.parametrize("z_one", [True, False])
def test_bucket_sums_match_jax_with_empty_buckets(z_one):
    """3 windows x 40 points (chunks of 8), 16 buckets: window 0 leaves
    buckets 0-2 empty (their ends are -1), window 1 puts every point in
    bucket 5, window 2 draws digits at random."""
    _bucket_case(40, z_one)


@pytest.mark.parametrize("z_one", [True, False])
def test_bucket_sums_padded_to_whole_chunks_match_jax(z_one):
    """44 points in chunks of 8: the scan pads each window to 48, with the
    generator (an index to a row past the source, for K2) or the identity,
    at a digit after every bucket; the windows as in
    :func:`test_bucket_sums_match_jax_with_empty_buckets`."""
    assert tmsm._pick_chunk(44) == 8
    _bucket_case(44, z_one)


def _bucket_case(n: int, z_one: bool):
    rng = np.random.default_rng(31)
    buckets = 16
    digits = np.stack([rng.integers(3, buckets, size=n), np.full(n, 5),
                       rng.integers(0, buckets, size=n)])
    aff = [curve.g1_mul(curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, size=n)]
    if z_one:
        coords = [[p[0] for p in aff], [p[1] for p in aff], [1] * n]
    else:
        aff[3] = None
        zs = [int(z) % curve.Q or 1 for z in rng.integers(1, 1 << 62, size=n)]
        coords = [[0 if p is None else p[0] * z % curve.Q for p, z in zip(aff, zs)],
                  [z if p is None else p[1] * z % curve.Q for p, z in zip(aff, zs)],
                  [0 if p is None else z for p, z in zip(aff, zs)]]
    tp = tuple(tvf.from_ints(tg1.FQ, c, device="cpu") for c in coords)
    jp = tuple(jg1.vecfield.from_ints(jg1.FQ, c) for c in coords)
    got = tmsm._bucket_sums(torch.from_numpy(digits), tp, buckets, z_one)
    assert all(c.shape == (3, buckets, 8) for c in got)
    _same(got, jmsm._bucket_sums(digits.astype(np.int32), jp, buckets, z_one))
    want = [[None] * buckets for _ in range(3)]
    for w in range(3):
        for d, p in zip(digits[w], aff):
            want[w][d] = curve.g1_add(want[w][d], p)
    assert tg1.points_from_device(tuple(c.reshape(-1, 8) for c in got)) == sum(want, [])


@pytest.mark.parametrize("n", [64, 44])
def test_bucket_scan_call_reads_as_the_benchmark_records_it(monkeypatch, n):
    """The (fc, p1, pts) that ``msm._bucket_sums`` hands
    ``cuda_g1.point_scan_mixed`` (the affine points read through the sort's
    permutation) are read by the benchmark's recorder (its ``_SHAPES``
    entry) and by ``parallel.ranks._scan_shapes`` as (windows x chunks, C),
    the dense rows' shape: three positional arguments, no keyword."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness import recorder

    from halo2_rsa_tpu_torch.parallel import ranks

    kernel, shape = recorder._SHAPES[("cuda_g1", "point_scan_mixed")]
    seen = []
    real = cuda_g1.point_scan_mixed

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(cuda_g1, "point_scan_mixed", spy)
    rng = np.random.default_rng(n)
    digits = torch.from_numpy(rng.integers(0, 16, size=(3, n)))
    aff = [curve.g1_mul(curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, size=n)]
    tp = tuple(tvf.from_ints(tg1.FQ, c, device="cpu")
               for c in ([p[0] for p in aff], [p[1] for p in aff], [1] * n))

    def run():
        return tmsm._bucket_sums(digits, tp, 16, z_one=True)

    got = run()
    c = tmsm._pick_chunk(n)
    rows = 3 * -(-n // c)
    (args, kw), = seen
    assert kernel == "K2" and not kw and len(args) == 3
    assert isinstance(args[2], cuda_g1.IndexedRows)
    assert shape(*args) == (rows, c)
    assert ranks._scan_shapes(run)["K2"] == [[rows, c, 1]]
    want = [[None] * 16 for _ in range(3)]
    for w in range(3):
        for d, p in zip(digits[w].tolist(), aff):
            want[w][d] = curve.g1_add(want[w][d], p)
    assert tg1.points_from_device(tuple(c_.reshape(-1, 8) for c_ in got)) == sum(want, [])


def test_bucket_splice_rejects_bad_shapes():
    within = tg1.identity((2, 16), device="cpu")
    incl = tg1.identity((2, 4), device="cpu")
    ends = torch.full((2, 5), -1, dtype=torch.int64)
    for bad in (
        (within[:2], incl, ends),  # no Z
        (within, tuple(c[:, :3] for c in incl), ends),  # 16 points, 3 chunks
        (within, tuple(c[:1] for c in incl), ends),  # rows differ
        (within, incl, ends[:1]),
        (within, incl, ends.to(torch.int32)),
        (tuple(c[..., :4] for c in within), incl, ends),  # not 8 limbs
    ):
        for fn in (cuda_g1.bucket_splice_plain, cuda_g1.bucket_splice):
            with pytest.raises(ValueError):
                fn(tg1.FQ, *bad)


def test_scan_cluster_fills_the_card_without_splitting_warps():
    """Blocks per row: as many (up to 8) as keep rows x blocks within the
    card's SMs, while each block holds a warp of the row."""
    sms = 132
    assert [cuda_g1.scan_cluster(rows, 512, False, sms) for rows in (128, 64, 32, 16, 1)] == \
        [1, 2, 4, 8, 8]
    assert [cuda_g1.scan_cluster(rows, 255, True, sms) for rows in (128, 64, 32)] == [1, 2, 4]
    assert cuda_g1.scan_cluster(3, 40, False, sms) == 1  # 40 points: one block of them
    assert cuda_g1.scan_cluster(3, 64, False, sms) == 2
    assert cuda_g1.scan_cluster(2, 15, True, sms) == 1

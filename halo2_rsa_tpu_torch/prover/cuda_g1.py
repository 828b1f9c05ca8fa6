"""K2-K4: BN254 G1 point kernels — the CUDA wrappers, their plain PyTorch
versions, and their launch counters.

Counterpart of ``halo2_rsa_tpu/prover/pallas_g1.py``. The kernels hold a
whole Renes–Costello–Batina formula (a = 0, b3 = 9) per thread:

* K2 :func:`point_scan_mixed` — algorithm 8, projective P1 + affine P2
  (``_point_add_mixed_kernel``), applied ``c`` times in one launch with
  every prefix stored (``csrc/g1_scan.cu``), as the MSM's bucket scan applies
  it in a ``fori_loop``; the affine rows are dense, or (:class:`IndexedRows`)
  read in place through the bucket sort's permutation; :func:`point_add_mixed`
  is one add (c = 1) through the same kernel. Complete when every P2 is a
  real affine point;
* K3 :func:`point_add` — algorithm 7, complete projective add
  (``_point_add_kernel``, ``csrc/g1.cu``), and the MSM's rounds of it in one
  launch per row scan (``csrc/g1_rows.cu``): :func:`point_scan`, the
  Hillis–Steele prefix scan of ``msm._hs_point_scan``, and
  :func:`point_scan_sum`, that scan padded with the identity and halved to
  one point as in ``msm._bucket_reduce``; and :func:`bucket_splice`, the
  three adds per bucket of ``msm._bucket_sums``'s boundary splice
  (``csrc/g1_splice.cu``);
* K4 :func:`point_double` — algorithm 9 (``_point_double_kernel``), applied
  ``reps`` times in one launch (``csrc/g1_double.cu``), as the JAX package's
  Horner combine applies it in a ``fori_loop``.

Every wrapper takes coordinate tensors of ``(..., 8)`` int32 Montgomery Fq
limbs. CUDA tensors launch the kernel; CPU tensors run the ``*_plain``
version, the same formula in plain torch ops (``mont_mul_plain`` and the
vecfield adds). Both give the reference's projective coordinates bit for
bit, because each step returns the canonical residue.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..fields.cuda_mont import LIMBS, check_kernel_args, check_launch, mont_mul_u64, to_int32, u64
from ..fields.field import BN254_FQ
from ..fields.vecfield import add_u64 as add, sub_u64 as sub

LAUNCHES = {"g1_add_mixed": 0, "g1_add": 0, "g1_scan": 0, "g1_splice": 0, "g1_double": 0}
# the longest row of a point scan: one row per block of at most 512 threads
# (or per cluster of blocks); the MSM's rows are its chunk totals (at most
# 2^15 / 64 under msm._SEG) and its buckets (255)
MAX_ROW = 512
MAX_CLUSTER = 8  # blocks per row of a point scan: the portable cluster size


# ---------------------------------------------------------------------------
# plain versions: the formulas of pallas_g1.py on int64 lanes (canonical
# 32-bit limbs), the independent products of one layer stacked into one call
# ---------------------------------------------------------------------------


def _mul_many(fc, lhs, rhs):
    """Independent Montgomery products as one stacked plain call."""
    out = mont_mul_u64(fc, torch.stack(lhs), torch.stack(rhs))
    return tuple(out.unbind(0))


def _plain(formula, fc, *coords):
    out = formula(fc, *[tuple(u64(c) for c in pt) for pt in coords])
    return tuple(to_int32(c) for c in out)


def _mul9(fc, a):
    d = add(fc, a, a)  # 2a
    d = add(fc, d, d)  # 4a
    d = add(fc, d, d)  # 8a
    return add(fc, d, a)


def point_add_plain(fc, p1, p2):
    """K3's plain version."""
    return _plain(_point_add_u64, fc, p1, p2)


def point_add_mixed_plain(fc, p1, p2xy):
    """K2's plain version, one add."""
    return _plain(_point_add_mixed_u64, fc, p1, p2xy)


class IndexedRows(NamedTuple):
    """Affine rows read through a permutation: element j of row r is source
    point ``order[r, j, 0]`` of (x, y), each (N, 8). ``order`` is (..., C, 1)
    int64 with every entry in [0, N), so that ``order.shape[-2]`` is C as
    ``x.shape[-2]`` is for dense rows (x, y) of (..., C, 8)."""

    order: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor


def _scan_len(p1, pts) -> int:
    """C of a scan of start points (..., 8) over affine rows: (x, y) of
    (..., C, 8), or an :class:`IndexedRows` (any 3-tuple is read as one);
    raises unless the shapes match and C >= 1."""
    shape = p1[0].shape
    if len(p1) != 3 or len(pts) not in (2, 3) or shape[-1:] != (LIMBS,) or \
            any(t.shape != shape for t in p1):
        raise ValueError("point_scan_mixed: (X, Y, Z) of (..., 8) and (x, y) of (..., C, 8) "
                         "or IndexedRows")
    if len(pts) == 3:
        order, x, y = pts
        if order.dtype != torch.int64 or order.dim() < 2 or order.shape[-1] != 1 or \
                x.dim() != 2 or x.shape[-1] != LIMBS or y.shape != x.shape or x.shape[0] < 1:
            raise ValueError("point_scan_mixed: IndexedRows of order (..., C, 1) int64 and "
                             "(x, y) of (N, 8)")
        rows = order.shape[:-1] + (LIMBS,)
    else:
        rows = pts[0].shape
        if len(rows) < 2 or pts[1].shape != rows:
            raise ValueError(f"point_scan_mixed: affine rows {tuple(rows)} and "
                             f"{tuple(pts[1].shape)}, expected (x, y) of one shape (..., C, 8)")
    if rows[:-2] + rows[-1:] != shape:
        raise ValueError(f"point_scan_mixed: start points {tuple(shape)} do not match affine "
                         f"rows {tuple(rows)}")
    if rows[-2] < 1:
        raise ValueError("point_scan_mixed: C must be >= 1, got 0")
    return rows[-2]


def point_scan_mixed_plain(fc, p1, pts):
    """K2's plain version of the scan: :func:`point_add_mixed_plain` applied
    along axis -2 of the affine rows, every prefix kept. Rows read through a
    permutation (:class:`IndexedRows`) are gathered first."""
    c = _scan_len(p1, pts)
    if len(pts) == 3:
        order, x, y = pts
        pts = (x[order[..., 0]], y[order[..., 0]])

    def scan(fc, acc, pts):
        prefixes = []
        for j in range(c):
            acc = _point_add_mixed_u64(fc, acc, tuple(t[..., j, :] for t in pts))
            prefixes.append(acc)
        return tuple(torch.stack(coord, dim=-2) for coord in zip(*prefixes))

    return _plain(scan, fc, p1, pts)


def _row_len(ps, key: str) -> int:
    """L of rows (..., L, 8) of points; raises unless the three coordinates
    share that shape and 1 <= L <= MAX_ROW."""
    shape = ps[0].shape
    if len(ps) != 3 or len(shape) < 2 or shape[-1] != LIMBS or any(t.shape != shape for t in ps):
        raise ValueError(f"{key}: (X, Y, Z) of one shape (..., L, 8)")
    if not 1 <= shape[-2] <= MAX_ROW:
        raise ValueError(f"{key}: rows of 1 to {MAX_ROW} points, got {shape[-2]}")
    return shape[-2]


def _hs_scan_u64(fc, acc):
    """Inclusive Hillis–Steele scan along axis -2: in round d = 1, 2, 4, ...
    element i >= d becomes acc[i] + acc[i - d]."""
    n = acc[0].shape[-2]
    d = 1
    while d < n:
        added = _point_add_u64(fc, tuple(c[..., d:, :] for c in acc),
                               tuple(c[..., : n - d, :] for c in acc))
        acc = tuple(torch.cat([c[..., :d, :], a], dim=-2) for c, a in zip(acc, added))
        d <<= 1
    return acc


def _tree_u64(fc, acc):
    """Pad axis -2 with the identity to msize = the next power of two >= 2,
    then halve it: acc[i] + acc[i + half] for i < half, down to element 0."""
    n = acc[0].shape[-2]
    msize = 1 << max(1, (n - 1).bit_length())
    if msize > n:
        shape = acc[0].shape[:-2] + (msize - n, LIMBS)
        zero = torch.zeros(shape, dtype=torch.int64, device=acc[0].device)
        one = u64(fc.tensor("r_limbs", zero.device)).expand(shape)
        acc = tuple(torch.cat([c, i], dim=-2) for c, i in zip(acc, (zero, one, zero)))
    width = msize
    while width > 1:
        half = width // 2
        acc = _point_add_u64(fc, tuple(c[..., :half, :] for c in acc),
                             tuple(c[..., half:width, :] for c in acc))
        width = half
    return tuple(c[..., 0, :] for c in acc)


def point_scan_plain(fc, ps):
    """The row scan's plain version: the rounds of :func:`point_add_plain`
    that ``msm._hs_point_scan`` made."""
    _row_len(ps, "point_scan")
    return _plain(_hs_scan_u64, fc, ps)


def point_scan_sum_plain(fc, ps):
    """The plain version of the scan with its halving tree, as
    ``msm._bucket_reduce`` made it: (..., L, 8) -> (..., 8)."""
    _row_len(ps, "point_scan_sum")
    return _plain(lambda fc, p: _tree_u64(fc, _hs_scan_u64(fc, p)), fc, ps)


def _splice_shape(within, incl, ends) -> tuple:
    """(rows, buckets, npad, nchunks) of a bucket splice; raises unless
    within is (rows, npad, 8), incl (rows, nchunks, 8) and ends (rows,
    buckets) int64, with npad a multiple of nchunks."""
    w, i = within[0].shape, incl[0].shape
    if len(within) != 3 or len(incl) != 3 or len(w) != 3 or len(i) != 3 or ends.dim() != 2 or \
            any(t.shape != w for t in within) or any(t.shape != i for t in incl) or \
            w[2] != LIMBS or i[2] != LIMBS or w[0] != i[0] or ends.shape[0] != w[0] or \
            ends.dtype != torch.int64 or i[1] < 1 or w[1] % i[1]:
        raise ValueError("bucket_splice: (X, Y, Z) of within (rows, npad, 8) and of incl "
                         "(rows, nchunks, 8), npad a multiple of nchunks, ends (rows, buckets) "
                         "int64")
    return w[0], ends.shape[1], w[1], i[1]


def bucket_splice_plain(fc, within, incl, ends):
    """The splice's plain version, the torch code of ``msm._bucket_sums``:
    P(i) = within[i] + excl[i // c] (excl[0] the identity, excl[k] =
    incl[k - 1], c = npad // nchunks), the identity where i < 0, and bucket
    b = P(ends[b]) + (-P(ends[b - 1])) with ends[-1] = -1."""
    rows, _, npad, nchunks = _splice_shape(within, incl, ends)
    c = npad // nchunks

    def splice(fc, within, incl):
        dev = ends.device
        ident = (torch.zeros((rows, 1, LIMBS), dtype=torch.int64, device=dev),
                 u64(fc.tensor("r_limbs", dev)).expand(rows, 1, LIMBS),
                 torch.zeros((rows, 1, LIMBS), dtype=torch.int64, device=dev))
        excl = tuple(torch.cat([i1, t[:, :-1]], dim=1) for t, i1 in zip(incl, ident))
        prev = torch.cat([torch.full((rows, 1), -1, dtype=ends.dtype, device=dev), ends[:, :-1]],
                         dim=1)

        def gather(c_, idx):
            return torch.gather(c_, 1, idx[..., None].expand(-1, -1, LIMBS))

        def prefix(idx):
            cl = idx.clamp(min=0)
            pts = _point_add_u64(fc, tuple(gather(t, cl) for t in within),
                                 tuple(gather(t, cl // c) for t in excl))
            live = (idx >= 0)[..., None]
            return tuple(torch.where(live, p, i1) for p, i1 in zip(pts, ident))

        e, (px, py, pz) = prefix(ends), prefix(prev)
        return _point_add_u64(fc, e, (px, sub(fc, torch.zeros_like(py), py), pz))

    return _plain(splice, fc, within, incl)


def _check_reps(reps: int) -> None:
    if reps < 1:
        raise ValueError(f"point_double: reps must be >= 1, got {reps}")


def point_double_plain(fc, p, reps: int = 1):
    """K4's plain version: ``reps`` successive doublings."""
    _check_reps(reps)

    def doublings(fc, p):
        for _ in range(reps):
            p = _point_double_u64(fc, p)
        return p

    return _plain(doublings, fc, p)


def _point_add_u64(fc, p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    t0, t1, t2, t3, t4, t5 = _mul_many(
        fc,
        (x1, y1, z1, add(fc, x1, y1), add(fc, y1, z1), add(fc, x1, z1)),
        (x2, y2, z2, add(fc, x2, y2), add(fc, y2, z2), add(fc, x2, z2)),
    )
    t3 = sub(fc, t3, add(fc, t0, t1))  # X1Y2 + X2Y1
    t4 = sub(fc, t4, add(fc, t1, t2))  # Y1Z2 + Y2Z1
    t5 = sub(fc, t5, add(fc, t0, t2))  # X1Z2 + X2Z1
    trip0 = add(fc, add(fc, t0, t0), t0)  # 3 X1X2
    b3z = _mul9(fc, t2)  # b3 Z1Z2
    z3 = add(fc, t1, b3z)
    t1 = sub(fc, t1, b3z)
    y3 = _mul9(fc, t5)  # b3 (X1Z2 + X2Z1)
    m0, m1, m2, m3, m4, m5 = _mul_many(
        fc, (t4, t3, y3, t1, trip0, z3), (y3, t1, trip0, z3, t3, t4)
    )
    return (sub(fc, m1, m0), add(fc, m3, m2), add(fc, m5, m4))


def _point_add_mixed_u64(fc, p1, p2xy):
    x1, y1, z1 = p1
    x2, y2 = p2xy
    t0, t1, t3, ty, tx = _mul_many(
        fc, (x1, y1, add(fc, x2, y2), y2, x2), (x2, y2, add(fc, x1, y1), z1, z1)
    )
    t3 = sub(fc, t3, add(fc, t0, t1))  # X1Y2 + X2Y1
    t4 = add(fc, ty, y1)  # Y1 + Y2Z1
    y3 = add(fc, tx, x1)  # X1 + X2Z1
    trip0 = add(fc, add(fc, t0, t0), t0)  # 3 X1X2
    t2 = _mul9(fc, z1)  # b3 Z1
    z3 = add(fc, t1, t2)
    t1 = sub(fc, t1, t2)
    y3 = _mul9(fc, y3)  # b3 (X1 + X2Z1)
    m0, m1, m2, m3, m4, m5 = _mul_many(
        fc, (t4, t3, y3, t1, trip0, z3), (y3, t1, trip0, z3, t3, t4)
    )
    return (sub(fc, m1, m0), add(fc, m3, m2), add(fc, m5, m4))


def _point_double_u64(fc, p):
    x, y, z = p
    t0, t1, t2, xy = _mul_many(fc, (y, y, z, x), (y, z, z, y))
    z3 = add(fc, t0, t0)
    z3 = add(fc, z3, z3)
    z3 = add(fc, z3, z3)  # 8 Y^2
    t2 = _mul9(fc, t2)  # b3 Z^2
    y3 = add(fc, t0, t2)
    t0 = sub(fc, t0, add(fc, add(fc, t2, t2), t2))
    x3, z3, y3b = _mul_many(fc, (t2, t1, t0), (z3, z3, y3))
    y3 = add(fc, x3, y3b)
    (x3,) = _mul_many(fc, (t0,), (xy,))
    return (add(fc, x3, x3), y3, z3)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(counter: str, symbol: str, ins, outs, n: int, *extra) -> tuple:
    """Launch ``symbol`` on ``ins`` and ``outs`` over ``n`` threads' worth
    of elements (an input of None passes a null pointer); ``extra`` C
    arguments follow the count."""
    from ..utils.cuda_build import library

    stream = torch.cuda.current_stream(ins[0].device).cuda_stream
    ptrs = [None if t is None else t.data_ptr() for t in ins + outs]
    err = getattr(library(), symbol)(*ptrs, n, *extra, stream)
    check_launch(err, symbol)
    LAUNCHES[counter] += 1
    return outs


def _empty3(like: torch.Tensor) -> tuple:
    return tuple(torch.empty_like(like) for _ in range(3))


def _check_fq(fc, key: str) -> None:
    if fc.field.p != BN254_FQ.p:
        raise ValueError(f"{key} is built for BN254 Fq, not {fc.field.name}")


def _check_aligned(ins, key: str) -> None:
    """The lazy-core kernels move each coordinate as two 16-byte accesses."""
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError(f"{key}'s tensors must be 16-byte aligned")


def point_add(fc, p1, p2):
    """K3: complete projective P1 + P2. The kernel is built for BN254 Fq, so
    any other field raises."""
    if p1[0].device.type == "cpu":
        return point_add_plain(fc, p1, p2)
    _check_fq(fc, "K3")
    ins = tuple(p1) + tuple(p2)
    check_kernel_args(*ins)
    _check_aligned(ins, "K3")
    return _launch("g1_add", "h2r_g1_add", ins, _empty3(ins[0]), ins[0].numel() // LIMBS)


def scan_cluster(rows: int, n: int, tree: bool, sms: int) -> int:
    """Blocks per row of a scan of ``rows`` rows of n points on a card of
    ``sms`` SMs: the most, up to MAX_CLUSTER, that keep rows x blocks
    within the SMs (a row's rounds are one block's, or one cluster's, work,
    so few rows leave SMs idle), halved until each block holds at least a
    warp of the row (or, with the tree, of its power of two)."""
    span = 1 << max(1, (n - 1).bit_length()) if tree else n
    cluster = MAX_CLUSTER
    while cluster > 1 and (rows * cluster > sms or span < 32 * cluster):
        cluster //= 2
    return cluster


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scan_rows(fc, ps, tree: bool, cluster: int | None = None):
    """One launch of the row scan (with its halving tree if ``tree``), each
    row on ``cluster`` blocks (default :func:`scan_cluster`)."""
    n = _row_len(ps, "point_scan_sum" if tree else "point_scan")
    _check_fq(fc, "K3")
    ins = tuple(ps)
    check_kernel_args(*ins)
    _check_aligned(ins, "K3")
    rows = ins[0].numel() // (n * LIMBS)
    if cluster is None:
        cluster = scan_cluster(rows, n, tree, _sm_count(ins[0].device))
    lead = ins[0].shape[:-2]
    outs = tuple(torch.empty(lead + ((LIMBS,) if tree else (n, LIMBS)), dtype=torch.int32,
                             device=ins[0].device) for _ in range(3))
    return _launch("g1_scan", "h2r_g1_scan_rows", ins, outs, rows, n, int(tree), cluster)


def point_scan(fc, ps):
    """K3's inclusive Hillis–Steele scan along axis -2 of rows (..., L, 8),
    L <= 512, in one launch: out[..., i, :] = ps[..., 0, :] + ... + ps[...,
    i, :], associated as ``msm._hs_point_scan`` associates it. The kernel is
    built for BN254 Fq, so any other field raises."""
    if ps[0].device.type == "cpu":
        return point_scan_plain(fc, ps)
    return _scan_rows(fc, ps, False)


def point_scan_sum(fc, ps):
    """:func:`point_scan`, padded with the identity to the next power of two
    (at least 2) and halved to one point per row, as ``msm._bucket_reduce``
    does: (..., L, 8) -> (..., 8), in one launch."""
    if ps[0].device.type == "cpu":
        return point_scan_sum_plain(fc, ps)
    return _scan_rows(fc, ps, True)


def bucket_splice(fc, within, incl, ends):
    """The MSM's bucket sums from its chunked prefix scan, in one launch:
    within (rows, npad, 8) (the scan inside each chunk), incl (rows,
    nchunks, 8) (the scan of the chunk totals), ends (rows, buckets) int64,
    each in [-1, npad) (the last element of each bucket, -1 before the
    first): bucket b = P(ends[b]) - P(ends[b - 1]) as in
    :func:`bucket_splice_plain`, (rows, buckets, 8). The kernel is built for
    BN254 Fq, so any other field raises."""
    if within[0].device.type == "cpu":
        return bucket_splice_plain(fc, within, incl, ends)
    rows, buckets, npad, nchunks = _splice_shape(within, incl, ends)
    _check_fq(fc, "K3")
    ins = tuple(within) + tuple(incl)
    check_kernel_args(*within)
    check_kernel_args(*incl)
    _check_aligned(ins, "K3")
    if not ends.is_cuda or not ends.is_contiguous() or ends.device != ins[0].device:
        raise ValueError("bucket_splice: ends must be contiguous on the points' device")
    outs = tuple(torch.empty((rows, buckets, LIMBS), dtype=torch.int32, device=ends.device)
                 for _ in range(3))
    return _launch("g1_splice", "h2r_g1_bucket_splice", ins + (ends,), outs, rows, buckets,
                   npad, nchunks, npad // nchunks)


def _scan_mixed(fc, p1, pts):
    c = _scan_len(p1, pts)
    _check_fq(fc, "K2")
    check_kernel_args(*p1)
    xy = pts[-2:]
    check_kernel_args(*xy)
    ins = tuple(p1) + tuple(xy)
    _check_aligned(ins, "K2")
    order = pts[0] if len(pts) == 3 else None  # None: dense rows
    if order is not None and (not order.is_cuda or not order.is_contiguous() or
                              order.device != ins[0].device):
        raise ValueError("point_scan_mixed: order must be contiguous on the points' device")
    outs = tuple(torch.empty(p1[0].shape[:-1] + (c, LIMBS), dtype=torch.int32,
                             device=ins[0].device) for _ in range(3))
    return _launch("g1_add_mixed", "h2r_g1_scan_mixed", ins + (order,), outs,
                   p1[0].numel() // LIMBS, c)


def point_scan_mixed(fc, p1, pts):
    """K2 over a row per start point: ``out[..., j, :] = p1 + pts[..., 0, :]
    + ... + pts[..., j, :]`` for start points (..., 8) and affine rows
    (..., C, 8), every prefix as (..., C, 8) coordinates, in one launch. The
    rows are (x, y) of (..., C, 8), or an :class:`IndexedRows` whose points
    the kernel reads in place from its source through ``order``. The kernel
    is built for BN254 Fq, so any other field raises."""
    if p1[0].device.type == "cpu":
        return point_scan_mixed_plain(fc, p1, pts)
    return _scan_mixed(fc, p1, pts)


def point_add_mixed(fc, p1, p2xy):
    """K2: projective P1 + affine (x2, y2), the scan with C = 1."""
    if p1[0].device.type == "cpu":
        return point_add_mixed_plain(fc, p1, p2xy)
    out = _scan_mixed(fc, p1, tuple(t.unsqueeze(-2) for t in p2xy))
    return tuple(t.squeeze(-2) for t in out)


def point_double(fc, p, reps: int = 1):
    """K4: projective 2^reps · P, ``reps`` doublings in one launch. The
    kernel is built for BN254 Fq (its curve constant b3 = 9 and its field
    core's constants), so any other field raises."""
    if p[0].device.type == "cpu":
        return point_double_plain(fc, p, reps)
    _check_reps(reps)
    _check_fq(fc, "K4")
    ins = tuple(p)
    check_kernel_args(*ins)
    return _launch("g1_double", "h2r_g1_double", ins, _empty3(ins[0]), ins[0].numel() // LIMBS,
                   reps)

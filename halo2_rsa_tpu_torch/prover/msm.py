"""Multi-scalar multiplication (Pippenger) in PyTorch.

Counterpart of ``halo2_rsa_tpu/prover/msm.py``, step for step, so that
bucket sums, window sums and results equal the reference's projective
coordinates:

  1. c-bit digits of the scalars, least-significant window first;
  2. per window, a stable sort of the points by digit;
  3. a chunked inclusive prefix scan of the sorted points: a C-step
     sequential scan across all chunks at once (one K2 launch of C mixed
     adds per thread when the base points are affine, reading each point in
     place through the sort's permutation; else the points gathered in
     sorted order and C K3 launches),
     a log-depth Hillis–Steele scan over the chunk totals (one K3 scan
     launch), and the chunk offsets spliced in only at the bucket
     boundaries;
  4. bucket sums by prefix-sum differencing at ``searchsorted`` boundaries
     (one K3 splice launch for 3 and 4's splice and differences);
  5. sum_b b * P_b via suffix sums and a halving tree (one K3 scan launch),
     then a Horner combine over windows (per window one K4 launch of
     ``window_bits`` doublings, then a K3 add).

``fori_loop``/``scan`` bodies are Python loops over torch ops.
"""

from __future__ import annotations

import torch

from ..fields import vecfield
from ..fields.cuda_mont import LIMBS, u64
from ..fields.field import BN254_FR
from ..utils.profiling import count, span
from . import curve, g1_vec
from .cuda_g1 import IndexedRows
from .g1_vec import (
    bucket_splice,
    identity,
    point_add,
    point_double,
    point_scan,
    point_scan_mixed,
    point_scan_sum,
)


def _window_bits_for(n: int) -> int:
    """Pippenger window width: 4 bits up to 4096 points, 8 above."""
    return 4 if n <= 4096 else 8


def digits_from_scalar_limbs(scalars: torch.Tensor, window_bits: int = 8) -> torch.Tensor:
    """(..., N, 8) int32 standard-form Fr limbs -> (..., W, N) int64 digits,
    W = 256 / window_bits, least-significant window first."""
    per_limb = 32 // window_bits
    mask = (1 << window_bits) - 1
    v = u64(scalars)
    d = torch.stack([(v >> (t * window_bits)) & mask for t in range(per_limb)], dim=-1)
    d = d.reshape(scalars.shape[:-1] + (LIMBS * per_limb,))
    return d.transpose(-1, -2).contiguous()


def _pick_chunk(n: int) -> int:
    """Sequential chunk length C ~ sqrt(N), capped at 64."""
    c = 1 << max(2, (max(n, 2) - 1).bit_length() // 2)
    return min(c, 64)


def _bucket_sums(digits: torch.Tensor, points, num_buckets: int, z_one: bool = False):
    """digits (W, N) int64; points: projective tuple of (N, 8).

    Returns bucket sums as a tuple of (W, num_buckets, 8) coordinates.
    ``z_one``: every point is affine; the scan uses the mixed add (K2), which
    reads (x, y) of each point in place through the sort's permutation
    (count ``indexed_rows``). Otherwise the points are gathered in sorted
    order (count ``gathered_rows``)."""
    w, n = digits.shape
    dev = digits.device
    ds, order = torch.sort(digits, dim=1, stable=True)

    c_len = _pick_chunk(n)
    npad = -(-n // c_len) * c_len
    n_chunks = npad // c_len
    acc = identity((w, n_chunks), device=dev)
    # padding digits num_buckets sort after every live element, so no bucket
    # boundary reads a prefix containing a padding point
    pad = npad - n
    if pad:
        ds = torch.cat([ds, torch.full((w, pad), num_buckets, dtype=ds.dtype, device=dev)], dim=1)

    # 1) sequential inclusive scan within each length-C chunk; the chunk
    # totals are the last prefixes
    if z_one:
        src = tuple(points[:2])
        if pad:
            # pad with a real affine point (the generator), one row past the
            # source that every padding index reads
            gen = g1_vec.points_to_device([curve.G1_GEN], device=dev)
            src = tuple(torch.cat([c, g]) for c, g in zip(src, gen[:2]))
            order = torch.cat([order, torch.full((w, pad), n, dtype=order.dtype, device=dev)],
                              dim=1)
        count(indexed_rows=w * npad)
        within = point_scan_mixed(acc, IndexedRows(order.reshape(w, n_chunks, c_len, 1), *src))
    else:
        ps = tuple(c[order] for c in points)  # (W, N, 8)
        count(gathered_rows=w * n)
        if pad:
            ident = identity((w, pad), device=dev)
            ps = tuple(torch.cat([c, ic], dim=1) for c, ic in zip(ps, ident))
        p3 = tuple(c.reshape(w, n_chunks, c_len, LIMBS) for c in ps)
        within = tuple(torch.empty_like(c) for c in identity((w, n_chunks, c_len), device=dev))
        for j in range(c_len):
            acc = point_add(acc, tuple(c[:, :, j] for c in p3))
            for o, a in zip(within, acc):
                o[:, :, j] = a
        del p3, ps
    acc = tuple(c[:, :, -1] for c in within)

    # 2) inclusive scan of the chunk totals (n_chunks <= 512: npow <= _SEG)
    incl = point_scan(acc)
    flat_within = tuple(c.reshape(w, npad, LIMBS) for c in within)

    # 3+4) bucket_b = scan[end_b] - scan[end_{b-1}], the chunk offsets (the
    # exclusive scan of the chunk totals) spliced in only at the boundaries
    # read: one K3 splice launch
    targets = torch.arange(num_buckets, dtype=ds.dtype, device=dev).expand(w, num_buckets)
    ends = torch.searchsorted(ds, targets.contiguous(), right=True) - 1  # -1: empty prefix
    return bucket_splice(flat_within, incl, ends)


def _bucket_reduce(buckets):
    """(W, B, 8) coordinates -> per-window sums  sum_b b * bucket_b:
    suffix sums over b >= 1, then a halving tree over them."""
    return point_scan_sum(tuple(c[:, 1:].flip(1) for c in buckets))  # bucket B-1 first


def _window_combine(window_sums, window_bits: int):
    """(P, W, 8) coordinates -> per-poly points (P, 8): Horner over the
    windows, most significant first."""
    p, w = window_sums[0].shape[:2]
    with span("msm.combine"):
        res = identity((p,), device=window_sums[0].device)
        for i in reversed(range(w)):
            res = point_double(res, window_bits)
            res = point_add(res, tuple(c[:, i] for c in window_sums))
    return res


def _msm_chunk_sums(sc: torch.Tensor, points, window_bits: int, z_one: bool = False):
    """sc (PC, N, 8); points shared tuple of (N, 8) -> window sums (PC, W, 8):
    the poly axis folds into the window axis of one bucket pipeline."""
    pc = sc.shape[0]
    digits = digits_from_scalar_limbs(sc, window_bits)  # (PC, W, N)
    w = digits.shape[1]
    flat = digits.reshape(pc * w, digits.shape[2])
    buckets = _bucket_sums(flat, points, 1 << window_bits, z_one)
    sums = _bucket_reduce(buckets)
    return tuple(c.reshape(pc, w, LIMBS) for c in sums)


# Point-axis segment size for large MSMs (bounds the bucket pipeline's
# working set: the segment's points, which K2 reads through the sort's
# permutation, and every prefix of its scan).
_SEG = 1 << 15


def _pick_pchunk(n: int) -> int:
    """Polys per bucket pipeline."""
    if n <= 4096:
        return 8
    if n <= 1 << 15:
        return 4
    return 2


def _chunk_plan(p: int, pc_max: int) -> list:
    """Split the poly axis into chunk sizes from {pc_max, pc_max/2, ..., 1}."""
    sizes = []
    size = pc_max
    rem = p
    while rem:
        while size > rem:
            size //= 2
        sizes.append(size)
        rem -= size
    return sizes


def msm_many(scalars: torch.Tensor, points, z_one: bool = False):
    """Batched MSM: commit P scalar vectors against shared points.

    scalars (P, N, 8) standard-form Fr limbs; points: projective tuple of
    (N, 8) Montgomery Fq coordinates. Returns a projective tuple of (P, 8).
    N is padded to the next power of two (>= 32); with ``z_one`` (every
    base point affine) the padding is the generator, else the identity."""
    p, n = scalars.shape[:2]
    with span("msm", polys=p, points=n):
        return _msm_many(scalars, points, z_one)


def _msm_many(scalars: torch.Tensor, points, z_one: bool):
    p, n = scalars.shape[:2]
    dev = scalars.device
    npow = max(32, 1 << max(0, (n - 1).bit_length()))
    if npow > n:
        pad = npow - n
        scalars = torch.cat(
            [scalars, torch.zeros((p, pad, LIMBS), dtype=torch.int32, device=dev)], dim=1
        )
        if z_one:
            gen = g1_vec.points_to_device([curve.G1_GEN], device=dev)
            padp = tuple(c.expand(pad, LIMBS) for c in gen)
        else:
            padp = identity((pad,), device=dev)
        points = tuple(torch.cat([c, ic], dim=0) for c, ic in zip(points, padp))
    all_sums = []
    i = 0
    if npow > _SEG:
        # point-axis segmentation: window sums accumulate per segment
        wb = _window_bits_for(_SEG)
        pc = max(1, _pick_pchunk(_SEG) // 2)
        for size in _chunk_plan(p, pc):
            sc = scalars[i : i + size]
            i += size
            sums = None
            for s in range(0, npow, _SEG):
                pts_seg = tuple(c[s : s + _SEG] for c in points)
                seg = _msm_chunk_sums(sc[:, s : s + _SEG], pts_seg, wb, z_one)
                sums = seg if sums is None else point_add(sums, seg)
            all_sums.append(sums)
    else:
        wb = _window_bits_for(npow)
        pc = _pick_pchunk(npow)
        for size in _chunk_plan(p, pc):
            sc = scalars[i : i + size]
            i += size
            all_sums.append(_msm_chunk_sums(sc, points, wb, z_one))
    stacked = tuple(torch.cat([ch[c] for ch in all_sums], dim=0) for c in range(3))
    return _window_combine(stacked, wb)


def msm(scalars: torch.Tensor, points, z_one: bool = False):
    """Single MSM (see :func:`msm_many`); returns a coordinate tuple of (8,)."""
    res = msm_many(scalars[None], points, z_one)
    return tuple(c[0] for c in res)


def msm_many_host(scalars: torch.Tensor, points):
    """:func:`msm_many` + conversion to host affine points (list of P)."""
    return g1_vec.points_from_device(msm_many(scalars, points))


def msm_host(scalars_int, points_affine):
    """Host reference (slow): sum of s_i * P_i with Python ints."""
    acc = None
    for s, p in zip(scalars_int, points_affine):
        acc = curve.g1_add(acc, curve.g1_mul(p, s))
    return acc


def run_msm_async(scalars_int, points_affine, device="cuda"):
    """Start one host-int MSM on ``device``; returns a finish() closure that
    yields the affine result. Up to 512 points the window sums come back in
    one transfer and are Horner-combined on the host (the device's
    sequential tail is latency-bound at that size)."""
    fr = vecfield.consts(BN254_FR)
    sc = vecfield.from_ints(fr, scalars_int, mont=False, device=device)
    pts = g1_vec.points_to_device(points_affine, device=device)
    n = sc.shape[0]
    npow = max(32, 1 << max(0, (n - 1).bit_length()))
    if npow <= 512:
        if npow > n:
            sc = torch.cat(
                [sc, torch.zeros((npow - n, LIMBS), dtype=torch.int32, device=device)], dim=0
            )
            pts = tuple(
                torch.cat([c, ic], dim=0)
                for c, ic in zip(pts, identity((npow - n,), device=device))
            )
        wb = _window_bits_for(npow)
        sums = _msm_chunk_sums(sc[None], pts, wb)
        stacked = torch.stack([c[0] for c in sums])

        def finish():
            wpts = g1_vec.points_from_host_stack(stacked.cpu().numpy())
            acc = None
            for p in reversed(wpts):
                if acc is not None:
                    for _ in range(wb):
                        acc = curve.g1_add(acc, acc)
                acc = curve.g1_add(acc, p)
            return acc

        return finish
    res = msm(sc, pts)
    return lambda: g1_vec.points_from_device(tuple(c[None] for c in res))[0]


def run_msm(scalars_int, points_affine, device="cuda"):
    """Host wrapper: ints + affine points -> one affine point."""
    return run_msm_async(scalars_int, points_affine, device)()

"""Multi-rank MSM: the points partitioned over a mesh axis.

Counterpart of ``halo2_rsa_tpu/parallel/sharded_msm.py``:

* each rank runs the single-device Pippenger bucket pipeline
  (``prover.msm``: digits, bucket sums and their reduction — K2, K3's scans
  and splice) over its 1/D of the points;
* the per-rank window sums (W points) are exchanged in one all-gather
  (:func:`.comm.all_gather`, a few KB) and combined by a log2(D) tree of
  K3 adds (:func:`_tree_reduce_dev_axis`; EC addition is the reduction, so
  an all-reduce cannot do it);
* the Horner window combine (K4 + K3) runs on every rank.
"""

from __future__ import annotations

import torch

from ..fields.cuda_mont import LIMBS
from ..prover import g1_vec
from ..prover.g1_vec import point_add
from ..prover.msm import (
    _bucket_reduce,
    _bucket_sums,
    _window_bits_for,
    _window_combine,
    digits_from_scalar_limbs,
)
from . import comm


def _tree_reduce_dev_axis(acc, d: int):
    """EC tree reduction over a leading rank axis: tuple of (D, ..., 8)
    coordinates -> (..., 8). log2(D) rounds of K3 adds, lower half + upper
    half, an odd last entry carried to the next round."""
    size = d
    while size > 1:
        half = size // 2
        lo = tuple(c[:half] for c in acc)
        hi = tuple(c[half : 2 * half] for c in acc)
        merged = point_add(lo, hi)
        if size % 2:
            merged = tuple(
                torch.cat([m, c[size - 1 : size]], dim=0) for m, c in zip(merged, acc)
            )
            size = half + 1
        else:
            size = half
        acc = merged
    return tuple(c[0] for c in acc)


def gather_window_sums(mesh, axis: str, sums):
    """Every rank's window sums (tuple of (..., 8)) -> their EC sum over the
    axis, on every rank: one all-gather of the stacked coordinates, then
    the tree."""
    gathered = comm.all_gather(mesh, axis, torch.stack(sums))  # (D, 3, ..., 8)
    return _tree_reduce_dev_axis(tuple(gathered.unbind(1)), mesh.shape[axis])


def make_sharded_msm(mesh, axis: str = "rows"):
    """Returns msm(scalars (N, 8) standard-form Fr limbs, points: projective
    tuple of (N, 8)) -> a coordinate tuple of (8,), the same on every rank.
    Every rank passes the whole inputs and works on its 1/D; N is padded
    with identity points to a multiple of the axis size."""
    d = mesh.shape[axis]
    r = mesh.coords[axis]

    def msm_sharded(scalars, points):
        n = scalars.shape[0]
        pad = -n % d
        if pad:
            scalars = torch.cat(
                [scalars, torch.zeros((pad, LIMBS), dtype=torch.int32, device=scalars.device)]
            )
            points = tuple(torch.cat([c, ic]) for c, ic in
                           zip(points, g1_vec.identity((pad,), device=scalars.device)))
        nloc = (n + pad) // d
        sc = scalars[r * nloc : (r + 1) * nloc]
        pts = tuple(c[r * nloc : (r + 1) * nloc] for c in points)
        # this rank's bucket pipeline, the window width of the whole size
        window_bits = _window_bits_for(nloc * d)
        digits = digits_from_scalar_limbs(sc, window_bits)
        sums = _bucket_reduce(_bucket_sums(digits, pts, 1 << window_bits))  # (W, 8)
        window_sums = gather_window_sums(mesh, axis, sums)
        out = _window_combine(tuple(c[None] for c in window_sums), window_bits)
        return tuple(c[0] for c in out)

    return msm_sharded

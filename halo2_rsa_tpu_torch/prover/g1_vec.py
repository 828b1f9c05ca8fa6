"""Vectorized BN254 G1 arithmetic in PyTorch.

Counterpart of ``halo2_rsa_tpu/prover/g1_vec.py``. Points are homogeneous
projective (X, Y, Z) tuples of ``(..., 8)`` int32 Montgomery Fq tensors;
infinity is (0, 1, 0). The three point formulas go to K2-K4
(:mod:`.cuda_g1`) after broadcasting their coordinates to one shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import vecfield
from ..fields.cuda_mont import LIMBS
from ..fields.field import BN254_FQ
from . import cuda_g1, curve

FQ = vecfield.consts(BN254_FQ)


def _one_shape(coords):
    coords = torch.broadcast_tensors(*coords)
    return tuple(c.contiguous() for c in coords)


def point_add(p1, p2):
    """Complete projective addition (RCB15 algorithm 7, a = 0): K3."""
    c = _one_shape(tuple(p1) + tuple(p2))
    return cuda_g1.point_add(FQ, c[:3], c[3:])


def point_add_mixed(p1, p2xy):
    """Projective p1 + AFFINE p2 = (x2, y2) (RCB15 algorithm 8): K2.
    Complete for any p1 provided p2 is a real affine point."""
    c = _one_shape(tuple(p1) + tuple(p2xy))
    return cuda_g1.point_add_mixed(FQ, c[:3], c[3:])


def point_double(p):
    """Complete projective doubling (RCB15 algorithm 9, 8 muls): K4."""
    return cuda_g1.point_double(FQ, _one_shape(tuple(p)))


def point_neg(p):
    """-P = (X, -Y, Z); the identity stays a valid identity."""
    x, y, z = p
    return (x, vecfield.sub(FQ, torch.zeros_like(y), y), z)


def point_select(mask, p_true, p_false):
    """Elementwise select between two point batches; mask (...,) bool."""
    m = mask[..., None]
    return tuple(torch.where(m, a, b) for a, b in zip(p_true, p_false))


def identity(batch_shape=(), device="cuda"):
    """(0, 1, 0) in Montgomery form, broadcast to batch_shape."""
    shape = tuple(batch_shape) + (LIMBS,)
    zero = torch.zeros(shape, dtype=torch.int32, device=device)
    one_m = FQ.tensor("r_limbs", device).expand(shape).contiguous()
    return (zero, one_m, zero.clone())


def is_identity(p):
    """(...,) bool: Z == 0."""
    return vecfield.is_zero(p[2])


def points_to_affine(p):
    """Projective (X, Y, Z) -> (X/Z, Y/Z, 1); requires Z != 0 everywhere."""
    x, y, z = p
    zinv = vecfield.batch_inv_nz(FQ, z)
    one = FQ.tensor("r_limbs", z.device).expand(z.shape).contiguous()
    return (vecfield.mont_mul(FQ, x, zinv), vecfield.mont_mul(FQ, y, zinv), one)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def points_to_device(points, device="cuda") -> tuple:
    """Host affine points (x, y) or None -> projective tensors on ``device``;
    infinity becomes (0, 1, 0)."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    return tuple(vecfield.from_ints(FQ, v, device=device) for v in (xs, ys, zs))


def points_from_device(p) -> list:
    """Projective tensors -> host affine points (or None), one transfer."""
    stacked = torch.stack([c.reshape(-1, LIMBS) for c in p]).cpu().numpy()
    return points_from_host_stack(stacked)


def points_from_host_stack(stacked: np.ndarray) -> list:
    """Host (3, N, 8) Montgomery-limb coordinate stack -> affine points."""
    xs = vecfield.to_ints(FQ, stacked[0])
    ys = vecfield.to_ints(FQ, stacked[1])
    zs = vecfield.to_ints(FQ, stacked[2])
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zinv = pow(z, -1, curve.Q)
            out.append((x * zinv % curve.Q, y * zinv % curve.Q))
    return out

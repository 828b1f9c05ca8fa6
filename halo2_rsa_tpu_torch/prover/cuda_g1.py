"""K2-K4: BN254 G1 point kernels — the CUDA wrappers, their plain PyTorch
versions, and their launch counters.

Counterpart of ``halo2_rsa_tpu/prover/pallas_g1.py``. The kernels
(``csrc/g1.cu``) hold a whole Renes–Costello–Batina formula (a = 0, b3 = 9)
per thread:

* K2 :func:`point_add_mixed` — algorithm 8, projective P1 + affine P2
  (``_point_add_mixed_kernel``); complete when P2 is a real affine point;
* K3 :func:`point_add` — algorithm 7, complete projective add
  (``_point_add_kernel``);
* K4 :func:`point_double` — algorithm 9 (``_point_double_kernel``), applied
  ``reps`` times in one launch (``csrc/g1_double.cu``), as the JAX package's
  Horner combine applies it in a ``fori_loop``.

Every wrapper takes coordinate tensors of one shape, ``(..., 8)`` int32
Montgomery Fq limbs. CUDA tensors launch the kernel; CPU tensors run the
``*_plain`` version, the same formula in plain torch ops (``mont_mul_plain``
and the vecfield adds). Both give the reference's projective coordinates bit
for bit, because each step returns the canonical residue.
"""

from __future__ import annotations

import torch

from ..fields.cuda_mont import LIMBS, check_kernel_args, check_launch, mont_mul_u64, p_arg, to_int32, u64
from ..fields.field import BN254_FQ
from ..fields.vecfield import add_u64 as add, sub_u64 as sub

LAUNCHES = {"g1_add_mixed": 0, "g1_add": 0, "g1_double": 0}


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
    """K2's plain version."""
    return _plain(_point_add_mixed_u64, fc, p1, p2xy)


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


def _launch(name: str, ins, *extra) -> tuple:
    """Launch ``h2r_<name>`` on ``ins``; ``extra`` C arguments follow the
    element count."""
    check_kernel_args(*ins)
    from ..utils.cuda_build import library

    outs = tuple(torch.empty_like(ins[0]) for _ in range(3))
    n = ins[0].numel() // LIMBS
    stream = torch.cuda.current_stream(ins[0].device).cuda_stream
    fn = getattr(library(), "h2r_" + name)
    err = fn(*[t.data_ptr() for t in ins + outs], n, *extra, stream)
    check_launch(err, "h2r_" + name)
    LAUNCHES[name] += 1
    return outs


def point_add(fc, p1, p2):
    """K3: complete projective P1 + P2."""
    if p1[0].device.type == "cpu":
        return point_add_plain(fc, p1, p2)
    return _launch("g1_add", tuple(p1) + tuple(p2), p_arg(fc), fc.n0inv32)


def point_add_mixed(fc, p1, p2xy):
    """K2: projective P1 + affine (x2, y2)."""
    if p1[0].device.type == "cpu":
        return point_add_mixed_plain(fc, p1, p2xy)
    return _launch("g1_add_mixed", tuple(p1) + tuple(p2xy), p_arg(fc), fc.n0inv32)


def point_double(fc, p, reps: int = 1):
    """K4: projective 2^reps · P, ``reps`` doublings in one launch. The
    kernel is built for BN254 Fq (its curve constant b3 = 9 and its field
    core's constants), so any other field raises."""
    if p[0].device.type == "cpu":
        return point_double_plain(fc, p, reps)
    _check_reps(reps)
    if fc.field.p != BN254_FQ.p:
        raise ValueError(f"K4 is built for BN254 Fq, not {fc.field.name}")
    return _launch("g1_double", tuple(p), reps)

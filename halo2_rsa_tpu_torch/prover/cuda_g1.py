"""K2-K4: BN254 G1 point kernels — the CUDA wrappers, their plain PyTorch
versions, and their launch counters.

Counterpart of ``halo2_rsa_tpu/prover/pallas_g1.py``. The kernels hold a
whole Renes–Costello–Batina formula (a = 0, b3 = 9) per thread:

* K2 :func:`point_scan_mixed` — algorithm 8, projective P1 + affine P2
  (``_point_add_mixed_kernel``), applied ``c`` times in one launch with
  every prefix stored (``csrc/g1_scan.cu``), as the MSM's bucket scan applies
  it in a ``fori_loop``; :func:`point_add_mixed` is one add (c = 1) through
  the same kernel. Complete when every P2 is a real affine point;
* K3 :func:`point_add` — algorithm 7, complete projective add
  (``_point_add_kernel``, ``csrc/g1.cu``);
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
    """K2's plain version, one add."""
    return _plain(_point_add_mixed_u64, fc, p1, p2xy)


def _scan_len(p1, pts_xy) -> int:
    """C of a scan of start points (..., 8) over affine rows (..., C, 8);
    raises unless the shapes match and C >= 1."""
    shape = p1[0].shape
    rows = pts_xy[0].shape
    if len(p1) != 3 or len(pts_xy) != 2 or shape[-1:] != (LIMBS,) or len(rows) < 2:
        raise ValueError("point_scan_mixed: (X, Y, Z) of (..., 8) and (x, y) of (..., C, 8)")
    if any(t.shape != shape for t in p1) or any(t.shape != rows for t in pts_xy) or \
            rows[:-2] + rows[-1:] != shape:
        raise ValueError(f"point_scan_mixed: start points {tuple(shape)} do not match affine "
                         f"rows {tuple(rows)}")
    if rows[-2] < 1:
        raise ValueError("point_scan_mixed: C must be >= 1, got 0")
    return rows[-2]


def point_scan_mixed_plain(fc, p1, pts_xy):
    """K2's plain version of the scan: :func:`point_add_mixed_plain` applied
    along axis -2 of the affine rows, every prefix kept."""
    c = _scan_len(p1, pts_xy)

    def scan(fc, acc, pts):
        prefixes = []
        for j in range(c):
            acc = _point_add_mixed_u64(fc, acc, tuple(t[..., j, :] for t in pts))
            prefixes.append(acc)
        return tuple(torch.stack(coord, dim=-2) for coord in zip(*prefixes))

    return _plain(scan, fc, p1, pts_xy)


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
    of elements; ``extra`` C arguments follow the count."""
    from ..utils.cuda_build import library

    stream = torch.cuda.current_stream(ins[0].device).cuda_stream
    err = getattr(library(), symbol)(*[t.data_ptr() for t in ins + outs], n, *extra, stream)
    check_launch(err, symbol)
    LAUNCHES[counter] += 1
    return outs


def _empty3(like: torch.Tensor) -> tuple:
    return tuple(torch.empty_like(like) for _ in range(3))


def _check_fq(fc, key: str) -> None:
    if fc.field.p != BN254_FQ.p:
        raise ValueError(f"{key} is built for BN254 Fq, not {fc.field.name}")


def point_add(fc, p1, p2):
    """K3: complete projective P1 + P2."""
    if p1[0].device.type == "cpu":
        return point_add_plain(fc, p1, p2)
    ins = tuple(p1) + tuple(p2)
    check_kernel_args(*ins)
    return _launch("g1_add", "h2r_g1_add", ins, _empty3(ins[0]), ins[0].numel() // LIMBS,
                   p_arg(fc), fc.n0inv32)


def _scan_mixed(fc, p1, pts_xy):
    c = _scan_len(p1, pts_xy)
    _check_fq(fc, "K2")
    check_kernel_args(*p1)
    check_kernel_args(*pts_xy)
    ins = tuple(p1) + tuple(pts_xy)
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError("K2's tensors must be 16-byte aligned")
    return _launch("g1_add_mixed", "h2r_g1_scan_mixed", ins, _empty3(pts_xy[0]),
                   p1[0].numel() // LIMBS, c)


def point_scan_mixed(fc, p1, pts_xy):
    """K2 over a row per start point: ``out[..., j, :] = p1 + pts[..., 0, :]
    + ... + pts[..., j, :]`` for start points (..., 8) and affine rows
    (..., C, 8), every prefix as (..., C, 8) coordinates, in one launch. The
    kernel is built for BN254 Fq, so any other field raises."""
    if p1[0].device.type == "cpu":
        return point_scan_mixed_plain(fc, p1, pts_xy)
    return _scan_mixed(fc, p1, pts_xy)


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

"""KZG polynomial commitments over BN254 in PyTorch.

Counterpart of ``halo2_rsa_tpu/prover/kzg.py``: SRS setup (windowed
fixed-base scalar multiplication on the device, normalised to affine),
MSM commitments, single-point openings via a suffix-sum quotient, and the
host pairing check.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import vecfield
from ..fields.cuda_mont import LIMBS
from ..fields.field import BN254_FR
from ..fields.vecfield import mont_mul
from . import curve, g1_vec, msm
from .g1_vec import identity, point_add

FR = vecfield.consts(BN254_FR)
R = BN254_FR.p


@dataclasses.dataclass
class SRS:
    """Powers of tau. g1_powers: projective tensors (N, 8) x 3 (Montgomery,
    affine: Z = 1); g2_gen / g2_tau: host G2 affine points."""

    n: int
    g1_powers: tuple
    g2_gen: tuple
    g2_tau: tuple

    def g1_affine(self) -> list:
        return g1_vec.points_from_device(self.g1_powers)


# Fixed-base segment length (points per windowed fixed-base pass).
_FB_SEG = 1 << 15


def _fb_table(base_dev):
    """(32, 8) x 3 window bases B_w = 2^{8w} G -> (32, 256, 8) x 3 tables
    T[w, j] = j * B_w, by 256 steps of 32-wide point adds."""
    prev = identity((32,), device=base_dev[0].device)
    rows = []
    for _ in range(256):
        rows.append(prev)
        prev = point_add(prev, base_dev)
    return tuple(torch.stack([r[c] for r in rows], dim=1) for c in range(3))


def _fb_mul(sc: torch.Tensor, table):
    """(N, 8) standard-form scalars x (32, 256, 8) x 3 tables -> N * base:
    32 gather + add steps per point."""
    digs = msm.digits_from_scalar_limbs(sc, 8)  # (32, N)
    acc = identity((sc.shape[0],), device=sc.device)
    for w in range(digs.shape[0]):
        dig = digs[w]
        acc = point_add(acc, tuple(t[w][dig] for t in table))
    return acc


def fixed_base_mul_batch(scalars_int: list[int], base=curve.G1_GEN, device="cuda"):
    """[s_i * base] for many scalars: windowed fixed-base table on
    ``device``, processed in segments of at most _FB_SEG points."""
    wbases = []
    p = base
    for _ in range(32):
        wbases.append(p)
        for _ in range(8):
            p = curve.g1_add(p, p)
    table = _fb_table(g1_vec.points_to_device(wbases, device=device))

    n_total = len(scalars_int)
    seg = min(_FB_SEG, max(32, 1 << (n_total - 1).bit_length()))
    outs = []
    for s in range(0, n_total, seg):
        chunk = scalars_int[s : s + seg]
        m = len(chunk)
        sc = vecfield.from_ints(FR, chunk, mont=False, device=device)
        if m < seg:
            sc = torch.cat(
                [sc, torch.zeros((seg - m, LIMBS), dtype=torch.int32, device=device)], dim=0
            )
        outs.append(tuple(c[:m] for c in _fb_mul(sc, table)))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[c] for o in outs], dim=0) for c in range(3))


def setup(n: int, tau: int | None = None, seed: int = 0, device="cuda") -> SRS:
    """An SRS with ``n`` G1 powers on ``device`` (ParamsKZG::setup analog)."""
    import random

    if tau is None:
        tau = random.Random(seed).randrange(1, R)
    powers = [1] * n
    for i in range(1, n):
        powers[i] = powers[i - 1] * tau % R
    g1_powers = g1_vec.points_to_affine(fixed_base_mul_batch(powers, device=device))
    g2_tau = curve.g2_mul(curve.G2_GEN, tau)
    return SRS(n=n, g1_powers=g1_powers, g2_gen=curve.G2_GEN, g2_tau=g2_tau)


def commit(srs: SRS, coeffs):
    """Commit to a polynomial: ``coeffs`` (N, 8) standard-form Fr limbs or a
    list of ints. Returns a host affine point."""
    if isinstance(coeffs, (list, tuple)):
        coeffs = vecfield.from_ints(FR, list(coeffs), mont=False, device=srs.g1_powers[0].device)
    k = coeffs.shape[0]
    res = msm.msm(coeffs, tuple(c[:k] for c in srs.g1_powers), z_one=True)
    return g1_vec.points_from_device(tuple(c[None] for c in res))[0]


def quotient_poly(coeffs_mont: torch.Tensor, z: int):
    """(q_coeffs_mont, p_z): q(X) = (p(X) - p(z)) / (X - z), by
    b_i = z^{-(i+1)} * sum_{j > i} a_j z^j."""
    n = coeffs_mont.shape[0]
    dev = coeffs_mont.device
    zp = vecfield.pow_series(FR, z, n, dev)
    z_inv = pow(z, -1, R)
    zi0 = vecfield.from_ints(FR, [z_inv], device=dev)
    zip_ = mont_mul(FR, vecfield.pow_series(FR, z_inv, n, dev), zi0)
    s = vecfield.suffix_add(FR, mont_mul(FR, coeffs_mont, zp))
    s_next = torch.cat([s[1:], torch.zeros((1, LIMBS), dtype=torch.int32, device=dev)], dim=0)
    q = mont_mul(FR, s_next, zip_)
    p_z = vecfield.to_ints(FR, s[:1], mont=True)[0]
    return q, p_z


def open_at(srs: SRS, coeffs, z: int):
    """Opening proof for p at z; ``coeffs`` list of ints or (N, 8)
    standard-form tensor. Returns (v = p(z), pi affine)."""
    if isinstance(coeffs, (list, tuple)):
        coeffs = vecfield.from_ints(FR, list(coeffs), mont=False, device=srs.g1_powers[0].device)
    q_mont, v = quotient_poly(vecfield.to_mont(FR, coeffs), z)
    q_std = vecfield.from_mont(FR, q_mont)
    k = q_std.shape[0]
    pi = msm.msm(q_std, tuple(c[:k] for c in srs.g1_powers), z_one=True)
    return v, g1_vec.points_from_device(tuple(c[None] for c in pi))[0]


def verify_open(srs: SRS, commitment, z: int, v: int, pi) -> bool:
    """Check e(pi, [tau - z]_2) == e(C - v G1, [1]_2) via one pairing product."""
    c_minus_v = curve.g1_add(commitment, curve.g1_neg(curve.g1_mul(curve.G1_GEN, v)))
    tau_minus_z = curve.g2_add(srs.g2_tau, curve.g2_neg(curve.g2_mul(srs.g2_gen, z)))
    return curve.pairing_check([(pi, tau_minus_z), (curve.g1_neg(c_minus_v), srs.g2_gen)])

"""G1 layer of the PyTorch port against the JAX package.

K2-K4's plain versions are held against the JAX package's ``g1_vec`` (its
XLA path) at 16 points that include the identity, P+P and P+(-P), and, in
the slow tier, against the Pallas kernels run in interpret mode (the JAX
package's own tests keep that interpret run in the slow tier too: it costs
minutes on a CPU). Projective coordinates are compared bitwise (same RCB15
formulas, canonical residues); affine results also against the host curve
arithmetic.
"""

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.prover import curve as jcurve
from halo2_rsa_tpu.prover import g1_vec as jg1
from halo2_rsa_tpu.prover import pallas_g1
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.prover import cuda_g1, curve
from halo2_rsa_tpu_torch.prover import g1_vec as tg1

torch.set_num_threads(1)
N = 16


def _inputs():
    """Two batches of 16 projective points with random Z (numpy seed):
    lanes 0-3 P+P, lanes 4-7 P+(-P), lanes 8-9 identity + Q, lanes 10-11
    P + identity, the rest unrelated points."""
    rng = np.random.default_rng(21)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=2 * N)]
    a = [curve.g1_mul(curve.G1_GEN, k) for k in ks[:N]]
    b = [curve.g1_mul(curve.G1_GEN, k) for k in ks[N:]]
    b[0:4] = a[0:4]
    b[4:8] = [curve.g1_neg(p) for p in a[4:8]]
    a[8:10] = [None, None]
    b[10:12] = [None, None]
    zs = [int(z) % curve.Q or 1 for z in rng.integers(1, 1 << 62, size=2 * N)]

    def scaled(pts, zs_):
        """(X Z, Y Z, Z) for each affine point; (0, Z, 0) for infinity."""
        xs, ys, zz = [], [], []
        for p, z in zip(pts, zs_):
            if p is None:
                xs.append(0), ys.append(z), zz.append(0)
            else:
                xs.append(p[0] * z % curve.Q), ys.append(p[1] * z % curve.Q), zz.append(z)
        return xs, ys, zz

    return a, b, scaled(a, zs[:N]), scaled(b, zs[N:])


def _both(coord_ints):
    j = tuple(jg1.vecfield.from_ints(jg1.FQ, c) for c in coord_ints)
    t = tuple(tvf.from_ints(tg1.FQ, c, device="cpu") for c in coord_ints)
    return j, t


def _same(port_pt, jax_pt):
    for pc, jc in zip(port_pt, jax_pt):
        assert np.array_equal(tvf.limbs_to_ref(pc), np.asarray(jc))


@pytest.fixture(scope="module")
def pts():
    a, b, sa, sb = _inputs()
    (ja, ta), (jb, tb) = _both(sa), _both(sb)
    return dict(a=a, b=b, ja=ja, ta=ta, jb=jb, tb=tb)


def test_k3_point_add_matches_jax_and_host(pts):
    got = cuda_g1.point_add_plain(tg1.FQ, pts["ta"], pts["tb"])
    _same(got, jg1.point_add(pts["ja"], pts["jb"]))
    assert tg1.points_from_device(got) == [curve.g1_add(p, q) for p, q in zip(pts["a"], pts["b"])]
    _same(tg1.point_add(pts["ta"], pts["tb"]), jg1.point_add(pts["ja"], pts["jb"]))


def _affine_operand(pts):
    """A real affine point on every lane (the mixed add's contract): a's own
    points rotated by one, with P + P on lane 0 and P + (-P) on lane 4."""
    aff = [p if p is not None else curve.G1_GEN for p in pts["a"]]
    aff = [aff[0]] + aff[2:4] + [curve.g1_neg(aff[4])] + aff[5:] + aff[1:2]
    xy = [[p[0] for p in aff], [p[1] for p in aff]]
    jxy = tuple(jg1.vecfield.from_ints(jg1.FQ, c) for c in xy)
    txy = tuple(tvf.from_ints(tg1.FQ, c, device="cpu") for c in xy)
    return aff, jxy, txy


def test_k2_point_add_mixed_matches_jax_and_host(pts):
    aff, jxy, txy = _affine_operand(pts)
    got = cuda_g1.point_add_mixed_plain(tg1.FQ, pts["ta"], txy)
    _same(got, jg1.point_add_mixed(pts["ja"], jxy))
    assert tg1.points_from_device(got) == [curve.g1_add(p, q) for p, q in zip(pts["a"], aff)]


def test_k4_point_double_matches_jax_and_host(pts):
    got = cuda_g1.point_double_plain(tg1.FQ, pts["ta"])
    _same(got, jg1.point_double(pts["ja"]))
    assert tg1.points_from_device(got) == [curve.g1_add(p, p) for p in pts["a"]]


@pytest.mark.slow
def test_k2_k3_k4_plain_match_pallas_interpret(pts):
    _, jxy, txy = _affine_operand(pts)
    _same(
        cuda_g1.point_add_plain(tg1.FQ, pts["ta"], pts["tb"]),
        pallas_g1.point_add_pallas(jg1.FQ, pts["ja"], pts["jb"], interpret=True),
    )
    _same(
        cuda_g1.point_add_mixed_plain(tg1.FQ, pts["ta"], txy),
        pallas_g1.point_add_mixed_pallas(jg1.FQ, pts["ja"], jxy, interpret=True),
    )
    _same(
        cuda_g1.point_double_plain(tg1.FQ, pts["ta"]),
        pallas_g1.point_double_pallas(jg1.FQ, pts["ja"], interpret=True),
    )


def test_point_helpers_match_jax(pts):
    _same(tg1.point_neg(pts["ta"]), jg1.point_neg(pts["ja"]))
    mask = np.arange(N) % 3 == 0
    _same(
        tg1.point_select(torch.from_numpy(mask), pts["ta"], pts["tb"]),
        jg1.point_select(mask, pts["ja"], pts["jb"]),
    )
    assert np.array_equal(tg1.is_identity(pts["ta"]).numpy(), np.asarray(jg1.is_identity(pts["ja"])))
    _same(tg1.identity((3,), device="cpu"), jg1.identity((3,)))
    live = [i for i in range(N) if pts["a"][i] is not None]
    sub_t = tuple(c[live] for c in pts["ta"])
    sub_j = tuple(c[np.asarray(live)] for c in pts["ja"])
    _same(tg1.points_to_affine(sub_t), jg1.points_to_affine(sub_j))


def test_host_conversions_match_jax(pts):
    _same(tg1.points_to_device(pts["a"], device="cpu"), jg1.points_to_device(pts["a"]))
    assert tg1.points_from_device(pts["ta"]) == jg1.points_from_device(pts["ja"]) == pts["a"]
    stacked = np.stack([c.numpy() for c in pts["tb"]])
    assert tg1.points_from_host_stack(stacked) == pts["b"]
    assert jcurve.G1_GEN == curve.G1_GEN

"""KZG of the PyTorch port against the JAX package.

The SRS's G1 powers are compared bitwise with the JAX package's
``kzg.setup`` (and with a multi-segment fixed-base run, ``_FB_SEG`` set
small); ``convert.srs`` carries the JAX SRS across bit for bit; commits,
openings and quotients agree exactly and the pairing check accepts the
port's openings and rejects a wrong value.
"""

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.fields import vecfield as jvf
from halo2_rsa_tpu.prover import kzg as jkzg
from halo2_rsa_tpu_torch import convert
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.prover import curve
from halo2_rsa_tpu_torch.prover import kzg as tkzg

torch.set_num_threads(1)
R = curve.R


def _same_points(port_pts, jax_pts):
    for pc, jc in zip(port_pts, jax_pts):
        assert np.array_equal(tvf.limbs_to_ref(pc), np.asarray(jc))


@pytest.fixture(scope="module")
def srs_pair():
    return tkzg.setup(40, tau=987654321, device="cpu"), jkzg.setup(40, tau=987654321)


def test_setup_matches_jax(srs_pair):
    t, j = srs_pair
    _same_points(t.g1_powers, j.g1_powers)
    assert (t.n, t.g2_gen, t.g2_tau) == (j.n, j.g2_gen, j.g2_tau)
    aff = t.g1_affine()
    assert aff[3] == curve.g1_mul(curve.G1_GEN, pow(987654321, 3, R))


def test_convert_srs_is_bitwise(srs_pair):
    t, j = srs_pair
    c = convert.srs(j, device="cpu")
    for a, b in zip(c.g1_powers, t.g1_powers):
        assert torch.equal(a, b)
    assert (c.n, c.g2_gen, c.g2_tau) == (t.n, t.g2_gen, t.g2_tau)


def test_fixed_base_multi_segment_matches_single(monkeypatch):
    scalars = [0, 1, 2, R - 1] + [int(x) for x in np.random.default_rng(3).integers(1, 1 << 62, 66)]
    whole = tkzg.fixed_base_mul_batch(scalars, device="cpu")
    monkeypatch.setattr(tkzg, "_FB_SEG", 32)
    seg = tkzg.fixed_base_mul_batch(scalars, device="cpu")
    for a, b in zip(seg, whole):
        assert torch.equal(a, b)
    from halo2_rsa_tpu_torch.prover import g1_vec

    assert g1_vec.points_from_device(seg) == [curve.g1_mul(curve.G1_GEN, s) for s in scalars]


def test_commit_open_verify_match_jax(srs_pair):
    t, j = srs_pair
    rng = np.random.default_rng(4)
    coeffs = [int(x) % R for x in rng.integers(0, 1 << 62, 32)]
    c = tkzg.commit(t, coeffs)
    assert c == jkzg.commit(j, coeffs)
    z = 1234567891011
    v, pi = tkzg.open_at(t, coeffs, z)
    assert (v, pi) == jkzg.open_at(j, coeffs, z)
    assert v == sum(a * pow(z, i, R) for i, a in enumerate(coeffs)) % R
    assert tkzg.verify_open(t, c, z, v, pi)
    assert not tkzg.verify_open(t, c, z, (v + 1) % R, pi)


def test_quotient_poly_matches_jax():
    rng = np.random.default_rng(5)
    coeffs = [int(x) % R for x in rng.integers(0, 1 << 62, 29)]
    z = 987654321987654321
    qt, vt = tkzg.quotient_poly(tvf.from_ints(tkzg.FR, coeffs, device="cpu"), z)
    qj, vj = jkzg.quotient_poly(jvf.from_ints(jkzg.FR, coeffs), z)
    assert vt == vj
    assert np.array_equal(tvf.limbs_to_ref(qt), np.asarray(qj))

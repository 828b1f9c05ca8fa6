"""The hand-written CUDA kernels K1-K4 against their plain torch versions.

The kernel tests need an NVIDIA GPU and nvcc: they carry the ``cuda``
marker and skip without a card (the card gate ``chip_smoke.py`` runs the
same comparisons at the main path's shapes). Every comparison is bitwise.
The argument checks and the CPU dispatch run everywhere.
"""

import random

import pytest
import torch

from halo2_rsa_tpu_torch.fields import ALL_FIELDS, cuda_mont, vecfield
from halo2_rsa_tpu_torch.prover import cuda_g1, curve, g1_vec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _points(n, device):
    rng = random.Random(5)
    pts = [curve.g1_mul(curve.G1_GEN, rng.randrange(1, curve.R)) for _ in range(n)]
    pts[1] = None
    return g1_vec.points_to_device(pts, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ALL_FIELDS, ids=lambda f: f.name)
def test_k1_kernel_matches_plain(cuda, field):
    fc = vecfield.consts(field)
    rng = random.Random(3)
    xs = [0, 1, field.p - 1] + [rng.randrange(field.p) for _ in range(4093)]
    ys = [field.p - 1] * 3 + [rng.randrange(field.p) for _ in range(4093)]
    a = vecfield.from_ints(fc, xs, device=cuda)
    b = vecfield.from_ints(fc, ys, device=cuda)
    before = cuda_mont.LAUNCHES["mont_mul"]
    got = cuda_mont.mont_mul(fc, a, b)
    assert cuda_mont.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, cuda_mont.mont_mul_plain(fc, a, b))
    assert torch.equal(got.cpu(), cuda_mont.mont_mul(fc, a.cpu(), b.cpu()))


@pytest.mark.cuda
def test_k2_k3_k4_kernels_match_plain(cuda):
    fq = g1_vec.FQ
    p1 = _points(1000, cuda)
    p2 = tuple(c.roll(3, 0).contiguous() for c in p1)
    xy = tuple(c.roll(5, 0).contiguous() for c in g1_vec.points_to_affine(
        tuple(torch.cat([c[:1], c[2:]]) for c in p1))[:2])
    p1m = tuple(torch.cat([c[:1], c[2:]]) for c in p1)
    for kern, plain, args in (
        (cuda_g1.point_add, cuda_g1.point_add_plain, (p1, p2)),
        (cuda_g1.point_add_mixed, cuda_g1.point_add_mixed_plain, (p1m, xy)),
        (cuda_g1.point_double, cuda_g1.point_double_plain, (p1,)),
    ):
        got = kern(fq, *args)
        want = plain(fq, *args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_arguments(cuda):
    fc = vecfield.consts(ALL_FIELDS[0])
    a = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cuda_mont.mont_mul(fc, a.long(), a.long())
    with pytest.raises(ValueError):
        cuda_mont.mont_mul(fc, a.t().contiguous().t(), a)
    with pytest.raises(ValueError):
        cuda_mont.mont_mul(fc, a, a[:2])


def test_argument_checks_reject_cpu_and_bad_layouts():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_mont.check_kernel_args(a, a)
    with pytest.raises(ValueError):
        cuda_mont.check_kernel_args(a[:, :4])
    cuda_mont.check_launch(0, "h2r_mont_mul")  # cudaSuccess passes


def test_cpu_tensors_take_the_plain_versions_without_counting():
    fc = vecfield.consts(ALL_FIELDS[1])
    pts = _points(8, "cpu")
    before = dict(cuda_g1.LAUNCHES), dict(cuda_mont.LAUNCHES)
    for g, w in zip(cuda_g1.point_double(fc, pts), cuda_g1.point_double_plain(fc, pts)):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError):
        cuda_mont.check_launch(1, "h2r_mont_mul")
    assert (dict(cuda_g1.LAUNCHES), dict(cuda_mont.LAUNCHES)) == before

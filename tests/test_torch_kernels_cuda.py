"""The hand-written CUDA kernels K1-K4, P1 and P2 against their plain torch
versions.

The kernel tests need an NVIDIA GPU and nvcc: they carry the ``cuda``
marker and skip without a card (the card gate ``chip_smoke.py`` runs the
same comparisons at the main path's shapes). Every comparison is bitwise.
The argument checks and the CPU dispatch run everywhere.
"""

import random

import pytest
import torch

from halo2_rsa_tpu_torch.bench import mont_layout, vpu_ops
from halo2_rsa_tpu_torch.fields import ALL_FIELDS, cuda_mont, vecfield
from halo2_rsa_tpu_torch.prover import cuda_g1, curve, g1_vec
from halo2_rsa_tpu_torch.utils import cuda_build


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


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(vpu_ops.BODIES))
def test_p1_kernel_matches_plain(cuda, body):
    gen = torch.Generator().manual_seed(13)
    x = torch.randint(-(1 << 31), 1 << 31, (16, 3000), dtype=torch.int32, generator=gen)
    y = torch.randint(-(1 << 31), 1 << 31, (16, 3000), dtype=torch.int32, generator=gen)
    xc, yc = x.to(cuda), y.to(cuda)
    for reps in (8, 64):
        before = vpu_ops.LAUNCHES["int_ops"]
        got = vpu_ops.int_ops(body, xc, yc, reps)
        assert vpu_ops.LAUNCHES["int_ops"] == before + 1
        assert torch.equal(got, vpu_ops.int_ops_plain(body, xc, yc, reps))
        assert torch.equal(got.cpu(), vpu_ops.int_ops(body, x, y, reps))


@pytest.mark.cuda
def test_p1_machine_code_keeps_every_step(cuda):
    """nvcc/ptxas must not fold a body's chain: at least one integer
    instruction per rep survives in each instantiation."""
    sass = cuda_build.sass_opcodes()
    for body, bid in vpu_ops.BODY_IDS.items():
        for reps in (8, 64):
            ops = cuda_build.kernel_opcodes(sass, "h2r_int_ops_kernel", bid, reps)
            assert cuda_build.int_instructions(ops) >= reps, (body, reps, dict(ops))


@pytest.mark.cuda
@pytest.mark.parametrize("field", ALL_FIELDS, ids=lambda f: f.name)
def test_p2_kernels_match_k1(cuda, field):
    fc = vecfield.consts(field)
    n = 4099  # not a multiple of any block size: the ragged tile is masked
    a = mont_layout.random_elements(fc, n, 1, cuda)
    b = mont_layout.random_elements(fc, n, 2, cuda)
    a[:3] = vecfield.from_ints(fc, [0, 1, field.p - 1], mont=False, device=cuda)
    b[:3] = vecfield.from_ints(fc, [field.p - 1] * 3, mont=False, device=cuda)
    want = cuda_mont.mont_mul(fc, a, b)
    before = dict(mont_layout.LAUNCHES)
    lm = mont_layout.mont_mul_lm(fc, a.t().contiguous(), b.t().contiguous())
    assert torch.equal(lm.t(), want)
    assert torch.equal(lm, mont_layout.mont_mul_lm_plain(fc, a.t().contiguous(), b.t().contiguous()))
    for t in mont_layout.THREADS:
        assert torch.equal(mont_layout.mont_mul_staged(fc, a, b, t), want)
    assert torch.equal(mont_layout.mont_mul_staged_plain(fc, a, b), want)
    assert mont_layout.LAUNCHES == {
        "mont_mul_lm": before["mont_mul_lm"] + 1,
        "mont_mul_staged": before["mont_mul_staged"] + len(mont_layout.THREADS),
    }


@pytest.mark.cuda
def test_probe_wrappers_reject_bad_arguments(cuda):
    x = torch.zeros((16, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        vpu_ops.int_ops("mul", x, x, 7)  # no kernel built for this REPS
    with pytest.raises(TypeError):
        vpu_ops.int_ops("mul", x.long(), x.long(), 8)
    with pytest.raises(ValueError):
        vpu_ops.int_ops("mul", x, x[:8], 8)
    with pytest.raises(ValueError):
        vpu_ops.int_ops("mul", x.t(), x.t(), 8)
    fc = vecfield.consts(ALL_FIELDS[0])
    at = torch.zeros((8, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mont_layout.mont_mul_lm(fc, at.t().contiguous(), at.t().contiguous())  # (64, 8)
    with pytest.raises(TypeError):
        mont_layout.mont_mul_lm(fc, at.long(), at.long())
    a = torch.zeros((64, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mont_layout.mont_mul_staged(fc, a, a, threads=1024)
    off = torch.zeros(8 * 64 + 1, dtype=torch.int32, device=cuda)[1:].view(64, 8)
    with pytest.raises(ValueError):
        mont_layout.mont_mul_staged(fc, off, off)  # 4 bytes past a 16-byte boundary

"""The hand-written CUDA kernels K1-K4 (K3 also as the MSM's row scans and
bucket splice), the NTT, P1 and P2 against their plain torch versions.

K1 is also held at 2^20 products and with a broadcast operand read in
place, and its own kernels K1-pow (the exponentiation) and K1-prefix (the
prefix product) at lengths around K1-prefix's tile and at one row of more
than tile^2 elements. K3 is also held on coordinates lifted by q, as its
lazy core may hold them, and its row scans over 128 rows with every cluster
size. K2 is also held reading its rows in place through a bucket sort's
permutation against K2 on the gathered rows. The NTT kernel (one launch per stage) is held against the torch stage
loop from 2 to 2^21 elements.

The kernel tests need an NVIDIA GPU and nvcc: they carry the ``cuda``
marker and skip without a card. Every comparison is bitwise. The argument
checks, the CPU dispatch, the SASS loop split and a limb-level model of the
lazy field core (csrc/fq_lazy.cuh) and of K4's, K2's and K3's steps on it
run everywhere. Three modules whose products run through K1 are checked on
the card too: the constraint checker against itself on the CPU, the key
artifacts saved and loaded back on the card, and batched witness replay
against itself on the CPU and a golden proof from its witness. A
dynamic-length SHA-256 circuit is proved there for two message lengths under
one key.
"""

import itertools
import math
import os
import random
import re

import pytest
import torch

from halo2_rsa_tpu_torch.bench import mont_layout, vpu_ops
from halo2_rsa_tpu_torch.fields import ALL_FIELDS, cuda_mont, vecfield
from halo2_rsa_tpu_torch.fields.field import BN254_FQ
from halo2_rsa_tpu_torch.prover import cuda_g1, curve, g1_vec, ntt
from halo2_rsa_tpu_torch.utils import cuda_build, profiling


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
@pytest.mark.parametrize("n", [4096, 1 << 20])
@pytest.mark.parametrize("field", ALL_FIELDS, ids=lambda f: f.name)
def test_k1_kernel_matches_plain(cuda, field, n):
    """n products, every pair of 0, 1 and p - 1 among them; the first
    against Python ints too."""
    fc = vecfield.consts(field)
    rng = random.Random(3)
    edge = [0, 1, field.p - 1]
    xs = edge * 3 + [rng.randrange(field.p) for _ in range(n - 9)]
    ys = [e for e in edge for _ in range(3)] + [rng.randrange(field.p) for _ in range(n - 9)]
    a = vecfield.from_ints(fc, xs, device=cuda)
    b = vecfield.from_ints(fc, ys, device=cuda)
    before = cuda_mont.LAUNCHES["mont_mul"]
    got = cuda_mont.mont_mul(fc, a, b)
    assert cuda_mont.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, cuda_mont.mont_mul_plain(fc, a, b))
    assert torch.equal(got.cpu(), cuda_mont.mont_mul(fc, a.cpu(), b.cpu()))
    assert vecfield.to_ints(fc, got[:16]) == [x * y % field.p for x, y in zip(xs, ys[:16])]


@pytest.mark.cuda
@pytest.mark.parametrize("field", ALL_FIELDS, ids=lambda f: f.name)
def test_k1_pow_kernel_matches_plain(cuda, field):
    fc = vecfield.consts(field)
    a = mont_layout.random_elements(fc, 300, 4, cuda)
    a[:3] = vecfield.from_ints(fc, [0, 1, field.p - 1], device=cuda)
    for e in (0, 1, 2, 3, field.p - 2, (1 << 253) + 12345, (1 << 256) - 1,
              random.Random(13).getrandbits(253) | 1 << 252):
        before = cuda_mont.LAUNCHES["mont_pow"]
        got = cuda_mont.mont_pow(fc, a, e)
        assert cuda_mont.LAUNCHES["mont_pow"] == before + 1
        assert torch.equal(got, cuda_mont.mont_pow_plain(fc, a, e)), e
        assert vecfield.to_ints(fc, got[:4]) == [pow(x, e, field.p) for x in
                                                 vecfield.to_ints(fc, a[:4])], e


@pytest.mark.cuda
def test_k1_pow_wrapper_rejects_bad_arguments(cuda):
    fc = vecfield.consts(ALL_FIELDS[0])
    a = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    before = cuda_mont.LAUNCHES["mont_pow"]
    with pytest.raises(TypeError):
        cuda_mont.mont_pow(fc, a.long(), 5)
    with pytest.raises(ValueError):
        cuda_mont.mont_pow(fc, a.t().contiguous().t(), 5)
    with pytest.raises(ValueError):
        cuda_mont.mont_pow(fc, a[:, :4], 5)
    off = torch.zeros(4 * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(4, 8)
    with pytest.raises(ValueError):  # 4 bytes past a 16-byte boundary
        cuda_mont.mont_pow(fc, off, 5)
    for e in (-1, 1 << 256):
        with pytest.raises(ValueError):
            cuda_mont.mont_pow(fc, a, e)
    assert cuda_mont.LAUNCHES["mont_pow"] == before


def _prefix_check(fc, x, lengths, cuda):
    """K1-prefix over the first (or, reversed, the last) n of each row of x
    against one plain run over all of x: a prefix of the first n elements is
    the first n prefixes (a suffix product of the last n the last n)."""
    for reverse in (False, True):
        want = cuda_mont.mont_prefix_plain(fc, x, reverse)
        for n in lengths:
            xs = (x[:, -n:] if reverse else x[:, :n]).contiguous()
            before = cuda_mont.LAUNCHES["mont_prefix"]
            got = cuda_mont.mont_prefix(fc, xs, reverse)
            assert cuda_mont.LAUNCHES["mont_prefix"] == before + cuda_mont.prefix_launches(n)
            assert torch.equal(got, want[:, -n:] if reverse else want[:, :n]), (n, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ALL_FIELDS, ids=lambda f: f.name)
def test_k1_prefix_kernel_matches_plain(cuda, field):
    fc = vecfield.consts(field)
    tile = cuda_mont.PREFIX_TILE
    assert cuda_build.library().h2r_mont_prefix_tile() == tile
    lengths = [1, 2, 3, 37, tile - 1, tile, tile + 1, 2 * tile + 3, (1 << 12) + 4, (1 << 15) + 4]
    for rows in (1, 3):
        x = mont_layout.random_elements(fc, rows * lengths[-1], 5 + rows, cuda)
        _prefix_check(fc, x.view(rows, lengths[-1], 8), lengths, cuda)
        ints = vecfield.to_ints(fc, x[:8])
        want = list(itertools.accumulate(ints, lambda u, v: u * v % field.p))
        got = cuda_mont.mont_prefix(fc, x[None, :8].contiguous())[0]
        assert vecfield.to_ints(fc, got) == want


@pytest.mark.cuda
def test_k1_prefix_carries_across_tiles_of_totals(cuda):
    """Rows of more than PREFIX_TILE^2 elements: the scan of the tile totals
    takes more than one tile of them."""
    fc = vecfield.consts(ALL_FIELDS[0])
    n = cuda_mont.PREFIX_TILE ** 2 + 3
    x = mont_layout.random_elements(fc, n, 9, cuda)
    _prefix_check(fc, x.view(1, n, 8), [n, n - 4], cuda)


@pytest.mark.cuda
def test_k1_prefix_wrapper_rejects_bad_arguments(cuda):
    fc = vecfield.consts(ALL_FIELDS[0])
    a = torch.zeros((2, 4, 8), dtype=torch.int32, device=cuda)
    off = torch.zeros(2 * 4 * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(2, 4, 8)
    before = cuda_mont.LAUNCHES["mont_prefix"]
    with pytest.raises(TypeError):
        cuda_mont.mont_prefix(fc, a.long())
    for bad in (a.transpose(0, 1), a[..., :4], a[0, 0], off):
        with pytest.raises(ValueError):
            cuda_mont.mont_prefix(fc, bad)
    assert cuda_mont.LAUNCHES["mont_prefix"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("polys", [1, 4, 11])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 10, 12, 15, 17, 18, 21])
def test_ntt_kernel_matches_loop(cuda, log_n, polys, inverse):
    """The NTT kernel (csrc/ntt.cu) bitwise against the torch stage loop on
    the card, from 2 to 2^21 elements (the extended domain at k=18); one
    NTT of 2^log_n is log_n launches and no K1 launch, counted on the
    wrapper and on the ``ntt`` span."""
    fc = ntt.FR
    a = mont_layout.random_elements(fc, polys << log_n, 7 * log_n + polys, cuda)
    edge = vecfield.from_ints(fc, [0, 1, fc.field.p - 1][: 1 << log_n], device=cuda)
    a[: edge.shape[0]] = edge
    a = a.view(polys, 1 << log_n, 8)
    k1 = dict(cuda_mont.LAUNCHES)
    before = ntt.LAUNCHES["ntt"]
    with profiling.tracing() as trace:
        got = ntt._ntt_graph(a, log_n, inverse)
    assert ntt.LAUNCHES["ntt"] == before + log_n
    assert cuda_mont.LAUNCHES == k1
    assert trace.totals()["ntt"]["launches"] == log_n
    assert torch.equal(got, ntt._ntt_loop(a, log_n, inverse))


@pytest.mark.cuda
def test_ntt_public_functions_on_the_card(cuda):
    """ntt/intt and their batches on the card: the round trip is the
    identity, and each equals the CPU's result; at 2^4 both directions
    equal the host DFT."""
    fc = ntt.FR
    vals = [random.Random(46).randrange(fc.field.p) for _ in range(16)]
    fwd = ntt.ntt(vecfield.from_ints(fc, vals, device=cuda), 4)
    assert vecfield.to_ints(fc, fwd) == ntt.ntt_host(vals)
    assert vecfield.to_ints(fc, ntt.intt(fwd, 4)) == vals
    log_n = 12
    x = mont_layout.random_elements(fc, 3 << log_n, 77, cuda).view(3, 1 << log_n, 8)
    fwd = ntt.ntt_batch(x, log_n)
    assert torch.equal(ntt.intt_batch(fwd, log_n), x)
    assert torch.equal(fwd.cpu(), ntt.ntt_batch(x.cpu(), log_n))
    assert torch.equal(ntt.ntt(x[1], log_n), fwd[1])
    assert torch.equal(ntt.intt(fwd[2], log_n), x[2])


def test_ntt_dispatch_by_device():
    """A CPU tensor runs the torch loop (no launch; the kernel's wrapper
    refuses it); the full stage-twiddle tables exist for the CPU only."""
    a = mont_layout.random_elements(ntt.FR, 16, 3, "cpu").view(2, 8, 8)
    before = ntt.LAUNCHES["ntt"]
    assert torch.equal(ntt._ntt_graph(a, 3, True), ntt._ntt_loop(a, 3, True))
    with pytest.raises(ValueError):
        ntt._ntt_kernel(a, 3, True)
    assert ntt.LAUNCHES["ntt"] == before
    assert ntt._twiddles_full(10, False, "cpu") is not None
    assert ntt._twiddles_full(10, False, "cuda") is None


@pytest.mark.cuda
def test_ntt_kernel_rejects_bad_arguments(cuda):
    a = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    before = ntt.LAUNCHES["ntt"]
    with pytest.raises(TypeError):
        ntt._ntt_kernel(a.long(), 3, False)
    with pytest.raises(ValueError):
        ntt._ntt_kernel(a[..., :4].contiguous(), 3, False)
    assert ntt.LAUNCHES["ntt"] == before


def _plus_q(t):
    """Canonical limbs (..., 8) -> the same residue plus q, in [q, 2q): a
    value as the lazy core may hold it."""
    v, out, carry = cuda_mont.u64(t), [], 0
    for j in range(8):
        s = v[..., j] + ((curve.Q >> (32 * j)) & M32) + carry
        out.append(s & M32)
        carry = s >> 32
    return cuda_mont.to_int32(torch.stack(out, dim=-1))


def _lifted(pt, lifts):
    """pt with coordinate k (0 X, 1 Y, 2 Z) lifted by q on each (k, lanes)."""
    out = [c.clone() for c in pt]
    for k, lanes in lifts:
        out[k][lanes] = _plus_q(out[k][lanes])
    return tuple(out)


@pytest.mark.cuda
def test_k2_k3_k4_kernels_match_plain(cuda):
    fq = g1_vec.FQ
    base = _points(1000, cuda)  # lane 1 is the identity
    # K3 and K2's single mixed add at 1000 and 2^16 points (the 1000 tiled):
    # K3's second operand is P itself on lanes 0-63 (P+P), -P on lanes
    # 64-127 (P+(-P)) and the first rotated by 3 elsewhere; K3 also on
    # coordinates lifted by q on both sides, as the lazy core holds them
    # between steps (an identity's X and Z then equal q); a few lanes
    # against the host's affine sums
    for n in (1000, 1 << 16):
        p1 = tuple(c.repeat(-(-n // 1000), 1)[:n].contiguous() for c in base)
        neg, rot = g1_vec.point_neg(p1), tuple(c.roll(3, 0) for c in p1)
        p2 = tuple(torch.cat([a[:64], b[64:128], c[128:]]) for a, b, c in zip(p1, neg, rot))
        keep = torch.ones(n, dtype=torch.bool, device=cuda)
        keep[1::1000] = False  # the identity has no affine form
        p1m = tuple(c[keep] for c in p1)
        xy = tuple(c.roll(5, 0).contiguous() for c in g1_vec.points_to_affine(p1m)[:2])
        for key, kern, plain, args in (
            ("g1_add", cuda_g1.point_add, cuda_g1.point_add_plain, (p1, p2)),
            ("g1_add_mixed", cuda_g1.point_add_mixed, cuda_g1.point_add_mixed_plain, (p1m, xy)),
        ):
            before = cuda_g1.LAUNCHES[key]
            got = kern(fq, *args)
            assert cuda_g1.LAUNCHES[key] == before + 1
            want = plain(fq, *args)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (key, n)
            if key == "g1_add":
                lanes = [0, 1, 64, 65, 128, 129, 200, n - 1]
                pts = [g1_vec.points_from_device(tuple(c[lanes] for c in p)) for p in (p1, p2)]
                assert g1_vec.points_from_device(tuple(c[lanes] for c in got)) == [
                    curve.g1_add(u, v) for u, v in zip(*pts)]
                lp1 = _lifted(p1, [(1, slice(0, 64)), (0, slice(100, 300)), (2, slice(200, 400)),
                                   (0, slice(1, None, 1000)), (2, slice(1, None, 1000))])
                lp2 = _lifted(p2, [(1, slice(64, 128)), (2, slice(150, 350)), (0, slice(500, 700))])
                for g, w in zip(cuda_g1.point_add(fq, lp1, lp2), want):
                    assert torch.equal(g, w), ("lifted", n)
    # K2's scan at C = 1 and 64 over 3 and 1000 rows, and the bucket scan's
    # smallest shape (2^14 rows x 64); the starts are the 1000 points tiled
    # (lane 1 the identity), row 0 first adds its own start (P+P), row 2
    # its start's negation (P+(-P))
    pool = tuple(torch.cat([c[:1], c[2:]]) for c in p1[:2])  # Z = 1: affine
    for m, c in ((3, 1), (3, 64), (1000, 1), (1000, 64), (1 << 14, 64)):
        idx = (torch.arange(m * c, device=cuda) * 7 + 3) % pool[0].shape[0]
        rows = tuple(t[idx].reshape(m, c, 8) for t in pool)
        rows[0][0, 0], rows[1][0, 0], rows[0][2, 0] = p1[0][0], p1[1][0], p1[0][2]
        rows[1][2, 0] = vecfield.sub(fq, torch.zeros_like(p1[1][2]), p1[1][2])
        starts = tuple(t.repeat(-(-m // 1000), 1)[:m].contiguous() for t in p1)
        before = cuda_g1.LAUNCHES["g1_add_mixed"]
        got = cuda_g1.point_scan_mixed(fq, starts, rows)
        assert cuda_g1.LAUNCHES["g1_add_mixed"] == before + 1
        for g, w in zip(got, cuda_g1.point_scan_mixed_plain(fq, starts, rows)):
            assert torch.equal(g, w), (m, c)
    # K4 at the Horner combine's shapes (a few points, 8 doublings) and at
    # 2^16 points (the 1000 tiled); lane 1 is the identity (0 : 1 : 0)
    tiled = tuple(c.repeat(66, 1)[: 1 << 16].contiguous() for c in p1)
    for n in (3, 37, 1 << 16):
        pn = tuple(c[:n] for c in tiled)
        for reps in (1, 8):
            before = cuda_g1.LAUNCHES["g1_double"]
            got = cuda_g1.point_double(fq, pn, reps)
            assert cuda_g1.LAUNCHES["g1_double"] == before + 1
            for g, w in zip(got, cuda_g1.point_double_plain(fq, pn, reps)):
                assert torch.equal(g, w), (n, reps)


def _sorted_order(windows, n, buckets, device, seed):
    """The bucket pipeline's permutation: each window's stable sort of
    random digits in [0, buckets) over n points, (windows, n) int64."""
    gen = torch.Generator().manual_seed(seed)
    digits = torch.randint(0, buckets, (windows, n), generator=gen)
    return torch.sort(digits, dim=1, stable=True)[1].to(device)


@pytest.mark.cuda
def test_k2_reads_sorted_points_in_place(cuda):
    """K2 through the sort's permutation (IndexedRows) equals K2 on the
    gathered rows src[order], bitwise: 64 windows x 512 chunks at C = 64
    from a 2^15-point source (the bucket scan of one pipeline at k >= 16);
    1,000 rows at C = 1 and 4 over an index with repeats; and 3 windows of
    44 points padded to 48 with an index to a generator row past the
    source, as msm._bucket_sums pads. Starts are the identity, and the 1,000
    points tiled (lane 1 the identity) where C < 64."""
    fq = g1_vec.FQ
    base = _points(1000, cuda)
    aff = g1_vec.points_to_affine(tuple(torch.cat([c[:1], c[2:]]) for c in base))[:2]
    src = tuple(c.repeat(33, 1)[: 1 << 15].contiguous() for c in aff)
    gen = g1_vec.points_to_device([curve.G1_GEN], device=cuda)[:2]
    rng = torch.Generator().manual_seed(3)
    cases = []
    order = _sorted_order(64, 1 << 15, 256, cuda, 1)
    cases.append((order.view(64 * 512, 64, 1), src, g1_vec.identity((64 * 512,), device=cuda)))
    for c in (1, 4):
        order = torch.randint(0, 1 << 15, (1000, c, 1), generator=rng).to(cuda)
        order[0, :, 0] = 7  # one point c times
        starts = tuple(t[:1000].contiguous() for t in base)
        cases.append((order, src, starts))
    order = torch.cat([_sorted_order(3, 44, 16, cuda, 2),
                       torch.full((3, 4), 44, dtype=torch.int64, device=cuda)], dim=1)
    padded = tuple(torch.cat([c[:44], g]) for c, g in zip(src, gen))
    cases.append((order.view(3 * 6, 8, 1), padded, g1_vec.identity((3 * 6,), device=cuda)))
    for order, (x, y), starts in cases:
        rows = cuda_g1.IndexedRows(order, x, y)
        before = cuda_g1.LAUNCHES["g1_add_mixed"]
        got = cuda_g1.point_scan_mixed(fq, starts, rows)
        assert cuda_g1.LAUNCHES["g1_add_mixed"] == before + 1
        dense = cuda_g1.point_scan_mixed(fq, starts, (x[order[..., 0]], y[order[..., 0]]))
        for g, w in zip(got, dense):
            assert torch.equal(g, w), tuple(order.shape)
        if order.shape[0] <= 1000:
            for g, w in zip(got, cuda_g1.point_scan_mixed_plain(fq, starts, rows)):
                assert torch.equal(g, w), tuple(order.shape)
    # the order's own checks: int64, (..., C, 1), contiguous, on the points'
    # device; the source 16-byte aligned
    order, (x, y), starts = cases[2]  # C = 4
    off = torch.zeros(x.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(x.shape)
    before = cuda_g1.LAUNCHES["g1_add_mixed"]
    for bad in (cuda_g1.IndexedRows(order.int(), x, y),
                cuda_g1.IndexedRows(order[..., 0], x, y),
                cuda_g1.IndexedRows(order.cpu(), x, y),
                cuda_g1.IndexedRows(order.transpose(0, 1).contiguous().transpose(0, 1), x, y),
                cuda_g1.IndexedRows(order, off, y)):
        with pytest.raises(ValueError):
            cuda_g1.point_scan_mixed(fq, starts, bad)
    assert cuda_g1.LAUNCHES["g1_add_mixed"] == before


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_arguments(cuda):
    fc = vecfield.consts(ALL_FIELDS[0])
    a = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    off = torch.zeros(4 * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(4, 8)
    before = cuda_mont.LAUNCHES["mont_mul"]
    with pytest.raises(TypeError):
        cuda_mont.mont_mul(fc, a.long(), a.long())
    with pytest.raises(ValueError):
        cuda_mont.mont_mul(fc, a.t().contiguous().t(), a)
    with pytest.raises(ValueError):
        cuda_mont.mont_mul(fc, a, a[:2])
    with pytest.raises(ValueError):  # 4 bytes past a 16-byte boundary
        cuda_mont.mont_mul(fc, off, a)
    with pytest.raises(ValueError):  # 3 rows do not divide 4 elements
        cuda_mont.mont_mul(fc, a, a[:3], "cycle")
    with pytest.raises(ValueError):
        cuda_mont.mont_mul(fc, a, a[:2], "spread")
    assert cuda_mont.LAUNCHES["mont_mul"] == before


@pytest.mark.cuda
def test_k1_reads_a_broadcast_operand_in_place(cuda):
    fc = vecfield.consts(ALL_FIELDS[1])
    # cycle (b's rows over a's leading axes) and repeat (a row per poly),
    # small and at the prover's widths
    pairs = [((1 << 14, 8), (8,)), ((3, 4099, 8), (4099, 8)), ((7, 4099, 8), (7, 1, 8)),
             ((2, 3, 37, 8), (2, 3, 1, 8)), ((37, 8), (37, 8)), ((5, 1, 8), (1, 37, 8)),
             ((1 << 20, 8), (8,)), ((4, 1 << 18, 8), (1, 1 << 18, 8)),
             ((3, 5, 1 << 16, 8), (5, 1 << 16, 8)), ((11, 95_325, 8), (11, 1, 8)),
             ((1 << 10, 1 << 10, 8), (1 << 10, 1, 8))]
    for sa, sb in pairs:
        a = mont_layout.random_elements(fc, math.prod(sa[:-1]), 6, cuda).view(sa)
        b = mont_layout.random_elements(fc, math.prod(sb[:-1]), 7, cuda).view(sb)
        want = cuda_mont.mont_mul_plain(
            fc, *[t.contiguous() for t in torch.broadcast_tensors(a, b)])
        for x, y in ((a, b), (b, a)):
            before = cuda_mont.LAUNCHES["mont_mul"]
            got = vecfield.mont_mul(fc, x, y)
            assert cuda_mont.LAUNCHES["mont_mul"] == before + 1
            assert torch.equal(got, want), (sa, sb)


@pytest.mark.cuda
def test_k1_block_size_spreads_small_launches_over_the_sms(cuda):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (1, 33, 4096, 16384, 32772, 1 << 20):
        t = cuda_build.library().h2r_mont_mul_threads(n)
        assert t in (32, 64, 128, 256), (n, t)
        assert t == 32 or -(-n // t) >= sms, (n, t)
        assert t == 256 or -(-n // (2 * t)) < sms, (n, t)


@pytest.mark.cuda
def test_k4_wrapper_rejects_bad_reps_and_other_fields(cuda):
    pts = _points(4, cuda)
    before = cuda_g1.LAUNCHES["g1_double"]
    for reps in (0, -3):
        with pytest.raises(ValueError):
            cuda_g1.point_double(g1_vec.FQ, pts, reps)
    for field in ALL_FIELDS:
        if field.p != g1_vec.FQ.field.p:
            with pytest.raises(ValueError):
                cuda_g1.point_double(vecfield.consts(field), pts)
    assert cuda_g1.LAUNCHES["g1_double"] == before


@pytest.mark.cuda
def test_k2_wrappers_reject_bad_c_other_fields_and_shapes(cuda):
    fq = g1_vec.FQ
    pts = _points(4, cuda)
    xy = tuple(c[:, None].expand(4, 3, 8).contiguous() for c in pts[:2])
    before = cuda_g1.LAUNCHES["g1_add_mixed"]
    bad = [
        (fq, pts, tuple(c[:, :0] for c in xy)),  # C = 0
        (fq, tuple(c[:3] for c in pts), xy),  # 3 starts, 4 rows
        (fq, pts, (xy[0], xy[1][:, :2].contiguous())),  # x and y of other shapes
    ] + [(vecfield.consts(f), pts, xy) for f in ALL_FIELDS if f.p != fq.field.p]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_g1.point_scan_mixed(*args)
    col = tuple(c[:, 0] for c in xy)
    for args in [(fq, tuple(c[:3] for c in pts), col), (fq, pts, (col[0], col[1][:2]))] + \
            [(vecfield.consts(f), pts, col) for f in ALL_FIELDS if f.p != fq.field.p]:
        with pytest.raises(ValueError):
            cuda_g1.point_add_mixed(*args)
    assert cuda_g1.LAUNCHES["g1_add_mixed"] == before


@pytest.mark.cuda
def test_k3_wrapper_rejects_other_fields_and_misaligned_tensors(cuda):
    pts = _points(4, cuda)
    before = cuda_g1.LAUNCHES["g1_add"]
    for field in ALL_FIELDS:
        if field.p != g1_vec.FQ.field.p:
            with pytest.raises(ValueError):
                cuda_g1.point_add(vecfield.consts(field), pts, pts)
    off = tuple(torch.zeros(8 * 4 + 1, dtype=torch.int32, device=cuda)[1:].view(4, 8)
                for _ in range(3))
    with pytest.raises(ValueError):
        cuda_g1.point_add(g1_vec.FQ, off, pts)  # 4 bytes past a 16-byte boundary
    assert cuda_g1.LAUNCHES["g1_add"] == before


def _scan_rows_input(base, rows, length):
    """(rows, length) points drawn from ``base`` (lane 1 the identity): row
    0 as drawn, row 1 one point repeated (P+P in round 0), row 2 pairs (P,
    -P) (P+(-P) in round 0), row 3 (given more than 3 rows) the identity
    throughout, the others as drawn."""
    ps = tuple(c.repeat(-(-rows * length // c.shape[0]), 1)[: rows * length]
               .reshape(rows, length, 8).contiguous() for c in base)
    odd = length // 2
    for c in ps:
        c[1] = c[1, 0].clone()
        c[2, 1::2] = c[2, 0::2][:odd].clone()
    ps[1][2, 1::2] = vecfield.sub(g1_vec.FQ, torch.zeros_like(ps[1][2, 1::2]), ps[1][2, 1::2])
    if rows > 3:
        for c, i in zip(ps, g1_vec.identity((length,), device=base[0].device)):
            c[3] = i
    return ps


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3, 128])
def test_k3_scan_kernel_matches_plain(cuda, rows):
    """Rows of 1 to 512 points, the scan and its halving tree, with the
    wrappers' cluster choice and with 1, 2, 4 and 8 blocks per row; 128 rows
    of 8 blocks are more than the card's SMs hold at once."""
    fq = g1_vec.FQ
    base = _points(600, cuda)
    for length in (1, 2, 5, 8, 255, 256, 511, 512):
        ps = _scan_rows_input(base, rows, length)
        want = {False: cuda_g1.point_scan_plain(fq, ps), True: cuda_g1.point_scan_sum_plain(fq, ps)}
        for tree, wrapper in ((False, cuda_g1.point_scan), (True, cuda_g1.point_scan_sum)):
            for cluster in (None, 1, 2, 4, 8):
                before = cuda_g1.LAUNCHES["g1_scan"]
                got = (wrapper(fq, ps) if cluster is None
                       else cuda_g1._scan_rows(fq, ps, tree, cluster))
                assert cuda_g1.LAUNCHES["g1_scan"] == before + 1
                for g, w in zip(got, want[tree]):
                    assert torch.equal(g, w), (rows, length, tree, cluster)


@pytest.mark.cuda
def test_k3_scan_wrappers_reject_long_rows_other_fields_and_bad_tensors(cuda):
    fq = g1_vec.FQ
    ps = g1_vec.identity((2, 6), device=cuda)
    off = tuple(torch.zeros(2 * 6 * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(2, 6, 8)
                for _ in range(3))
    bad = [
        (fq, g1_vec.identity((1, cuda_g1.MAX_ROW + 1), device=cuda)),
        (fq, tuple(c[0, 0] for c in ps)),  # no row axis
        (fq, (ps[0], ps[1][:, :3], ps[2])),  # coordinates of other shapes
        (fq, off),  # 4 bytes past a 16-byte boundary
    ] + [(vecfield.consts(f), ps) for f in ALL_FIELDS if f.p != fq.field.p]
    before = cuda_g1.LAUNCHES["g1_scan"]
    for args in bad:
        for fn in (cuda_g1.point_scan, cuda_g1.point_scan_sum):
            with pytest.raises(ValueError):
                fn(*args)
    with pytest.raises(RuntimeError):  # the C entry refuses a cluster of 3
        cuda_g1._scan_rows(fq, ps, False, 3)
    assert cuda_g1.LAUNCHES["g1_scan"] == before


def _splice_input(base, rows, npad, c, buckets, device):
    """within (rows, npad), incl (rows, npad / c) drawn from ``base`` (lane 1
    the identity) and ends (rows, buckets) from sorted digits: row 0 leaves
    buckets 0-6 empty (ends -1), row 1 puts every point in one bucket."""
    gen = torch.Generator().manual_seed(7)
    idx = torch.randint(0, base[0].shape[0], (rows, npad + npad // c), generator=gen).to(device)
    within = tuple(t[idx[:, :npad]] for t in base)
    incl = tuple(t[idx[:, npad:]] for t in base)
    digits = torch.randint(0, buckets, (rows, npad), generator=gen)
    digits[0] = digits[0].clamp(min=7)
    digits[1] = buckets // 2
    ds, _ = digits.sort(dim=1)
    targets = torch.arange(buckets).expand(rows, buckets).contiguous()
    ends = (torch.searchsorted(ds, targets, right=True) - 1).to(device)
    return within, incl, ends


@pytest.mark.cuda
def test_k3_splice_kernel_matches_plain(cuda):
    fq = g1_vec.FQ
    base = _points(600, cuda)
    for rows, npad, c, buckets in ((3, 40, 8, 16), (4, 512, 64, 256), (2, 4096, 64, 256),
                                   (128, 1 << 15, 64, 256)):
        within, incl, ends = _splice_input(base, rows, npad, c, buckets, cuda)
        before = cuda_g1.LAUNCHES["g1_splice"]
        got = cuda_g1.bucket_splice(fq, within, incl, ends)
        assert cuda_g1.LAUNCHES["g1_splice"] == before + 1
        for g, w in zip(got, cuda_g1.bucket_splice_plain(fq, within, incl, ends)):
            assert torch.equal(g, w), (rows, npad, c, buckets)


@pytest.mark.cuda
def test_k3_splice_wrapper_rejects_other_fields_and_bad_tensors(cuda):
    fq = g1_vec.FQ
    within, incl, ends = _splice_input(_points(40, cuda), 2, 16, 4, 8, cuda)
    off = tuple(torch.zeros(2 * 16 * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(2, 16, 8)
                for _ in range(3))
    bad = [
        (fq, off, incl, ends),  # 4 bytes past a 16-byte boundary
        (fq, within, incl, ends.cpu()),
        (fq, within, incl, ends.to(torch.int32)),
        (fq, within, tuple(c[:, :3] for c in incl), ends),  # 16 points, 3 chunks
    ] + [(vecfield.consts(f), within, incl, ends) for f in ALL_FIELDS if f.p != fq.field.p]
    before = cuda_g1.LAUNCHES["g1_splice"]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_g1.bucket_splice(*args)
    assert cuda_g1.LAUNCHES["g1_splice"] == before


def _fq_lazy_constants() -> dict:
    """q, 2q, 2^256 - q, N0INV and QTOP_RECIP as csrc/fq_lazy.cuh spells
    them."""
    with open(os.path.join(cuda_build.CSRC_DIR, "fq_lazy.cuh")) as fh:
        src = fh.read()

    def limbs(fn):
        body = re.search(r"uint32_t " + fn + r"\(int j\).*?\{(.*?)\};", src, re.S).group(1)
        words = re.findall(r"0x([0-9a-f]{8})u", body)
        assert len(words) == 8
        return sum(int(w, 16) << (32 * j) for j, w in enumerate(words))

    def const(name):
        return int(re.search(name + r" = 0x([0-9a-f]+)u;", src).group(1), 16)

    return dict(q=limbs("q"), q2=limbs("q2"), nq=limbs("nq"), n0inv=const("N0INV"),
                recip=const("QTOP_RECIP"))


def test_k4_field_core_constants_and_headroom():
    """csrc/fq_lazy.cuh's BN254 Fq constants, the bounds its comment relies
    on, and its quotient estimate at the edges: for v = c * a, a < 2q and c
    in {3, 8, 9}, v - k q must land in [0, 2q)."""
    k = _fq_lazy_constants()
    q = BN254_FQ.p
    assert k["q"] == q
    assert k["q2"] == 2 * q
    assert k["nq"] == (1 << 256) - q
    assert k["n0inv"] == vecfield.consts(BN254_FQ).n0inv32
    recip = k["recip"]
    assert recip == (1 << 59) // ((q >> 226) + 1) < 1 << 32
    assert 4 * q < 1 << 256 and 18 * q < 1 << 258 and 3 * q * (1 + (1 << 32)) < 1 << 288
    rng = random.Random(9)
    for c in (3, 8, 9):
        edges = [k * q + d for k in range(2 * c) for d in (-c, -1, 0, 1, c)]
        for v in edges + [c * (2 * q - 1)] + [c * rng.randrange(2 * q) for _ in range(200)]:
            if 0 <= v < 2 * q * c:
                k = ((v >> 226) * recip) >> 59
                assert 0 <= v - k * q < 2 * q, (c, v)


# ---------------------------------------------------------------------------
# A limb-level model of csrc/fq_lazy.cuh: each asm chain instruction by
# instruction on 32-bit limbs with the carry flag, as PTX defines add.cc,
# addc, sub.cc, subc, mad.lo/hi.cc and madc.lo/hi. An instruction without .cc
# at the end of a chain loses its carry; the model returns that carry so the
# tests can require it to be zero (or, where the chain works mod 2^256 on
# purpose, what it must be).
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
FQL = _fq_lazy_constants()


def _limbs(v):
    return [(v >> (32 * j)) & M32 for j in range(8)]


def _int(limbs):
    return sum(w << (32 * j) for j, w in enumerate(limbs))


class _Chain:
    def __init__(self):
        self.cf = 0

    def _out(self, s, cc):
        if cc:
            self.cf = s >> 32
            return s & M32
        self.lost = s >> 32
        return s & M32

    def add(self, a, b, carry_in=True, cc=True):
        return self._out(a + b + (self.cf if carry_in else 0), cc)

    def sub(self, a, b, borrow_in=True, cc=True):
        d = a - b - (self.cf if borrow_in else 0)
        if cc:
            self.cf = int(d < 0)
        return d & M32

    def mad(self, half, a, b, c, carry_in=True, cc=True):
        p = a * b
        p = p & M32 if half == "lo" else p >> 32
        return self._out(p + c + (self.cf if carry_in else 0), cc)


def _eo_mad(acc, xs, bi, top=None):
    """eo_mad (top None) or eo_mad_top; returns (acc, top, lost carry)."""
    acc, c = list(acc), _Chain()
    for j, x in enumerate(xs):
        first = j == 0
        acc[2 * j] = c.mad("lo", x, bi, acc[2 * j], carry_in=not first)
        last_hi = j == 3 and top is None
        acc[2 * j + 1] = c.mad("hi", x, bi, acc[2 * j + 1], cc=not last_hi)
    if top is not None:
        top = c.add(top, 0, cc=False)
    return acc, top, c.lost


def _eo_mul(xs, bi):
    out = []
    for x in xs:
        out += [(x * bi) & M32, (x * bi) >> 32]
    return out


def _eo_rshift(e0, o, xs, bi):
    o, c = list(o), _Chain()
    e0 = c.add(e0, o[1], carry_in=False)
    src = o[2:] + [0, 0]  # o[2..7], then the zero operand twice
    for j, x in enumerate(xs):
        o[2 * j] = c.mad("lo", x, bi, src[2 * j])
        o[2 * j + 1] = c.mad("hi", x, bi, src[2 * j + 1], cc=j < 3)
    return e0, o, c.lost


def _eo_reduce(e, o, lost):
    m = (e[0] * FQL["n0inv"]) & M32
    qs = _limbs(FQL["q"])
    o, _, l1 = _eo_mad(o, qs[1::2], m)
    e, o[7], l2 = _eo_mad(e, qs[0::2], m, top=o[7])
    assert e[0] == 0
    lost += [l1, l2]
    return e, o


def _mul(a, b, lost):
    """fq::mul on limb lists; every lost carry is appended to ``lost``."""
    od, ev = _eo_mul(a[1::2], b[0]), _eo_mul(a[0::2], b[0])
    ev, od = _eo_reduce(ev, od, lost)
    e, o = od, ev
    for i in range(1, 8):  # eo_step(e, o, a, b[i]); the arrays then swap roles
        e[0], o, l1 = _eo_rshift(e[0], o, a[1::2], b[i])
        e, o[7], l2 = _eo_mad(e, a[0::2], b[i], top=o[7])
        lost += [l1, l2]
        e, o = _eo_reduce(e, o, lost)
        e, o = o, e
    ev, od = e, o  # ev from limb 1, od from limb 0 with od[0] == 0
    c = _Chain()
    r = [c.add(ev[j], od[j + 1] if j < 7 else 0, carry_in=j > 0, cc=j < 7) for j in range(8)]
    lost.append(c.lost)
    return r


def _add(a, b, lost):
    c = _Chain()
    s = [c.add(a[j], b[j], carry_in=j > 0, cc=j < 7) for j in range(8)]
    lost.append(c.lost)
    c, q2 = _Chain(), _limbs(FQL["q2"])
    d = [c.sub(s[j], q2[j], borrow_in=j > 0) for j in range(8)]
    return s if c.cf else d


def _sub(a, b, lost):
    c = _Chain()
    r = [c.sub(a[j], b[j], borrow_in=j > 0) for j in range(8)]
    borrow, c2, q2 = c.cf, _Chain(), _limbs(FQL["q2"])
    r = [c2.add(r[j], q2[j] if borrow else 0, carry_in=j > 0, cc=j < 7) for j in range(8)]
    assert c2.lost == borrow  # the add-back of 2q wraps exactly when a < b
    return r


def _reduce_small(v):
    top = ((v[8] << 32 | v[7]) >> 2) & M32
    k = ((top * FQL["recip"]) >> 32) >> 27
    r, nq = list(v[:8]), _limbs(FQL["nq"])
    c = _Chain()  # both chains work mod 2^256: their lost carries are not checked
    for j in range(8):
        r[j] = c.mad("lo", k, nq[j], r[j], carry_in=j > 0, cc=j < 7)
    c = _Chain()
    for j in range(7):
        r[j + 1] = c.mad("hi", k, nq[j], r[j + 1], carry_in=j > 0, cc=j < 6)
    assert _int(r) == _int(v) - k * FQL["q"]
    return r


def _mul_small(cst, a, lost):
    s = 1 if cst == 3 else 3
    v = [(a[0] << s) & M32] + [((a[j] << s) | (a[j - 1] >> (32 - s))) & M32 for j in range(1, 8)]
    v.append(a[7] >> (32 - s))
    if cst != 8:
        c = _Chain()
        v = [c.add(v[j], a[j] if j < 8 else 0, carry_in=j > 0, cc=j < 8) for j in range(9)]
        lost.append(c.lost)
    return _reduce_small(v)


def _canon(a):
    c, q = _Chain(), _limbs(FQL["q"])
    d = [c.sub(a[j], q[j], borrow_in=j > 0) for j in range(8)]
    return a if c.cf else d


def _double_lazy(x, y, z, lost, seen):
    """g1_double.cu's double_lazy; every value it makes goes into ``seen``."""
    def k(v):
        seen.append(v)
        return v

    t0, t1, t2, xy = (k(_mul(a, b, lost)) for a, b in ((y, y), (y, z), (z, z), (x, y)))
    z3 = k(_mul_small(8, t0, lost))
    t2 = k(_mul_small(9, t2, lost))
    y3 = k(_add(t0, t2, lost))
    u = k(_mul_small(3, t2, lost))
    t0 = k(_sub(t0, u, lost))
    z = k(_mul(t1, z3, lost))
    u = k(_mul(t2, z3, lost))
    r = k(_mul(t0, y3, lost))
    y = k(_add(u, r, lost))
    r = k(_mul(t0, xy, lost))
    x = k(_add(r, r, lost))
    return x, y, z


def _lazy_edges(rng, n_random):
    """Values in [0, 2q): 0, 1, q - 1, q, q + 1, 2q - 1, 2q - 2, 2^254 - 1,
    2q - 1 with its low k limbs all ones, limbs of all ones where the value
    stays below 2q, and random values."""
    q = FQL["q"]
    vals = [0, 1, 2, q - 1, q, q + 1, 2 * q - 2, 2 * q - 1, (1 << 254) - 1, 1 << 253]
    for kk in range(1, 8):
        low = (1 << (32 * kk)) - 1
        v = ((2 * q - 1) >> (32 * kk) << (32 * kk)) | low
        vals.append(v if v < 2 * q else v - (1 << (32 * kk)))
        vals.append(M32 << (32 * (kk - 1)))
    vals = [v for v in vals if 0 <= v < 2 * q]
    return vals + [rng.randrange(2 * q) for _ in range(n_random)]


def test_k4_lazy_core_model_drops_no_carry_at_the_edges():
    """Every product, sum, difference and small multiple of the lazy core,
    run limb by limb on values in [0, 2q) (the edges and random values),
    lands in [0, 2q) with the right residue, and no carry its chains drop is
    ever nonzero; canon() then gives the canonical residue."""
    q, rinv = FQL["q"], pow(1 << 256, -1, FQL["q"])
    rng = random.Random(31)
    vals = _lazy_edges(rng, 40)
    pairs = [(a, b) for a in vals for b in vals] + \
        [(rng.randrange(2 * q), rng.randrange(2 * q)) for _ in range(300)]
    lost = []
    for a, b in pairs:
        la, lb = _limbs(a), _limbs(b)
        for got, want in ((_mul(la, lb, lost), a * b * rinv), (_add(la, lb, lost), a + b),
                          (_sub(la, lb, lost), a - b)):
            v = _int(got)
            assert v < 2 * q and (v - want) % q == 0, (a, b)
    for a in vals:
        for cst in (3, 8, 9):
            v = _int(_mul_small(cst, _limbs(a), lost))
            assert v < 2 * q and (v - cst * a) % q == 0, (cst, a)
        assert _int(_canon(_limbs(a))) == a % q
    assert lost and not any(lost)


def test_k4_lazy_core_model_doubles_like_the_plain_version():
    """The model of double_lazy, run reps times from canonical points and
    canonicalised once (as the kernel's store does), equals the plain
    version's reps doublings bit for bit; every intermediate stays below
    2q and no chain drops a carry."""
    fq = g1_vec.FQ
    pts = _points(6, "cpu")  # lane 1 is the identity
    ints = [[_int(row) for row in (c.to(torch.int64) & M32).tolist()] for c in pts]
    for reps in (1, 3, 8):
        want = cuda_g1.point_double_plain(fq, pts, reps)
        lost, seen = [], []
        for lane in range(6):
            x, y, z = (_limbs(c[lane]) for c in ints)
            for _ in range(reps):
                x, y, z = _double_lazy(x, y, z, lost, seen)
            for c, v in zip(want, (x, y, z)):
                assert _int(_canon(v)) == _int((c[lane].to(torch.int64) & M32).tolist()), (reps, lane)
        assert not any(lost)
        assert all(_int(v) < 2 * FQL["q"] for v in seen)


def _add_mixed_lazy(x, y, z, ax, ay, lost, seen):
    """g1_scan.cu's add_mixed_lazy; every value it makes goes into ``seen``."""
    def k(v):
        seen.append(v)
        return v

    t0, t1 = k(_mul(x, ax, lost)), k(_mul(y, ay, lost))
    t3 = k(_mul(k(_add(ax, ay, lost)), k(_add(x, y, lost)), lost))
    t3 = k(_sub(t3, k(_add(t0, t1, lost)), lost))
    t4 = k(_add(k(_mul(ay, z, lost)), y, lost))
    y3 = k(_add(k(_mul(ax, z, lost)), x, lost))
    trip0 = k(_mul_small(3, t0, lost))
    t2 = k(_mul_small(9, z, lost))
    z3 = k(_add(t1, t2, lost))
    t1 = k(_sub(t1, t2, lost))
    y3 = k(_mul_small(9, y3, lost))
    x = k(_sub(k(_mul(t3, t1, lost)), k(_mul(t4, y3, lost)), lost))
    y = k(_add(k(_mul(t1, z3, lost)), k(_mul(y3, trip0, lost)), lost))
    z = k(_add(k(_mul(z3, t4, lost)), k(_mul(trip0, t3, lost)), lost))
    return x, y, z


@pytest.mark.parametrize("steps", [1, 3, 64])
def test_k2_lazy_core_model_scans_like_the_plain_version(steps):
    """The model of add_mixed_lazy, run over each row's affine points with
    every prefix canonicalised (as the kernel's store does), equals the plain
    scan bit for bit; every intermediate stays below 2q and no chain drops a
    carry. Rows: from the identity; from P, adding P (P+P); from P, adding
    -P (P+(-P)); from the identity with Y lifted by q (a lazy start), adding
    D then -D."""
    fq = g1_vec.FQ
    pts = _points(steps + 8, "cpu")  # lane 1 is the identity; Z = 1 elsewhere
    pool = tuple(torch.cat([c[:1], c[2:]]) for c in pts[:2])
    idx = (torch.arange(4 * steps) * 5 + 2) % pool[0].shape[0]
    rows = tuple(t[idx].reshape(4, steps, 8) for t in pool)
    neg = lambda y: vecfield.sub(fq, torch.zeros_like(y), y)  # noqa: E731
    for r, lane in ((1, 0), (2, 2)):
        rows[0][r, 0], rows[1][r, 0] = pts[0][lane], pts[1][lane]
    rows[1][2, 0] = neg(pts[1][2])
    if steps > 1:
        rows[0][3, 1], rows[1][3, 1] = rows[0][3, 0], neg(rows[1][3, 0])
    starts = tuple(torch.stack([c[1], c[0], c[2], c[1]]) for c in pts)
    want = cuda_g1.point_scan_mixed_plain(fq, starts, rows)

    def ints(t):
        return [_int(limbs) for limbs in (t.to(torch.int64) & M32).tolist()]

    lost, seen = [], []
    for row in range(4):
        x, y, z = (_limbs(_int((c[row].to(torch.int64) & M32).tolist())) for c in starts)
        if row == 3:
            y = _limbs(_int(y) + FQL["q"])
        for j in range(steps):
            ax, ay = (_limbs(_int((c[row, j].to(torch.int64) & M32).tolist())) for c in rows)
            x, y, z = _add_mixed_lazy(x, y, z, ax, ay, lost, seen)
            for c, v in zip(want, (x, y, z)):
                assert _int(_canon(v)) == ints(c[row])[j], (steps, row, j)
    assert lost and not any(lost)
    assert all(_int(v) < 2 * FQL["q"] for v in seen)


def _add_lazy(x, y, z, x2, y2, z2, lost, seen):
    """g1_lazy.cuh's add_lazy; every value it makes goes into ``seen``."""
    def k(v):
        seen.append(v)
        return v

    t0, t1, t2 = (k(_mul(a, b, lost)) for a, b in ((x, x2), (y, y2), (z, z2)))
    t3 = k(_sub(k(_mul(k(_add(x, y, lost)), k(_add(x2, y2, lost)), lost)), k(_add(t0, t1, lost)),
                lost))
    t4 = k(_sub(k(_mul(k(_add(y, z, lost)), k(_add(y2, z2, lost)), lost)), k(_add(t1, t2, lost)),
                lost))
    t5 = k(_sub(k(_mul(k(_add(x, z, lost)), k(_add(x2, z2, lost)), lost)), k(_add(t0, t2, lost)),
                lost))
    trip0 = k(_mul_small(3, t0, lost))
    t2 = k(_mul_small(9, t2, lost))
    z3t = k(_add(t1, t2, lost))
    t1 = k(_sub(t1, t2, lost))
    t5 = k(_mul_small(9, t5, lost))
    x = k(_sub(k(_mul(t3, t1, lost)), k(_mul(t4, t5, lost)), lost))
    y = k(_add(k(_mul(t1, z3t, lost)), k(_mul(t5, trip0, lost)), lost))
    z = k(_add(k(_mul(z3t, t4, lost)), k(_mul(trip0, t3, lost)), lost))
    return x, y, z


def _projective(pts, zs):
    """(X, Y, Z) int32 tensors of (x z, y z, z) per affine point, (0, z, 0)
    for the identity."""
    q = curve.Q
    coords = [[0 if p is None else p[0] * z % q for p, z in zip(pts, zs)],
              [z if p is None else p[1] * z % q for p, z in zip(pts, zs)],
              [0 if p is None else z for p, z in zip(pts, zs)]]
    return tuple(vecfield.from_ints(g1_vec.FQ, c, device="cpu") for c in coords)


@pytest.mark.parametrize("lifts", [(), ((0, 1),), ((1, 2),), ((0, 2), (1, 1)),
                                   ((0, 0), (0, 2), (1, 0), (1, 2))],
                         ids=["canonical", "Y1+q", "Z2+q", "Z1+q,Y2+q", "X,Z+q both"])
def test_k3_lazy_core_model_adds_like_the_plain_version(lifts):
    """The model of add_lazy, canonicalised once (as the kernel's store
    does), equals the plain add bit for bit on P+P, the identity + Q, P+(-P),
    P + the identity, the identity + the identity and P+Q, all with random
    Z, with the coordinates of ``lifts`` ((side, coordinate) pairs) lifted
    by q on every lane (an identity's X and Z then equal q, which is 0);
    every intermediate stays below 2q and no chain drops a carry."""
    rng = random.Random(41)
    a, b, c, d, e, f = (curve.g1_mul(curve.G1_GEN, rng.randrange(1, curve.R)) for _ in range(6))
    lhs = [a, None, c, d, None, e]
    rhs = [a, b, curve.g1_neg(c), None, None, f]
    p1 = _projective(lhs, [rng.randrange(1, curve.Q) for _ in lhs])
    p2 = _projective(rhs, [rng.randrange(1, curve.Q) for _ in rhs])
    want = cuda_g1.point_add_plain(g1_vec.FQ, p1, p2)
    assert g1_vec.points_from_device(want) == [curve.g1_add(u, v) for u, v in zip(lhs, rhs)]

    def ints(t):
        return [_int(limbs) for limbs in (t.to(torch.int64) & M32).tolist()]

    sides = [[ints(t) for t in p1], [ints(t) for t in p2]]
    for side, coord in lifts:
        sides[side][coord] = [v + FQL["q"] for v in sides[side][coord]]
    lost, seen = [], []
    for lane in range(len(lhs)):
        ops = [_limbs(sides[s_][k_][lane]) for s_ in (0, 1) for k_ in range(3)]
        out = _add_lazy(*ops, lost, seen)
        assert [_int(_canon(v)) for v in out] == [ints(t)[lane] for t in want], lane
    assert lost and not any(lost)
    assert all(_int(v) < 2 * FQL["q"] for v in seen)


SASS_WITH_A_LOOP = """
\t\tFunction : _Z20h2r_g1_double_kernelPKjS0_S0_PjS1_S1_xi
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   LDG.E R4, desc[UR4][R2.64] ;    /* 0x0000000402047981 */
        /*0020*/              @!P0 BRA 0x60 ;                      /* 0x0000000000008947 */
        /*0030*/                   IMAD.WIDE.U32.X R6, P1, R4, R5, R6, P1 ;
        /*0040*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0050*/               @P0 BRA 0x30 ;
        /*0060*/                   STG.E desc[UR4][R2.64], R6 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
"""


def test_loop_split_tells_the_loop_body_from_the_rest():
    listing = cuda_build.parse_sass(SASS_WITH_A_LOOP)
    sym = cuda_build.kernel_symbol(listing, "h2r_g1_double_kernel")
    insns = listing[sym]
    assert [a for a, _, _ in insns] == list(range(0, 0x90, 0x10))
    assert insns[2] == (0x20, "BRA", "0x60")
    body, rest = cuda_build.loop_split(insns)
    assert body == {"IMAD.WIDE.U32.X": 1, "IADD3": 1, "BRA": 1}
    assert rest == {"LDC": 1, "LDG.E": 1, "BRA": 2, "STG.E": 1, "EXIT": 1}
    assert cuda_build.pipe_counts(body) == dict(fma=1, alu=1, issued=3)
    with pytest.raises(ValueError):  # no loop: only the tail's branch onto itself
        cuda_build.loop_split(insns[:2] + insns[6:])


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


@pytest.mark.cuda
def test_checker_on_the_card_matches_the_cpu(cuda):
    """The constraint checker's products go through K1 on the card; its
    counts, failing rows and report equal the CPU's, on the golden
    ``mul_mod`` circuit's witness and on a copy with gate and lookup cells
    changed (a limb with bit 31 set)."""
    from halo2_rsa_tpu_torch import golden
    from halo2_rsa_tpu_torch.circuit import checker

    b, _ = golden.build_circuit("mulmod_k10")
    compiled = checker.compile_circuit(b)
    before = cuda_mont.LAUNCHES["mont_mul"]
    assert checker.run(b) == checker.run(b, device="cpu") == dict(
        ok=True, gate_violations=0, lookup_violations=0)
    assert cuda_mont.LAUNCHES["mont_mul"] > before
    vals = list(b.values)
    vals[int(compiled.gate_idx[7, 0])] += 1
    for j, new in ((0, 1 << 31 | 5), (5, 1 << 63 | 1)):
        vals[b.lookups[j][0]] = new
    w = checker.witness_limbs(vals)
    got = checker.check(compiled, w)
    assert got == checker.check(compiled, w, device="cpu")
    assert got["gate_violations"] > 0 and got["lookup_violations"] >= 2
    assert checker.failing_gates(compiled, w, 100) == checker.failing_gates(
        compiled, w, 100, device="cpu")
    assert checker.explain(b, w, 40) == checker.explain(b, w, 40, device="cpu")


@pytest.mark.cuda
def test_keys_round_trip_on_the_card(cuda, tmp_path):
    """Keys made on the card, saved and loaded back there, equal the
    generated ones and prove the golden case's bytes."""
    from halo2_rsa_tpu_torch import golden
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.prover import kzg, plonk
    from halo2_rsa_tpu_torch.utils import serialization as ser

    meta, want = golden.load("arith_k5")
    b, pubs = golden.build_circuit("arith_k5")
    srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device=cuda)
    pk, vk = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
    ser.save_srs(srs, str(tmp_path / "srs"))
    ser.save_pk(pk, str(tmp_path / "pk"))
    ser.save_vk(vk, str(tmp_path / "vk.json"))
    srs2 = ser.load_srs(str(tmp_path / "srs.npz"))
    pk2 = ser.load_pk(str(tmp_path / "pk.npz"), srs2)
    assert pk2.device.type == "cuda"
    for key in ("id_vals", "sigma_vals", "fixed_polys", "sigma_polys", "fixed_ext",
                "sigma_ext", "l0_ext", "x_ext", "van_inv"):
        assert torch.equal(getattr(pk2, key), getattr(pk, key)), key
    for c2, c in zip(srs2.g1_powers, srs.g1_powers):
        assert torch.equal(c2, c)
    proof = plonk.prove(pk2, b.values, pubs, rng=random.Random(meta["seed"]))
    assert proof == want
    assert plonk.verify(ser.load_vk(str(tmp_path / "vk.json")), proof, pubs)


@pytest.mark.cuda
def test_dynamic_sha_proofs_of_two_lengths_under_one_key(cuda):
    """SHA-256 in its dynamic-length mode (``max_len`` 4, one block, k = 16):
    the circuits of two lengths have one fingerprint, so one key, made from
    the first; each proof verifies against its own digest bytes and not
    against a wrong one."""
    import hashlib

    from halo2_rsa_tpu_torch.circuit import Builder, checker
    from halo2_rsa_tpu_torch.fields import BN254_FR
    from halo2_rsa_tpu_torch.prover import kzg, plonk
    from halo2_rsa_tpu_torch.sha256 import Sha256Chip
    from halo2_rsa_tpu_torch.utils.serialization import circuit_fingerprint

    def circuit(msg):
        b = Builder(BN254_FR)
        _, digest_bytes, _, _ = Sha256Chip(b).digest_dynamic(msg, 4)
        for cell in digest_bytes[:4]:
            b.expose_public(cell)
        return b

    msgs = [b"ab", b"abcd"]
    builders = [circuit(m) for m in msgs]
    compiled = checker.compile_circuit(builders[0])
    assert circuit_fingerprint(compiled) == circuit_fingerprint(
        checker.compile_circuit(builders[1]))
    k = max(compiled.num_gates + 4, compiled.num_witness // 5 + 1).bit_length()
    assert k == 16
    srs = kzg.setup((1 << k) + plonk.BLIND, tau=97531, device=cuda)
    pk, vk = plonk.keygen(compiled, srs, k=k)
    for seed, (msg, b) in enumerate(zip(msgs, builders)):
        pub = list(hashlib.sha256(msg).digest()[:4])
        proof = plonk.prove(pk, b.values, pub, rng=random.Random(seed))
        assert plonk.verify(vk, proof, pub), f"length {len(msg)}"
        assert not plonk.verify(vk, proof, [pub[0] ^ 1] + pub[1:])


@pytest.mark.cuda
def test_replay_on_the_card_matches_the_cpu(cuda):
    """Batched witness replay runs its products through K1 and its
    inversion through K1-pow on the card, equal to the CPU's replay and to
    synthesis; the golden ``mul_mod`` case's replayed witness proves the
    JAX-made bytes."""
    from halo2_rsa_tpu_torch import golden
    from halo2_rsa_tpu_torch.circuit import Builder, MainGate, checker
    from halo2_rsa_tpu_torch.prover import kzg, plonk
    from halo2_rsa_tpu_torch.witness import WitnessProgram

    def circuit(x, y):
        b = Builder(ALL_FIELDS[0])
        mg = MainGate(b)
        a, c = mg.assign_value(x), mg.assign_value(y)
        mg.to_bits(mg.select(a, c, mg.is_equal(a, c)), 16)
        return b

    builders = [circuit(x, y) for x, y in ((5, 5), (3, 9), (0, 0), (65535, 1))]
    prog = WitnessProgram(builders[0])
    insts = [{i: b.values[i] for i in builders[0].input_cells()} for b in builders]
    before = dict(cuda_mont.LAUNCHES)
    w = prog.generate(insts)
    assert cuda_mont.LAUNCHES["mont_mul"] > before["mont_mul"]
    assert cuda_mont.LAUNCHES["mont_pow"] == before["mont_pow"] + 1
    assert (w == prog.generate(insts, device="cpu")).all()
    for bi, b in enumerate(builders):
        assert (w[bi] == checker.witness_limbs(b)).all()

    meta, want = golden.load("mulmod_k10")
    b, pubs = golden.build_circuit("mulmod_k10")
    w = WitnessProgram(b).generate([{i: b.values[i] for i in b.input_cells()}])
    assert (w[0] == checker.witness_limbs(b)).all()
    srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device=cuda)
    pk, _ = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
    assert plonk.prove(pk, w[0], pubs, rng=random.Random(meta["seed"])) == want

"""The blinding tails' fixed-base comb (``plonk.tail_comb``, ``plonk._add_tails``).

Each committed polynomial's head commitment gains Σ_j b_j · [τ^{n+j}]G1 for
its BLIND tail coefficients b_j. The port forms these sums on the key's
device: 4-bit digits of each b_j pick comb points, and one K3 row scan sums
[head, comb points]. Every case holds the downloaded affine point to the
host formula Σ ``curve.g1_add(acc, curve.g1_mul(g1_tail[j], b_j))``: batches
of 1, 2, 5 and 11 polys (a proof's rounds commit 11, 5 and 2 at the
flagship), random tails, all-zero tails, a zero last tail (the shape of
round 5's quotients), b = R - 1 and b = 2^252 - 1 (every digit 0xF below the
top window), and heads that are the identity. On the card the same equality
holds at the flagship's three batch shapes, and a key builds its comb once,
outside the proofs.
"""

import random
import types

import pytest
import torch

from halo2_rsa_tpu_torch.fields import vecfield
from halo2_rsa_tpu_torch.fields.field import BN254_FQ, BN254_FR
from halo2_rsa_tpu_torch.prover import curve, g1_vec, plonk
from halo2_rsa_tpu_torch.utils import profiling

torch.set_num_threads(1)

FR = vecfield.consts(BN254_FR)
FQ = vecfield.consts(BN254_FQ)
R = BN254_FR.p
BLIND = plonk.BLIND

TAILS = {
    "random": lambda rng, j: rng.randrange(R),
    "zero": lambda rng, j: 0,
    "zero_last": lambda rng, j: 0 if j == BLIND - 1 else rng.randrange(R),
    "r_minus_1": lambda rng, j: R - 1,
    "all_f": lambda rng, j: (1 << 252) - 1,
}


def _key(device, seed=11):
    """A stand-in proving key: the BLIND tail points and the comb's slot."""
    rng = random.Random(seed)
    g1_tail = [curve.g1_mul(curve.G1_GEN, rng.randrange(1, R)) for _ in range(BLIND)]
    return types.SimpleNamespace(g1_tail=g1_tail, tail_table=None, device=torch.device(device))


def _heads(host_pts, rng, device):
    """Host affine heads (None = identity) as projective tensors with a
    random Z, as an MSM leaves them."""
    x, y, z = g1_vec.points_to_device(host_pts, device=device)
    lam = vecfield.from_ints(FQ, [rng.randrange(1, BN254_FQ.p) for _ in host_pts], device=device)
    return tuple(vecfield.mont_mul(FQ, c, lam) for c in (x, y, z))


def _check_tails(key, polys: int, kind: str, identity_heads: bool, seed: int):
    rng = random.Random(seed)
    dev = key.device
    heads = [None if identity_heads else curve.g1_mul(curve.G1_GEN, rng.randrange(1, R))
             for _ in range(polys)]
    tails = [[TAILS[kind](rng, j) for j in range(BLIND)] for _ in range(polys)]
    tails_mont = vecfield.from_ints(FR, [b for row in tails for b in row], device=dev)
    got = plonk._add_tails(key, _heads(heads, rng, dev), tails_mont.reshape(polys, BLIND, -1))
    want = []
    for acc, row in zip(heads, tails):
        for j, b in enumerate(row):
            acc = curve.g1_add(acc, curve.g1_mul(key.g1_tail[j], b))
        want.append(acc)
    assert got == want


@pytest.fixture(scope="module")
def cpu_key():
    key = _key("cpu")
    plonk.tail_comb(key)
    return key


CASES = ([(p, kind, False) for kind in TAILS for p in (1, 2, 5, 11)]
         + [(1, "random", True), (5, "zero_last", True), (2, "zero", True)])


@pytest.mark.parametrize("polys,kind,identity_heads", CASES,
                         ids=[f"{p}-{k}-{'id' if i else 'pt'}" for p, k, i in CASES])
def test_device_tail_sums_equal_the_host_formula(cpu_key, polys, kind, identity_heads):
    _check_tails(cpu_key, polys, kind, identity_heads, seed=polys * 131 + len(kind))


def test_comb_entries_are_digit_multiples_of_the_window_bases(cpu_key):
    comb = plonk.tail_comb(cpu_key)
    assert plonk.tail_comb(cpu_key) is comb  # built once per key
    slots = plonk.TAIL_WINDOWS << plonk.TAIL_BITS
    assert comb.shape == (3, BLIND * slots, 8)
    picks = [(0, 0, 0), (0, 0, 1), (1, 5, 15), (3, 63, 9), (2, 17, 4)]
    idx = torch.tensor([(j * plonk.TAIL_WINDOWS + w) * 16 + d for j, w, d in picks])
    got = g1_vec.points_from_device(tuple(c[idx] for c in comb))
    want = [curve.g1_mul(cpu_key.g1_tail[j], d << (4 * w)) if d else None for j, w, d in picks]
    assert got == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the K3 row scan kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("polys", [11, 5, 2])
@pytest.mark.parametrize("kind", ["random", "zero_last", "all_f"])
def test_card_tail_sums_equal_the_host_formula(cuda, polys, kind):
    from halo2_rsa_tpu_torch.prover import cuda_g1

    key = _key(cuda)
    plonk.tail_comb(key)
    before = cuda_g1.LAUNCHES["g1_scan"]
    _check_tails(key, polys, kind, False, seed=polys)
    assert cuda_g1.LAUNCHES["g1_scan"] == before + 1


@pytest.mark.cuda
def test_card_key_builds_its_comb_once_outside_the_proofs(cuda):
    from halo2_rsa_tpu_torch import golden
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.prover import kzg

    meta, want = golden.load("arith_k5")
    b, pubs = golden.build_circuit("arith_k5")
    srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device=cuda)
    with profiling.tracing() as trace:
        pk, _ = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
        proofs = [plonk.prove(pk, b.values, pubs, rng=random.Random(meta["seed"]))
                  for _ in range(2)]
    assert proofs == [want, want]
    spans = trace.spans
    table = [s for s in spans if s.name == "commit.tails.table"]
    assert len(table) == 1 and table[0].counts == {"points": BLIND * 64 * 16}
    up, ancestors = table[0].parent, []
    while up is not None:
        ancestors.append(spans[up].name)
        up = spans[up].parent
    assert "prove" not in ancestors
    assert sum(s.name == "prove" for s in spans) == 2

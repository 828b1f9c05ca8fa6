"""``plonk.prove(..., kern=MeshKernels(mesh))`` of the PyTorch port on 2
gloo ranks on the CPU, against the JAX package's golden proofs.

Every rank sets up, keys and proves the golden k = 5 circuits
(``golden.CASES``: ``arith_k5`` and ``lookup_k5``) with the case's tau and
``rng=random.Random(seed)``, the kernels sharded over a 1-D mesh of both
ranks. At k = 5 and D = 2 every sharded branch runs (5 >= 2·1; the
extended domain 2^8; 32 >= 2·D points): no local fallback. Every rank's
proof must equal the JAX-made golden bytes (``tests/data/torch_golden_*``,
the JAX package's single-device proof), verify, and be rejected under a
wrong public input; the collectives are counted.
"""

import pytest
import torch

from halo2_rsa_tpu_torch import golden
from halo2_rsa_tpu_torch.parallel import launch, ranks

torch.set_num_threads(1)
NAMES = ("arith_k5", "lookup_k5")


@pytest.fixture(scope="module")
def proofs():
    return launch.spawn(ranks.prove_golden, 2, "gloo", device="cpu", timeout=600,
                        args=(list(NAMES),), threads=1)


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_reproduces_the_golden_proof(proofs, name):
    _, want = golden.load(name)
    for rank, out in enumerate(proofs):
        assert out[name]["proof"] == want, rank


@pytest.mark.parametrize("name", NAMES)
def test_mesh_proof_verifies_and_rejects_a_wrong_public_input(proofs, name):
    for rank, out in enumerate(proofs):
        assert out[name]["verified"] and out[name]["wrong_pub_rejected"], rank


@pytest.mark.parametrize("name", NAMES)
def test_every_kernel_ran_sharded(proofs, name):
    """Two iNTT batches, the round-3 forward and inverse four-steps (the
    extended domain's log2 is even: no rows change rank between them) and
    four MSM calls, each ending in one all-gather; no fallback."""
    for out in proofs:
        assert out[name]["fallbacks"] == {"intt_batch": 0, "msm_many": 0, "round3_t": 0}
        counts = out[name]["collectives"]
        assert counts["all_to_all"]["calls"] == 4
        assert counts["all_gather"]["calls"] == 2 + 4 + 1
        assert counts["all_reduce"]["calls"] == 0
        assert all(c["staged_bytes"] == 0 for c in counts.values())


@pytest.mark.slow
def test_four_ranks_reproduce_the_golden_proofs():
    """D = 4 (k = 5 >= 2·2): every rank's bytes equal the golden ones."""
    res = launch.spawn(ranks.prove_golden, 4, "gloo", device="cpu", timeout=1200,
                       args=(list(NAMES),), threads=1)
    for name in NAMES:
        _, want = golden.load(name)
        for rank, out in enumerate(res):
            assert out[name]["proof"] == want and out[name]["verified"], (name, rank)
            assert not any(out[name]["fallbacks"].values())


@pytest.mark.slow
def test_mulmod_k10_golden_on_two_ranks():
    """k = 10: the extended domain 2^13 has an odd log2, so round 3 moves
    rows between the ranks (``held_to_columns``'s all-to-all) between its
    two transforms; the bytes still equal the golden proof."""
    res = launch.spawn(ranks.prove_golden, 2, "gloo", device="cpu", timeout=1800,
                       args=(["mulmod_k10"],), threads=1)
    _, want = golden.load("mulmod_k10")
    for rank, out in enumerate(res):
        assert out["mulmod_k10"]["proof"] == want and out["mulmod_k10"]["verified"], rank
        assert out["mulmod_k10"]["collectives"]["all_to_all"]["calls"] == 5

"""The PyTorch port's prover on a circuit with range lookups (LogUp).

The k=5 lookup circuit (``golden.CASES["lookup_k5"]``) is proved on the CPU
with the golden case's tau and rng seed: verifying-key commitments (table
commitment included) and proof bytes must equal the JAX-made golden files
exactly; a witness whose sublimb escapes its table must not verify.
"""

import random

import pytest
import torch

from halo2_rsa_tpu_torch import golden
from halo2_rsa_tpu_torch.circuit import checker
from halo2_rsa_tpu_torch.prover import kzg, plonk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    meta, want = golden.load("lookup_k5")
    b, pubs = golden.build_circuit("lookup_k5")
    compiled = checker.compile_circuit(b)
    srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device="cpu")
    pk, vk = plonk.keygen(compiled, srs, k=meta["k"])
    proof = plonk.prove(pk, b.values, pubs, rng=random.Random(meta["seed"]))
    return dict(meta=meta, want=want, b=b, pubs=pubs, compiled=compiled, pk=pk, vk=vk, proof=proof)


def test_lookup_vk_matches_golden(case):
    vk, meta = case["vk"], case["meta"]
    assert case["compiled"].lookup_groups, "the circuit has lookups"
    assert list(vk.lookup_bits) == meta["vk"]["lookup_bits"]
    for key in ("fixed_commitments", "sigma_commitments", "table_commitments"):
        assert golden.points_to_json(getattr(vk, key)) == meta["vk"][key], key


def test_lookup_proof_bytes_match_golden(case):
    assert len(case["proof"]) == case["meta"]["proof_len"]
    assert case["proof"] == case["want"]
    assert plonk.verify(case["vk"], case["proof"], case["pubs"], device="cpu")
    assert not plonk.verify(case["vk"], case["proof"], [case["pubs"][0] + 1], device="cpu")


def test_out_of_table_witness_rejected(case):
    bits, idx = case["compiled"].lookup_groups[0]
    bad = list(case["b"].values)
    bad[int(idx[0])] += 1 << bits  # a sublimb escapes its table
    proof = plonk.prove(case["pk"], bad, case["pubs"], rng=random.Random(1))
    assert not plonk.verify(case["vk"], proof, case["pubs"], device="cpu")

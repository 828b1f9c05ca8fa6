"""The PyTorch port's prover as a whole against the JAX package.

Fast tier: the k=5 arithmetic circuit (``golden.CASES["arith_k5"]``) is set
up, keyed and proved on the CPU with the golden case's tau and rng seed;
its verifying-key commitments and its proof bytes must equal the
JAX-made golden files exactly, and the JAX package's ``plonk.verify`` must
accept the port's proof and reject a wrong public input.

Slow tier: the k=10 ``mul_mod`` golden case, and a live JAX prove compared
byte for byte with the port's prove from the same proving key carried
across by ``convert``.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.prover import plonk as jplonk
from halo2_rsa_tpu_torch import golden
from halo2_rsa_tpu_torch.circuit import checker
from halo2_rsa_tpu_torch.prover import kzg, plonk

torch.set_num_threads(1)


def _prove_golden(name):
    meta, want = golden.load(name)
    b, pubs = golden.build_circuit(name)
    srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device="cpu")
    pk, vk = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
    proof = plonk.prove(pk, b.values, pubs, rng=random.Random(meta["seed"]))
    return dict(meta=meta, want=want, pubs=pubs, vk=vk, proof=proof, builder=b, pk=pk)


def _check_vk(case):
    for key in ("fixed_commitments", "sigma_commitments", "table_commitments", "pub_rows"):
        got = getattr(case["vk"], key)
        want = case["meta"]["vk"][key]
        assert (golden.points_to_json(got) if key != "pub_rows" else got) == want, key
    assert list(case["vk"].lookup_bits) == case["meta"]["vk"]["lookup_bits"]


def _reference_vk(vk):
    """The JAX package's VerifyingKey holding the port's (host) vk data."""
    return jplonk.VerifyingKey(**{f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)})


@pytest.fixture(scope="module")
def arith():
    return _prove_golden("arith_k5")


def test_vk_commitments_match_golden(arith):
    _check_vk(arith)


def test_proof_bytes_match_golden(arith):
    assert len(arith["proof"]) == arith["meta"]["proof_len"] == 1280
    assert arith["proof"] == arith["want"]


def test_port_verify_accepts_and_rejects(arith):
    pubs = arith["pubs"]
    assert plonk.verify(arith["vk"], arith["proof"], pubs, device="cpu")
    assert not plonk.verify(arith["vk"], arith["proof"], [pubs[0] + 1], device="cpu")
    bad = bytearray(arith["proof"])
    bad[7] ^= 1
    assert not plonk.verify(arith["vk"], bytes(bad), pubs, device="cpu")


def test_reference_verify_accepts_port_proof(arith):
    jvk = _reference_vk(arith["vk"])
    assert jplonk.verify(jvk, arith["proof"], arith["pubs"])
    assert not jplonk.verify(jvk, arith["proof"], [arith["pubs"][0] + 1])


def test_blinding_draws_match_reference():
    for seed in (1, 2):
        got = plonk._rand_blind(3, random.Random(seed), "cpu")
        want = jplonk._rand_blind(3, random.Random(seed))
        from halo2_rsa_tpu_torch.fields import vecfield

        assert np.array_equal(vecfield.limbs_to_ref(got), np.asarray(want))


def test_host_helpers_match_reference():
    for w in (5, 6, 7, 8, 11, 12):
        assert plonk._perm_chunks(w) == jplonk._perm_chunks(w)
        assert plonk._perm_ident_degree(w) == jplonk._perm_ident_degree(w)
        assert plonk._coset_ids(w, 10) == jplonk._coset_ids(w, 10)
    src = np.random.default_rng(6).integers(-1, 9, size=(6, 16)).astype(np.int32)
    assert np.array_equal(plonk._sigma_cells(src), jplonk._sigma_cells(src))


@pytest.mark.slow
def test_golden_mulmod_k10():
    case = _prove_golden("mulmod_k10")
    _check_vk(case)
    assert case["proof"] == case["want"]
    assert plonk.verify(case["vk"], case["proof"], case["pubs"], device="cpu")


@pytest.mark.slow
def test_live_jax_prove_matches_port_from_converted_pk():
    from halo2_rsa_tpu.bigint import BigIntChip
    from halo2_rsa_tpu.circuit import Builder, MainGate, RangeChip
    from halo2_rsa_tpu.circuit import checker as jchecker
    from halo2_rsa_tpu.fields import BN254_FR
    from halo2_rsa_tpu.prover import kzg as jkzg
    from halo2_rsa_tpu_torch import convert

    classes = dict(Builder=Builder, MainGate=MainGate, RangeChip=RangeChip,
                   BigIntChip=BigIntChip, field=BN254_FR)
    b, pubs = golden.build_circuit("lookup_k5", classes)
    srs = jkzg.setup(1 << 7, tau=424242)
    jpk, jvk = jplonk.keygen(jchecker.compile_circuit(b), srs, k=5)
    want = jplonk.prove(jpk, b.values, pubs, rng=random.Random(77))
    pk = convert.proving_key(jpk, device="cpu")
    got = plonk.prove(pk, b.values, pubs, rng=random.Random(77))
    assert got == want
    assert plonk.verify(convert.verifying_key(jvk), got, pubs, device="cpu")

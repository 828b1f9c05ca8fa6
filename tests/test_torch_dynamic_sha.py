"""The port's PKCS#1 v1.5 circuit with SHA-256 in its dynamic-length mode
(``Pkcs1v15Circuit.build(..., max_len=...)``), on the CPU.

One trace serves every message of at most ``max_len`` bytes: the circuits of
lengths 0, 55, 64 and 100 under ``max_len`` = 100 compile to the same gates,
coefficients, lookups and instance cells, so to one ``circuit_fingerprint``
and one key, and each satisfies the checker. The circuit equals, value for
value and in its compile, the JAX package's composition of the same chips
and the benchmark's frozen reference (``refimpl/synth/pipeline_dynamic``). A
witness whose length cell or padding byte is overwritten fails the checker.
Proofs of two lengths under one key are made on the card
(``test_torch_kernels_cuda.py``): one SHA-256 block is already k = 16, whose
keygen and proofs take over an hour on the CPU.
"""

import hashlib
import os
import random
import sys

import numpy as np
import pytest
import torch

from halo2_rsa_tpu import rsa as jrsa
from halo2_rsa_tpu.circuit import Builder as JBuilder
from halo2_rsa_tpu.circuit import checker as jchecker
from halo2_rsa_tpu.fields import BN254_FR as JFR
from halo2_rsa_tpu.rsa.verifier import RSASignatureVerifier as JVerifier
from halo2_rsa_tpu.sha256 import Sha256Chip as JSha256Chip
from halo2_rsa_tpu_torch import pipelines as tpipe
from halo2_rsa_tpu_torch.circuit import checker
from halo2_rsa_tpu_torch.fields import vecfield
from halo2_rsa_tpu_torch.sha256 import Sha256Chip
from halo2_rsa_tpu_torch.utils.serialization import circuit_fingerprint

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
BITS, MAX_LEN = 1024, 100
LENGTHS = (0, 55, 64, 100)


def _signed(length: int) -> tuple:
    """(msg, n, sig): one key for every length (the same seed), a message of
    ``length`` bytes."""
    msg = bytes(random.Random(length).randrange(256) for _ in range(length))
    n, sig = tpipe.sign_fixture(BITS, msg, rng=random.Random(11))
    return msg, n, sig


@pytest.fixture(scope="module")
def circuits():
    """{length: (msg, n, sig, circuit, the chip's (words, bytes, msg cells,
    len cell))}."""
    out = {}
    real = Sha256Chip.digest_dynamic
    for length in LENGTHS:
        msg, n, sig = _signed(length)
        seen = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Sha256Chip, "digest_dynamic",
                       lambda self, m, ml: seen.append(real(self, m, ml)) or seen[-1])
            circ = tpipe.Pkcs1v15Circuit.build(BITS, n, sig, msg=msg, max_len=MAX_LEN)
        out[length] = (msg, n, sig, circ, seen[0])
    return out


def _compile_equal(a, b, b_coef=None) -> None:
    """The compiles agree; ``b_coef``: b's coefficient table in a's layout."""
    assert a.num_witness == b.num_witness and a.num_gates == b.num_gates
    assert np.array_equal(a.gate_idx, b.gate_idx)
    assert np.array_equal(a.gate_coef_id, b.gate_coef_id)
    assert np.array_equal(a.coef_table, b.coef_table if b_coef is None else b_coef)
    assert np.array_equal(a.instance_idx, b.instance_idx)
    assert [x for x, _ in a.lookup_groups] == [x for x, _ in b.lookup_groups]
    for (_, i), (_, j) in zip(a.lookup_groups, b.lookup_groups):
        assert np.array_equal(i, j)


def test_one_trace_for_every_length(circuits):
    compiled = {length: c[3].compile() for length, c in circuits.items()}
    first = compiled[LENGTHS[0]]
    for length in LENGTHS[1:]:
        _compile_equal(compiled[length], first)
    prints = {circuit_fingerprint(c) for c in compiled.values()}
    shape = tpipe.Pkcs1v15Circuit.without_witness(BITS, max_len=MAX_LEN).compile()
    assert prints == {circuit_fingerprint(shape)}
    _compile_equal(shape, first)
    # a fixed-length circuit of the same message is another trace
    msg, n, sig = _signed(55)
    assert circuit_fingerprint(tpipe.Pkcs1v15Circuit.build(BITS, n, sig, msg=msg).compile()) \
        not in prints


@pytest.mark.parametrize("length", LENGTHS)
def test_checker_passes_and_public_inputs_are_n_then_digest(circuits, length):
    msg, n, sig, circ, _ = circuits[length]
    assert circ.public_inputs == tpipe._n_limbs(n, BITS) + list(hashlib.sha256(msg).digest())
    report = checker.run(circ.builder, circ.public_inputs, device="cpu")
    assert report["ok"], report


def test_equals_the_jax_composition(circuits):
    msg, n, sig, circ, _ = circuits[55]
    b = JBuilder(JFR)
    rsa_chip = jrsa.RSAChip(b, BITS, tpipe.EXP_LIMB_BITS)
    pk = rsa_chip.assign_public_key(jrsa.RSAPublicKey(n, jrsa.RSAPubE.fix(jrsa.DEFAULT_E)))
    sig_a = rsa_chip.assign_signature(jrsa.RSASignature(sig))
    verifier = JVerifier(rsa_chip, JSha256Chip(b))
    is_valid, hashed_bytes = verifier.verify_pkcs1v15_signature(pk, msg, sig_a, max_len=MAX_LEN)
    rsa_chip.main_gate.assert_one(is_valid)
    for cell in list(pk.n.limbs) + list(hashed_bytes):
        b.expose_public(cell)
    assert circ.builder.values == b.values
    tc, jc = circ.compile(), jchecker.compile_circuit(b)
    _compile_equal(tc, jc, vecfield.limbs_from_ref(jc.coef_table))
    assert np.array_equal(vecfield.limbs_to_ref(checker.witness_limbs(circ.builder)),
                          jchecker.witness_limbs(list(b.values)))


def test_equals_the_benchmark_reference(circuits):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from refimpl.synth import pipeline_dynamic

    for length in (0, 100):
        msg, n, sig, circ, _ = circuits[length]
        rb, pubs = pipeline_dynamic.build(BITS, n, sig, msg, MAX_LEN)
        assert pubs == circ.public_inputs
        assert rb.values == circ.builder.values
        assert rb.gate_idx == circ.builder.gate_idx and rb.gate_coef == circ.builder.gate_coef
        assert rb.lookups == circ.builder.lookups and rb.instance == circ.builder.instance


@pytest.mark.parametrize("where", ["length", "0x80", "zero padding"])
def test_an_overwritten_length_or_padding_byte_fails(circuits, where):
    msg, _, _, circ, (_, _, msg_cells, len_cell) = circuits[55]
    values = list(circ.builder.values)
    cell, value = {"length": (len_cell, len(msg) + 1), "0x80": (msg_cells[55], 0),
                   "zero padding": (msg_cells[70], 7)}[where]
    assert values[cell.idx] != value
    values[cell.idx] = value
    report = checker.check(circ.compile(), checker.witness_limbs(values), device="cpu")
    assert not report["ok"], report


def test_without_witness_takes_one_mode():
    with pytest.raises(ValueError, match="not both"):
        tpipe.Pkcs1v15Circuit.without_witness(BITS, msg_len=MAX_LEN, max_len=MAX_LEN)

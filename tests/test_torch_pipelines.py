"""The PyTorch port's circuit front end against the JAX package.

``sign_fixture`` (plain Python, no ``cryptography``) must give valid
PKCS#1 v1.5 / SHA-256 signatures, reproducibly from a seed; the RSA-1024
SHA-disabled flagship circuit built and compiled by the port must equal the
JAX package's compile of the same inputs exactly (gate wiring, coefficient
table after the limb-layout conversion, lookups, public inputs), and the
witness limbs must agree.
"""

import hashlib
import random

import numpy as np
import pytest

from halo2_rsa_tpu import pipelines as jpipe
from halo2_rsa_tpu.circuit import checker as jchecker
from halo2_rsa_tpu_torch import pipelines as tpipe
from halo2_rsa_tpu_torch.circuit import checker as tchecker
from halo2_rsa_tpu_torch.fields import vecfield


def _emsa(bits, msg):
    k = bits // 8
    t = tpipe.SHA256_DIGEST_INFO + hashlib.sha256(msg).digest()
    return int.from_bytes(b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t, "big")


@pytest.mark.parametrize("bits", [1024, 2048])
def test_sign_fixture_is_valid_pkcs1v15(bits):
    msg = b"halo2-rsa port"
    n, sig = tpipe.sign_fixture(bits, msg, rng=random.Random(bits))
    assert n.bit_length() == bits
    assert pow(sig, 65537, n) == _emsa(bits, msg)
    assert (n, sig) == tpipe.sign_fixture(bits, msg, rng=random.Random(bits))


@pytest.fixture(scope="module")
def flagship():
    msg = bytes(random.Random(7).randrange(256) for _ in range(32))
    n, sig = tpipe.sign_fixture(1024, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    port = tpipe.Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed)
    ref = jpipe.Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed)
    return port, ref


def test_flagship_circuit_compiles_like_reference(flagship):
    port, ref = flagship
    assert port.public_inputs == ref.public_inputs
    assert port.builder.values == ref.builder.values
    tc, jc = port.compile(), ref.compile()
    assert tc.num_witness == jc.num_witness and tc.num_gates == jc.num_gates == 22310
    assert np.array_equal(tc.gate_idx, jc.gate_idx)
    assert np.array_equal(tc.gate_coef_id, jc.gate_coef_id)
    assert np.array_equal(tc.coef_table, vecfield.limbs_from_ref(jc.coef_table))
    assert np.array_equal(tc.instance_idx, jc.instance_idx)
    assert [b for b, _ in tc.lookup_groups] == [b for b, _ in jc.lookup_groups]
    for (_, ti), (_, ji) in zip(tc.lookup_groups, jc.lookup_groups):
        assert np.array_equal(ti, ji)
    assert (tc.num_gates + 20).bit_length() == 15


def test_witness_limbs_match_reference(flagship):
    port, _ = flagship
    vals = port.builder.values
    got = tchecker.witness_limbs(port.builder)
    assert np.array_equal(vecfield.limbs_to_ref(got), jchecker.witness_limbs(list(vals)))


def test_without_witness_has_the_same_shape(flagship):
    port, _ = flagship
    shape = tpipe.Pkcs1v15Circuit.without_witness(1024).compile()
    tc = port.compile()
    assert np.array_equal(shape.gate_idx, tc.gate_idx)
    assert np.array_equal(shape.coef_table, tc.coef_table)

"""The PKCS#1 v1.5 verification circuit, as ``Pkcs1v15Circuit.build`` of the
port's ``pipelines.py`` synthesises it (frozen copy)."""

from __future__ import annotations

import hashlib

from .circuit import Builder
from .fields import BN254_FR
from .rsa import DEFAULT_E, RSAChip, RSAPubE, RSAPublicKey, RSASignature
from .rsa.verifier import RSASignatureVerifier
from .sha256 import Sha256Chip

EXP_LIMB_BITS = 5
LIMB_WIDTH = 64


def n_limbs(x: int, bits: int) -> list:
    return [(x >> (LIMB_WIDTH * i)) & ((1 << LIMB_WIDTH) - 1) for i in range(bits // LIMB_WIDTH)]


def public_inputs(bits: int, n: int, msg: bytes, sha_in_circuit: bool) -> list:
    """The public inputs of one request: n's limbs, then the digest's bytes
    (SHA-256 in the circuit) or its four 64-bit limbs (a pre-hashed digest)."""
    digest = hashlib.sha256(msg).digest()
    if sha_in_circuit:
        return n_limbs(n, bits) + list(digest)
    return n_limbs(n, bits) + n_limbs(int.from_bytes(digest, "big"), 256)


def build(bits: int, n: int, sig: int, msg: bytes | None = None,
          hashed_msg: int | None = None) -> tuple:
    """(builder, public inputs): with ``msg`` SHA-256 in the circuit, with
    ``hashed_msg`` a pre-hashed digest (the SHA-disabled shape)."""
    b = Builder(BN254_FR)
    rsa_chip = RSAChip(b, bits, EXP_LIMB_BITS)
    pk = rsa_chip.assign_public_key(RSAPublicKey(n, RSAPubE.fix(DEFAULT_E)))
    sig_a = rsa_chip.assign_signature(RSASignature(sig))
    if msg is not None:
        verifier = RSASignatureVerifier(rsa_chip, Sha256Chip(b))
        is_valid, hashed_bytes = verifier.verify_pkcs1v15_signature(pk, msg, sig_a)
        rsa_chip.main_gate.assert_one(is_valid)
        for limb in pk.n.limbs:
            b.expose_public(limb)
        for cell in hashed_bytes:
            b.expose_public(cell)
        pubs = n_limbs(n, bits) + list(hashlib.sha256(msg).digest())
    else:
        assert hashed_msg is not None
        hashed = rsa_chip.bigint_chip.assign_integer(hashed_msg, num_limbs=4)
        is_valid = rsa_chip.verify_pkcs1v15_signature(pk, hashed, sig_a)
        rsa_chip.main_gate.assert_one(is_valid)
        for limb in pk.n.limbs:
            b.expose_public(limb)
        for limb in hashed.limbs:
            b.expose_public(limb)
        pubs = n_limbs(n, bits) + n_limbs(hashed_msg, 256)
    return b, pubs

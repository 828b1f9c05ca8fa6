"""The PKCS#1 v1.5 verification circuit with SHA-256 in its dynamic-length
mode, as ``Pkcs1v15Circuit.build(..., max_len=...)`` of the port's
``pipelines.py`` synthesises it (frozen copy): one trace for every message
of at most ``max_len`` bytes, the length a private witness."""

from __future__ import annotations

from . import pipeline
from .circuit import Builder
from .fields import BN254_FR
from .rsa import DEFAULT_E, RSAChip, RSAPubE, RSAPublicKey, RSASignature
from .rsa.verifier import RSASignatureVerifier
from .sha256 import Sha256Chip


def build(bits: int, n: int, sig: int, msg: bytes, max_len: int) -> tuple:
    """(builder, public inputs): n's limbs, then the digest's 32 bytes, as
    ``pipeline.public_inputs(..., sha_in_circuit=True)`` gives them."""
    b = Builder(BN254_FR)
    rsa_chip = RSAChip(b, bits, pipeline.EXP_LIMB_BITS)
    pk = rsa_chip.assign_public_key(RSAPublicKey(n, RSAPubE.fix(DEFAULT_E)))
    sig_a = rsa_chip.assign_signature(RSASignature(sig))
    verifier = RSASignatureVerifier(rsa_chip, Sha256Chip(b))
    is_valid, hashed_bytes = verifier.verify_pkcs1v15_signature(pk, msg, sig_a, max_len=max_len)
    rsa_chip.main_gate.assert_one(is_valid)
    for limb in pk.n.limbs:
        b.expose_public(limb)
    for cell in hashed_bytes:
        b.expose_public(cell)
    return b, pipeline.public_inputs(bits, n, msg, True)

"""High-level end-to-end pipelines (the examples/bench surface).

Counterpart of ``halo2_rsa_tpu/pipelines.py``: the PKCS#1 v1.5 verification
circuit (with SHA-256 in the circuit, or on a pre-hashed digest — the
SHA-disabled flagship shape) and a signing fixture. ``sign_fixture`` is plain
Python (seeded Miller–Rabin primes, EMSA-PKCS1-v1_5 over SHA-256), so
nothing here needs the ``cryptography`` package. Each instance can be
checked with the constraint checker (``check``, on the card unless the caller
asks for the CPU) and proven/verified with the PLONK-KZG backend.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import random

from .circuit import Builder, checker
from .fields import BN254_FR
from .rsa import DEFAULT_E, RSAChip, RSAPubE, RSAPublicKey, RSASignature
from .rsa.verifier import RSASignatureVerifier
from .sha256 import Sha256Chip
from .utils.profiling import count, span

EXP_LIMB_BITS = 5
LIMB_WIDTH = 64

# DER DigestInfo prefix of SHA-256 (RFC 8017 §9.2, note 1)
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


@dataclasses.dataclass
class Pkcs1v15Circuit:
    """One synthesized pkcs1v15 verification instance."""

    builder: Builder
    public_inputs: list
    bits: int

    @classmethod
    def build(
        cls,
        bits: int,
        n: int,
        sig: int,
        msg: bytes | None = None,
        hashed_msg: int | None = None,
        expose_public: bool = True,
        max_len: int | None = None,
    ) -> "Pkcs1v15Circuit":
        """With ``msg``: full SHA-256 + verify. With ``hashed_msg``: verify a
        pre-hashed digest (the SHA-disabled flagship shape). With ``msg`` and
        ``max_len``, SHA-256 runs in its dynamic-length mode: one trace, so
        one key, for every message of at most ``max_len`` bytes; the length
        stays private and the public inputs are those of the fixed mode.
        Span ``synth`` (count ``cells``)."""
        with span("synth"):
            b = Builder(BN254_FR)
            rsa_chip = RSAChip(b, bits, EXP_LIMB_BITS)
            pk = rsa_chip.assign_public_key(RSAPublicKey(n, RSAPubE.fix(DEFAULT_E)))
            sig_a = rsa_chip.assign_signature(RSASignature(sig))
            pubs = []
            if msg is not None:
                verifier = RSASignatureVerifier(rsa_chip, _TracedSha256Chip(b))
                is_valid, hashed_bytes = verifier.verify_pkcs1v15_signature(
                    pk, msg, sig_a, max_len=max_len
                )
                rsa_chip.main_gate.assert_one(is_valid)
                if expose_public:
                    for limb in pk.n.limbs:
                        b.expose_public(limb)
                    for cell in hashed_bytes:
                        b.expose_public(cell)
                    digest = hashlib.sha256(msg).digest()
                    pubs = _n_limbs(n, bits) + list(digest)
            else:
                assert hashed_msg is not None and max_len is None
                hashed = rsa_chip.bigint_chip.assign_integer(hashed_msg, num_limbs=4)
                is_valid = rsa_chip.verify_pkcs1v15_signature(pk, hashed, sig_a)
                rsa_chip.main_gate.assert_one(is_valid)
                if expose_public:
                    for limb in pk.n.limbs:
                        b.expose_public(limb)
                    for limb in hashed.limbs:
                        b.expose_public(limb)
                    pubs = _n_limbs(n, bits) + _n_limbs(hashed_msg, 256)
            count(cells=b.num_witness)
        return cls(builder=b, public_inputs=pubs, bits=bits)

    @classmethod
    def without_witness(
        cls, bits: int, msg_len: int | None = None, expose_public: bool = True,
        max_len: int | None = None,
    ) -> "Pkcs1v15Circuit":
        """Witness-free instance for keygen: the same trace shape as any real
        instance of the same (bits, msg_len) config, from dummy values. With
        ``max_len`` instead of ``msg_len``, the trace of every message of at
        most ``max_len`` bytes."""
        if msg_len is not None and max_len is not None:
            raise ValueError("give msg_len (fixed-length SHA-256) or max_len (dynamic), not both")
        dummy_pk = RSAPublicKey.without_witness(bits)
        if msg_len is not None or max_len is not None:
            return cls.build(
                bits, dummy_pk.n, 0, msg=b"\x00" * (msg_len or 0),
                expose_public=expose_public, max_len=max_len,
            )
        return cls.build(bits, dummy_pk.n, 0, hashed_msg=0, expose_public=expose_public)

    def check(self, device="cuda") -> dict:
        """MockProver-analog constraint check on ``device``."""
        return checker.run(self.builder, self.public_inputs, device=device)

    def compile(self):
        return checker.compile_circuit(self.builder)


class _TracedSha256Chip(Sha256Chip):
    """The SHA-256 chip with its dynamic mode under the span
    ``sha256.dynamic`` (counts ``blocks``, the blocks compressed, and
    ``bytes``, the message's length). The chip's own module is carried
    unchanged from the JAX package, so the span is added here."""

    def digest_dynamic(self, msg: bytes, max_len: int):
        with span("sha256.dynamic", blocks=self.num_blocks(max_len), bytes=len(msg)):
            return super().digest_dynamic(msg, max_len)


def _n_limbs(x: int, bits: int) -> list:
    return [(x >> (LIMB_WIDTH * i)) & ((1 << LIMB_WIDTH) - 1) for i in range(bits // LIMB_WIDTH)]


_SMALL_PRIMES = [p for p in range(3, 1000, 2) if all(p % q for q in range(3, int(p ** 0.5) + 1, 2))]


def _is_probable_prime(n: int, rng, rounds: int = 40) -> bool:
    """Miller–Rabin with ``rounds`` bases drawn from ``rng``."""
    if n < 2:
        return False
    for q in [2] + _SMALL_PRIMES:
        if n % q == 0:
            return n == q
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int, e: int, rng) -> int:
    """A prime of exactly ``bits`` bits (top two bits set) with gcd(e, p-1) = 1."""
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if math.gcd(e, c - 1) == 1 and _is_probable_prime(c, rng):
            return c


def sign_fixture(bits: int, msg: bytes, rng=None):
    """An RSA key of ``bits`` bits (e = 65537) and its PKCS#1 v1.5 / SHA-256
    signature of ``msg``: returns (n, sig). ``rng`` (random.Random) makes the
    key reproducible; default OS entropy."""
    rng = rng if rng is not None else random.SystemRandom()
    e = DEFAULT_E
    while True:
        p = _random_prime(bits // 2, e, rng)
        q = _random_prime(bits - bits // 2, e, rng)
        n = p * q
        if p != q and n.bit_length() == bits:
            break
    d = pow(e, -1, math.lcm(p - 1, q - 1))
    k = (bits + 7) // 8
    t = SHA256_DIGEST_INFO + hashlib.sha256(msg).digest()
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    sig = pow(int.from_bytes(em, "big"), d, n)
    assert pow(sig, e, n) == int.from_bytes(em, "big")
    return n, sig

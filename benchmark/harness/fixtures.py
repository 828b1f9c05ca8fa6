"""Frozen copies of the program's traffic helpers, so that a later change to
the program cannot move the traffic: ``pipelines.sign_fixture`` (an RSA key
from seeded Miller-Rabin primes and its PKCS#1 v1.5 / SHA-256 signature) and
``chip_smoke.corrupt`` (a witness with gate and lookup cells overwritten).
``keypair`` and ``sign`` are ``sign_fixture``'s two halves, so that one key
signs many messages."""

from __future__ import annotations

import hashlib
import math

DEFAULT_E = 65537
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_SMALL_PRIMES = [p for p in range(3, 1000, 2) if all(p % q for q in range(3, int(p ** 0.5) + 1, 2))]


def _is_probable_prime(n: int, rng, rounds: int = 40) -> bool:
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
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if math.gcd(e, c - 1) == 1 and _is_probable_prime(c, rng):
            return c


def keypair(bits: int, rng) -> tuple:
    """(n, d) of an RSA key of ``bits`` bits with e = 65537."""
    e = DEFAULT_E
    while True:
        p = _random_prime(bits // 2, e, rng)
        q = _random_prime(bits - bits // 2, e, rng)
        n = p * q
        if p != q and n.bit_length() == bits:
            break
    return n, pow(e, -1, math.lcm(p - 1, q - 1))


def sign(n: int, d: int, bits: int, msg: bytes) -> int:
    """The PKCS#1 v1.5 signature of SHA-256(msg)."""
    k = (bits + 7) // 8
    t = SHA256_DIGEST_INFO + hashlib.sha256(msg).digest()
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    sig = pow(int.from_bytes(em, "big"), d, n)
    assert pow(sig, DEFAULT_E, n) == int.from_bytes(em, "big")
    return sig


def sign_fixture(bits: int, msg: bytes, rng) -> tuple:
    n, d = keypair(bits, rng)
    return n, sign(n, d, bits, msg)


def corrupt(builder, rng, values=None, gates: int = 3, lookups: int = 3) -> list:
    """A copy of ``values`` (default the builder's) with ``gates`` cells of
    gate rows set to random canonical values and ``lookups`` lookup cells set
    to 2^bits, 2^31 + 5 (bit 31 of limb 0 set) and 2^63 + 1 in turn; ``rng``
    is a numpy Generator."""
    import numpy as np

    p = builder.field.p
    vals = list(builder.values if values is None else values)
    for c in rng.choice(np.unique(np.asarray(builder.gate_idx)), gates, replace=False):
        vals[int(c)] = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % p
    for i, j in enumerate(rng.choice(len(builder.lookups), lookups, replace=False)):
        cell, bits = builder.lookups[int(j)]
        vals[cell] = (1 << bits, 1 << 31 | 5, 1 << 63 | 1)[i % 3]
    return vals

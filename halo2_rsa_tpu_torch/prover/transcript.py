"""Blake2b Fiat–Shamir transcript.

Structural equivalent of halo2's ``Blake2bWrite``/``Blake2bRead`` +
``Challenge255`` (used at halo2-rsa `benches/bench.rs:320-343`). The
absorb/squeeze convention is this framework's own (the reference's exact byte
layout is an implementation detail of the Rust stack); prover and verifier
here share it exactly, which is what soundness requires.

Encoding: G1 points as 32 COMPRESSED bytes — x little-endian with the
y-parity bit stored in the top bit of byte 31 (q is 254 bits, so bits
254/255 are free), infinity = all zeros (unambiguous: x=0 is off-curve
since 3 is a non-residue mod q). This matches halo2curves' compressed
``G1Affine`` wire size (halo2 ``Blake2bWrite``/``Challenge255`` writes
compressed points, halo2-rsa `benches/bench.rs:320-343`). Fr scalars
as 32 bytes little-endian. Challenges: blake2b-512 of the running state
with a domain byte, reduced mod r. The transcript hash absorbs the FULL
(x, y) affine coordinates on both sides (the verifier decompresses before
absorbing), so compression changes only the wire bytes, not the
Fiat–Shamir state.
"""

from __future__ import annotations

import hashlib

from ..fields.field import BN254_FR, BN254_FQ

R = BN254_FR.p
Q = BN254_FQ.p

_PERSONAL = b"halo2rsa-tpu-fs1"

_SQRT_EXP = (Q + 1) // 4  # q ≡ 3 (mod 4): a^((q+1)/4) is a sqrt of any QR


def compress_g1(p) -> bytes:
    """(x, y) -> 32 bytes: x LE, bit 255 = y parity; identity -> zeros."""
    if p is None:
        return bytes(32)
    b = bytearray(p[0].to_bytes(32, "little"))
    if p[1] & 1:
        b[31] |= 0x80
    return bytes(b)


def decompress_g1(b: bytes):
    """Inverse of :func:`compress_g1`, REJECTING invalid encodings.

    Raises AssertionError when x is out of range, x³+3 is a non-residue
    (no such curve point), or a reserved flag bit is set — the halo2
    ``Blake2bRead`` decompression capability (bench.rs:334-343): an
    adversarial proof cannot inject arbitrary coordinates. BN254 G1 has
    cofactor 1, so curve membership is the full subgroup check."""
    assert len(b) == 32, "transcript point truncated"
    if b == bytes(32):
        return None
    sign = b[31] >> 7
    assert b[31] & 0x40 == 0, "transcript point reserved flag set"
    x = int.from_bytes(b[:31] + bytes([b[31] & 0x3F]), "little")
    assert x < Q, "transcript point x out of range"
    rhs = (x * x % Q * x + 3) % Q
    y = pow(rhs, _SQRT_EXP, Q)
    assert y * y % Q == rhs, "transcript point not on curve"
    if (y & 1) != sign:
        y = Q - y
    return (x, y)


class Transcript:
    def __init__(self):
        self._h = hashlib.blake2b(person=_PERSONAL, digest_size=64)
        self.log: list[bytes] = []  # proof byte stream (write side)

    # --- absorb ---------------------------------------------------------

    def common_scalar(self, s: int) -> None:
        b = (s % R).to_bytes(32, "little")
        self._h.update(b"\x01" + b)

    def common_point(self, p) -> None:
        if p is None:
            b = bytes(64)
        else:
            b = p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")
        self._h.update(b"\x02" + b)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self.log.append((s % R).to_bytes(32, "little"))

    def write_point(self, p) -> None:
        self.common_point(p)
        self.log.append(compress_g1(p))

    # --- squeeze --------------------------------------------------------

    def challenge(self) -> int:
        state = self._h.copy()
        state.update(b"\x03challenge")
        out = int.from_bytes(state.digest(), "little") % R
        # absorb the squeeze so successive challenges differ
        self._h.update(b"\x04" + out.to_bytes(32, "little"))
        return out

    def proof_bytes(self) -> bytes:
        return b"".join(self.log)


class TranscriptReader:
    """Verifier side: replays the byte stream with identical absorbs."""

    def __init__(self, proof: bytes):
        self._t = Transcript()
        self._buf = proof
        self._pos = 0

    def read_scalar(self) -> int:
        b = self._buf[self._pos : self._pos + 32]
        self._pos += 32
        s = int.from_bytes(b, "little")
        assert s < R, "transcript scalar out of range"
        self._t.common_scalar(s)
        return s

    def read_point(self):
        """Deserialize a compressed G1 point (see :func:`decompress_g1`,
        which rejects out-of-range / off-curve / bad-flag encodings)."""
        b = self._buf[self._pos : self._pos + 32]
        self._pos += 32
        p = decompress_g1(b)
        self._t.common_point(p)
        return p

    def common_scalar(self, s: int) -> None:
        self._t.common_scalar(s)

    def common_point(self, p) -> None:
        self._t.common_point(p)

    def challenge(self) -> int:
        return self._t.challenge()

    def finished(self) -> bool:
        return self._pos == len(self._buf)

"""RSASignatureVerifier: hash-then-verify composition.

Analog of halo2-rsa `src/lib.rs:150-248`: run the SHA-256 chip over the
raw message, reverse the digest bytes to little-endian, pack 8 bytes per
64-bit limb via mul_add with 2^(8j) constants (lib.rs:225-239), then call
``RSAChip::verify_pkcs1v15_signature``. Returns (is_valid bit, digest byte
cells in big-endian order) exactly like lib.rs:246-247.
"""

from __future__ import annotations

from ..bigint.types import FRESH, AssignedInteger
from ..circuit.builder import Cell
from ..sha256.chip import Sha256Chip
from .chip import RSAChip
from .types import AssignedRSAPublicKey, AssignedRSASignature


class RSASignatureVerifier:
    def __init__(self, rsa_chip: RSAChip, sha256_chip: Sha256Chip):
        self.rsa_chip = rsa_chip
        self.sha256_chip = sha256_chip

    def verify_pkcs1v15_signature(
        self,
        public_key: AssignedRSAPublicKey,
        msg: bytes,
        signature: AssignedRSASignature,
        max_len: int | None = None,
    ) -> tuple[Cell, list[Cell]]:
        """Hash-then-verify. With ``max_len`` set, the SHA-256 stage runs in
        dynamic-length mode: ONE circuit shape (hence one vk) verifies any
        message of length <= max_len — parity with the reference's
        ``Sha256Chip::configure(max_input_size)`` usage (lib.rs:308-320)."""
        # 1. SHA-256 of the message in-circuit (lib.rs:203-212)
        if max_len is None:
            _, hashed_bytes, _ = self.sha256_chip.digest(msg)
        else:
            _, hashed_bytes, _, _ = self.sha256_chip.digest_dynamic(msg, max_len)
        hashed_le = list(reversed(hashed_bytes))  # big-endian -> little-endian

        # 2. pack 8 bytes -> one 64-bit limb (lib.rs:225-239)
        mg = self.rsa_chip.main_gate
        b = self.rsa_chip.b
        limb_bytes = RSAChip.LIMB_WIDTH // 8
        assigned_limbs = []
        for i in range(len(hashed_le) // limb_bytes):
            limb_val = mg.assign_constant(0)
            for j in range(limb_bytes):
                coeff = mg.assign_constant(1 << (8 * j))
                limb_val = mg.mul_add(coeff, hashed_le[limb_bytes * i + j], limb_val)
            assigned_limbs.append(limb_val)
        hashed_msg = AssignedInteger(assigned_limbs, FRESH)

        # 3. EM structure check (lib.rs:241-242)
        is_valid = self.rsa_chip.verify_pkcs1v15_signature(
            public_key, hashed_msg, signature
        )
        return is_valid, hashed_bytes

"""RSAChip: RSA relation constraints.

Re-implements ``RSAInstructions`` (halo2-rsa `src/instructions.rs:8-39`)
and ``RSAChip`` (halo2-rsa `src/chip.rs:37-255`): public-key/signature
assignment, modular exponentiation under a public key, and the full PKCS#1
v1.5 encoded-message structure check with the reference's exact constants.
"""

from __future__ import annotations

from ..bigint.chip import BigIntChip, tag_ops
from ..bigint.types import AssignedInteger
from ..circuit.builder import Builder, Cell
from ..circuit.range_chip import NUM_LOOKUP_LIMBS
from .types import AssignedRSAPublicKey, AssignedRSASignature, RSAPublicKey, RSASignature

# PKCS#1 v1.5 EM constants for 64-bit limbs + SHA-256 (chip.rs:138-197):
HASH_LEN_LIMBS = 4  # 256-bit digest = 4 x 64-bit limbs (chip.rs:138)
# DigestInfo prefix packed into two 64-bit limbs (chip.rs:149-152)
PREFIX_64_1 = 217300885422736416
PREFIX_64_2 = 938447882527703397
# low 32 bits of the third prefix limb (chip.rs:175)
PREFIX_32 = 3158320
# 0xFFFFFFFF / 0xFFFF...FF paddings (chip.rs:180-184)
FF_32 = 4294967295
FF_64 = 18446744073709551615
# top limb: 0x00 || 0x01 || 0xff^6 = 562949953421311 (chip.rs:189-191)
LAST_EM = 562949953421311


@tag_ops
class RSAChip:
    """``RSAChip::new(config, bits_len, exp_limb_bits)`` analog
    (chip.rs:214-221); LIMB_WIDTH fixed at 64 (chip.rs:203)."""

    LIMB_WIDTH = 64

    def __init__(self, builder: Builder, bits_len: int, exp_limb_bits: int):
        self.b = builder
        self.bits_len = bits_len
        self.exp_limb_bits = exp_limb_bits
        self.bigint_chip = BigIntChip(builder, self.LIMB_WIDTH, bits_len)
        self.main_gate = self.bigint_chip.main_gate
        self.range_chip = self.bigint_chip.range_chip

    # ------------------------------------------------------------------

    def assign_public_key(self, public_key: RSAPublicKey) -> AssignedRSAPublicKey:
        """chip.rs:58-70."""
        n = self.bigint_chip.assign_integer(public_key.n)
        if public_key.e.kind == "var":
            e = self.bigint_chip.assign_integer(
                public_key.e.value, public_key.e.num_limbs
            )
            return AssignedRSAPublicKey(n, e, "var")
        return AssignedRSAPublicKey(n, public_key.e.value, "fix")

    def assign_signature(self, signature: RSASignature) -> AssignedRSASignature:
        """chip.rs:80-88."""
        c = self.bigint_chip.assign_integer(signature.c)
        return AssignedRSASignature(c)

    def modpow_public_key(
        self, x: AssignedInteger, public_key: AssignedRSAPublicKey
    ) -> AssignedInteger:
        """x^e mod n, asserting x < n first (chip.rs:99-114)."""
        bc = self.bigint_chip
        bc.assert_in_field(x, public_key.n)
        if public_key.e_kind == "var":
            return bc.pow_mod(x, public_key.e, public_key.n, self.exp_limb_bits)
        return bc.pow_mod_fixed_exp(x, public_key.e, public_key.n)

    def verify_pkcs1v15_signature(
        self,
        public_key: AssignedRSAPublicKey,
        hashed_msg: AssignedInteger,
        signature: AssignedRSASignature,
    ) -> Cell:
        """Full PKCS#1 v1.5 EM structure check of sig^e mod n
        (chip.rs:128-199). Returns an AND-accumulated equality *bit* — the
        caller decides whether to assert it."""
        mg = self.main_gate
        is_eq = mg.assign_constant(1)
        powed = self.modpow_public_key(signature.c, public_key)
        hash_len = HASH_LEN_LIMBS

        # 1. hashed data: limbs 0..4 must equal the digest limbs (chip.rs:141-144)
        for i in range(hash_len):
            is_hash_eq = mg.is_equal(powed.limb(i), hashed_msg.limb(i))
            is_eq = mg.and_(is_eq, is_hash_eq)

        # 2. DigestInfo prefix + 0x00 byte (chip.rs:149-177)
        prefix_64_1 = mg.assign_constant(PREFIX_64_1)
        prefix_64_2 = mg.assign_constant(PREFIX_64_2)
        is_eq = mg.and_(is_eq, mg.is_equal(powed.limb(hash_len), prefix_64_1))
        is_eq = mg.and_(is_eq, mg.is_equal(powed.limb(hash_len + 1), prefix_64_2))
        # split limb 6 into range-checked 32-bit halves
        v = self.b.val(powed.limb(hash_len + 2))
        low, high = v % (1 << 32), v >> 32
        remain_low = self.range_chip.assign(low, 32 // NUM_LOOKUP_LIMBS, 32)
        remain_high = self.range_chip.assign(high, 32 // NUM_LOOKUP_LIMBS, 32)
        u32_cell = mg.assign_constant(1 << 32)
        remain_concat = mg.mul_add(remain_high, u32_cell, remain_low)
        mg.assert_equal(powed.limb(hash_len + 2), remain_concat)
        prefix_32 = mg.assign_constant(PREFIX_32)
        is_eq = mg.and_(is_eq, mg.is_equal(remain_low, prefix_32))

        # 3. PS padding 0xff..ff and EM[1] = 1 (chip.rs:180-197)
        ff_32 = mg.assign_constant(FF_32)
        is_eq = mg.and_(is_eq, mg.is_equal(remain_high, ff_32))
        ff_64 = mg.assign_constant(FF_64)
        num_limbs = self.bits_len // self.LIMB_WIDTH
        for i in range(hash_len + 3, num_limbs - 1):
            is_eq = mg.and_(is_eq, mg.is_equal(powed.limb(i), ff_64))
        last_em = mg.assign_constant(LAST_EM)
        is_eq = mg.and_(is_eq, mg.is_equal(powed.limb(num_limbs - 1), last_em))
        return is_eq

    # ------------------------------------------------------------------

    @classmethod
    def compute_range_lens(cls, num_limbs: int) -> tuple[list, list]:
        """chip.rs:249-254: bigint lens + a 4-bit entry for the 32-bit splits."""
        comp, overflow = BigIntChip.compute_range_lens(cls.LIMB_WIDTH, num_limbs)
        comp.append(32 // NUM_LOOKUP_LIMBS)
        return comp, overflow

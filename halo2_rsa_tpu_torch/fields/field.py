"""Host-side prime-field definitions.

These are the native fields of the constraint system (the analog of the curve
fields the reference pulls in from halo2wrong: BN256 Fr/Fq and the Pasta
fields, see halo2-rsa `benches/bench.rs:35` and
halo2-rsa `src/big_integer/chip.rs:1461-1465`).

Host-side synthesis works with plain Python ints mod ``p``; the vectorized TPU
representation (16 x 16-bit limbs, Montgomery form) is derived from the
constants computed here (see ``vecfield.py``).
"""

from __future__ import annotations

import dataclasses
import functools

# Number of limbs / bits per limb of the vectorized representation.
LIMB_BITS = 16
NUM_LIMBS = 16  # 16 * 16 = 256 bits >= any supported modulus
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS  # Montgomery radix R = 2^256


@dataclasses.dataclass(frozen=True)
class PrimeField:
    """A prime field with precomputed Montgomery constants.

    The vectorized kernels represent an element ``x`` as ``x * R mod p``
    decomposed into ``NUM_LIMBS`` base-``2^LIMB_BITS`` limbs.
    """

    name: str
    p: int

    def __post_init__(self):
        assert self.p % 2 == 1 and self.p.bit_length() <= R_BITS

    @functools.cached_property
    def r(self) -> int:
        """R mod p (Montgomery form of 1)."""
        return (1 << R_BITS) % self.p

    @functools.cached_property
    def r2(self) -> int:
        """R^2 mod p (used to enter Montgomery form)."""
        return (1 << (2 * R_BITS)) % self.p

    @functools.cached_property
    def n0inv(self) -> int:
        """-p^-1 mod 2^LIMB_BITS (the per-limb Montgomery constant)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def num_bits(self) -> int:
        return self.p.bit_length()

    # --- host scalar ops (used during synthesis) -------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        return pow(a, -1, self.p)

    def to_mont(self, a: int) -> int:
        return (a << R_BITS) % self.p

    def from_mont(self, a: int) -> int:
        return (a * pow(1 << R_BITS, -1, self.p)) % self.p


# The four fields the reference's tests run over
# (halo2-rsa `src/big_integer/chip.rs:1461-1465`, benches/bench.rs:35).
BN254_FR = PrimeField(
    "bn254_fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
)
BN254_FQ = PrimeField(
    "bn254_fq",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
)
PASTA_FP = PrimeField(
    "pasta_fp",
    28948022309329048855892746252171976963363056481941560715954676764349967630337,
)
PASTA_FQ = PrimeField(
    "pasta_fq",
    28948022309329048855892746252171976963363056481941647379679742748393362948097,
)

ALL_FIELDS = (BN254_FR, BN254_FQ, PASTA_FP, PASTA_FQ)

# The three fields the reference's bigint/rsa chip tests iterate over
# (halo2-rsa `src/big_integer/chip.rs:1461-1465`): BN256 Fq, Pasta Fp, Pasta Fq.
REFERENCE_TEST_FIELDS = (BN254_FQ, PASTA_FP, PASTA_FQ)

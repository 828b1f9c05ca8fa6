"""RSA key/signature value types.

Analog of halo2-rsa `src/lib.rs:25-140` (``RSAPubE``, ``RSAPublicKey``,
``RSASignature`` and their assigned variants).
"""

from __future__ import annotations

import dataclasses

from ..bigint.types import AssignedInteger

DEFAULT_E = 65537  # the reference tests' DEFAULT_E (src/chip.rs:284)


@dataclasses.dataclass(frozen=True)
class RSAPubE:
    """Exponent parameter: variable (in-circuit) or fixed (build-time).

    ``RSAPubE::{Var, Fix}`` (lib.rs:25-30). For Var, ``num_limbs`` is the limb
    count of the assigned exponent integer (the reference passes a 1-limb
    UnassignedInteger in its tests, src/chip.rs:378).
    """

    kind: str  # "var" | "fix"
    value: int
    num_limbs: int = 1

    @classmethod
    def var(cls, value: int, num_limbs: int = 1) -> "RSAPubE":
        return cls("var", value, num_limbs)

    @classmethod
    def fix(cls, value: int = DEFAULT_E) -> "RSAPubE":
        return cls("fix", value)


@dataclasses.dataclass(frozen=True)
class RSAPublicKey:
    """(n, e) pair about to be assigned (lib.rs:43-71)."""

    n: int
    e: RSAPubE

    @classmethod
    def without_witness(cls, bits_len: int, e: "RSAPubE | None" = None) -> "RSAPublicKey":
        """Witness-free shape for keygen (lib.rs:63-70 ``without_witness``).

        The dummy modulus 2^bits_len − 1 has the full bit length (so every
        limb-count decision matches a real key) and is odd/nonzero (so the
        host-side divmod witnessing in synthesis stays total). Keygen reads
        only the trace *structure*, never these values."""
        return cls(n=(1 << bits_len) - 1, e=e if e is not None else RSAPubE.fix())


@dataclasses.dataclass(frozen=True)
class RSASignature:
    """A pkcs1v15 signature integer c about to be assigned (lib.rs:98-121)."""

    c: int

    @classmethod
    def without_witness(cls) -> "RSASignature":
        """Witness-free shape for keygen (lib.rs:114-120)."""
        return cls(c=0)


@dataclasses.dataclass
class AssignedRSAPublicKey:
    """lib.rs:75-94. ``e`` is an AssignedInteger for Var or a plain int for Fix."""

    n: AssignedInteger
    e: AssignedInteger | int
    e_kind: str  # "var" | "fix"


@dataclasses.dataclass
class AssignedRSASignature:
    """lib.rs:125-140."""

    c: AssignedInteger

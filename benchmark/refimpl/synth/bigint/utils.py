"""Host-side big-integer helpers (non-circuit oracles).

Analog of halo2-rsa `src/big_integer/utils.rs:2-17` (``big_pow_mod``),
used by tests as the expected-value oracle.
"""

from __future__ import annotations


def big_pow_mod(a: int, b: int, n: int) -> int:
    """a^b mod n (the reference implements recursive square-and-multiply;
    Python's pow is equivalent)."""
    return pow(a, b, n)

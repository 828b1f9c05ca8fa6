"""Host-side conversions between Python ints and limb arrays.

Two limb systems coexist:

* the *field* limb system (16 x 16-bit limbs in uint32) used by the vectorized
  TPU field kernels, and
* the *bigint gadget* limb system (e.g. 32 x 64-bit limbs for RSA-2048), the
  analog of maingate's ``decompose_big``/``big_to_fe``/``fe_to_big`` helpers
  (see halo2-rsa `src/big_integer/chip.rs:1268`, src/lib.rs:352).
"""

from __future__ import annotations

import numpy as np

from .field import LIMB_BITS, LIMB_MASK, NUM_LIMBS


def int_to_field_limbs(x: int) -> np.ndarray:
    """Decompose 0 <= x < 2^256 into (NUM_LIMBS,) uint32 base-2^16 limbs."""
    assert 0 <= x < (1 << (LIMB_BITS * NUM_LIMBS))
    out = np.empty((NUM_LIMBS,), dtype=np.uint32)
    for i in range(NUM_LIMBS):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def field_limbs_to_int(limbs: np.ndarray) -> int:
    """Recompose (..., NUM_LIMBS) limbs back into Python ints (scalar case)."""
    limbs = np.asarray(limbs)
    assert limbs.shape[-1] == NUM_LIMBS
    x = 0
    for i in reversed(range(NUM_LIMBS)):
        x = (x << LIMB_BITS) | int(limbs[..., i])
    return x


def ints_to_field_limbs(xs, out=None) -> np.ndarray:
    """Vector version: list of ints -> (len, NUM_LIMBS) uint32."""
    n = len(xs)
    if out is None:
        out = np.empty((n, NUM_LIMBS), dtype=np.uint32)
    for j, x in enumerate(xs):
        for i in range(NUM_LIMBS):
            out[j, i] = x & LIMB_MASK
            x >>= LIMB_BITS
    return out


def decompose_big(x: int, num_limbs: int, limb_width: int) -> list[int]:
    """Decompose ``x`` into ``num_limbs`` base-2^limb_width limbs (little-endian).

    Analog of maingate's ``decompose_big`` (used at
    halo2-rsa `src/big_integer/mod.rs:91-94`).
    """
    mask = (1 << limb_width) - 1
    out = []
    for _ in range(num_limbs):
        out.append(x & mask)
        x >>= limb_width
    assert x == 0, "integer does not fit in the requested limbs"
    return out


def compose_big(limbs, limb_width: int) -> int:
    """Recompose base-2^limb_width limbs (little-endian) into an int.

    Analog of ``AssignedInteger::to_big_uint``
    (halo2-rsa `src/big_integer/mod.rs:348-359`).
    """
    x = 0
    for limb in reversed(list(limbs)):
        x = (x << limb_width) | int(limb)
    return x

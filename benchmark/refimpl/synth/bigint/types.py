"""Value types for limb-decomposed big integers.

TPU-native equivalents of the reference's type system
(halo2-rsa `src/big_integer/mod.rs:216-482`): ``Fresh``/``Muled`` range
tags, ``AssignedInteger`` (a vector of witness cells), and ``RefreshAux``
(host-precomputed carry structure for renormalizing overflowed limbs).
"""

from __future__ import annotations

import dataclasses
import functools

from ..circuit.builder import Builder, Cell

# Range types (phantom tags in the reference, plain strings here).
FRESH = "fresh"  # limbs < 2^limb_width (mod.rs:222-224)
MULED = "muled"  # limbs may reach ~n*(2^w-1)^2 after a product (mod.rs:230-232)


@dataclasses.dataclass
class AssignedInteger:
    """A big integer as a list of witness cells (one per limb) plus a range tag.

    Analog of ``AssignedInteger<F, T>`` (mod.rs:305-405).
    """

    limbs: list[Cell]
    tag: str  # FRESH or MULED

    def limb(self, i: int) -> Cell:
        return self.limbs[i]

    @property
    def num_limbs(self) -> int:
        return len(self.limbs)

    def replace_limb(self, idx: int, cell: Cell) -> None:
        self.limbs[idx] = cell

    def extend_limbs(self, n: int, zero_cell: Cell) -> None:
        """Pad with ``n`` copies of an assigned zero (mod.rs:375-381)."""
        self.limbs.extend([zero_cell] * n)

    def to_int(self, builder: Builder, limb_width: int) -> int:
        """Recompose the witness value (``to_big_uint``, mod.rs:348-359)."""
        x = 0
        for cell in reversed(self.limbs):
            x = (x << limb_width) | builder.val(cell)
        return x

    def clone(self) -> "AssignedInteger":
        return AssignedInteger(list(self.limbs), self.tag)

    def to_muled(self, zero_cell: Cell) -> "AssignedInteger":
        """Fresh -> Muled with limb count widened to 2n-1 (mod.rs:393-405)."""
        assert self.tag == FRESH
        limbs = list(self.limbs) + [zero_cell] * (self.num_limbs - 1)
        return AssignedInteger(limbs, MULED)


@functools.lru_cache(maxsize=None)
def _increased_limbs_vec(limb_width: int, num_limbs_l: int, num_limbs_r: int) -> tuple:
    """Worst-case carry spread per muled limb.

    Re-derivation of ``RefreshAux::new`` (mod.rs:428-481): take the product of
    two all-max-limb integers, then greedily decompose each overflowed limb
    into base-2^w chunks, propagating the chunks upward; entry i records how
    many extra limbs the i-th position spills into.
    """
    max_limb = (1 << limb_width) - 1
    d = num_limbs_l + num_limbs_r - 1
    muled = []
    for i in range(d):
        j0 = 0 if num_limbs_r >= i + 1 else i + 1 - num_limbs_r
        acc = 0
        j = j0
        while j < num_limbs_l and j <= i:
            acc += max_limb * max_limb  # l_max[j] * r_max[i-j]
            j += 1
        muled.append(acc)
    increased = []
    cur_d = 0
    max_d = d
    while cur_d <= max_d:
        if cur_d >= len(muled):
            muled.append(0)
        bits = muled[cur_d].bit_length()
        num_chunks = (bits + limb_width - 1) // limb_width if bits else 0
        num_chunks = max(num_chunks, 1)
        increased.append(num_chunks - 1)
        chunks = []
        v = muled[cur_d]
        for _ in range(num_chunks):
            chunks.append(v & max_limb)
            v >>= limb_width
        assert v == 0
        muled[cur_d] = 0
        for j, c in enumerate(chunks):
            while len(muled) <= cur_d + j:
                muled.append(0)
            muled[cur_d + j] += c
        cur_d += 1
    return tuple(increased)


@dataclasses.dataclass(frozen=True)
class RefreshAux:
    """Auxiliary data for Muled -> Fresh renormalization (mod.rs:407-482)."""

    limb_width: int
    num_limbs_l: int
    num_limbs_r: int

    @property
    def increased_limbs_vec(self) -> tuple:
        return _increased_limbs_vec(self.limb_width, self.num_limbs_l, self.num_limbs_r)

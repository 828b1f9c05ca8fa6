"""RangeChip: lookup-based range checks.

Functional equivalent of maingate's ``RangeChip``/``RangeInstructions``
(configured by the reference at
halo2-rsa `src/big_integer/chip.rs:1418-1423`; assignment calls at e.g.
chip.rs:74, 280-282, 590-599). The reference decomposes each value into
``NUM_LOOKUP_LIMBS = 8`` sublimbs (big_integer/chip.rs:1163) checked against a
lookup table, plus an overflow sublimb for non-divisible widths.

TPU-native equivalent: every sublimb is recorded as a (cell, bits) lookup in
the trace; the checker verifies all lookups of one width as a single
vectorized bound compare (and the real prover compiles them into one batched
lookup argument per table).
"""

from __future__ import annotations

from .builder import Builder, Cell
from .main_gate import MainGate

NUM_LOOKUP_LIMBS = 8  # parity with BigIntChip::NUM_LOOKUP_LIMBS (chip.rs:1163)


def sublimb_bit_len(bit_len_limb: int) -> int:
    """Bits per lookup sublimb (BigIntChip::sublimb_bit_len, chip.rs:1357-1365)."""
    val = bit_len_limb // NUM_LOOKUP_LIMBS
    return val if val > 0 else 1


class RangeChip:
    def __init__(self, builder: Builder):
        self.b = builder
        self.main_gate = MainGate(builder)

    def assign(
        self,
        value: int,
        sublimb_bits: int,
        bit_len: int,
        source: Cell | None = None,
        source_shift: int = 0,
    ) -> Cell:
        """Witness ``value`` constrained to [0, 2^bit_len).

        Decomposes into sublimbs of ``sublimb_bits`` (last one narrower when
        ``bit_len % sublimb_bits != 0`` — the "overflow" lookup), records a
        lookup per sublimb, and recomposes with an accumulation chain whose
        final cell is returned. Mirrors RangeInstructions::assign semantics.

        ``source``/``source_shift``: provenance for batched witness replay —
        the value equals ``(val(source) >> source_shift) & (2^bit_len - 1)``.
        Without a source the sublimbs are replay *inputs*.
        """
        assert 0 <= value < (1 << bit_len), (
            f"range assign: value {value} out of [0, 2^{bit_len})"
        )
        if source is not None:
            assert (self.b.val(source) >> source_shift) & ((1 << bit_len) - 1) == value
        b = self.b
        widths = []
        remaining = bit_len
        while remaining > 0:
            w = min(sublimb_bits, remaining)
            widths.append(w)
            remaining -= w
        # decompose LSB-first
        sublimbs = []
        x = value
        for w in widths:
            sublimbs.append(x & ((1 << w) - 1))
            x >>= w
        assert x == 0
        cells = []
        shift = 0
        for sv, w in zip(sublimbs, widths):
            prov = (
                ("shrmask", source.idx, source_shift + shift, w)
                if source is not None
                else ("in",)
            )
            c = b.new_cell(sv, prov)
            b.lookup(c, w)
            cells.append(c)
            shift += w
        # recompose: one linear-combination row per 4 sublimbs (3 + carry
        # thereafter) instead of one row per sublimb
        terms = []
        shift = 0
        for c, w in zip(cells, widths):
            terms.append((c, 1 << shift))
            shift += w
        return self.main_gate.linear_combination(terms)

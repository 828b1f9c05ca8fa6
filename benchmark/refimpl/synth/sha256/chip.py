"""SHA-256 circuit gadget.

Capability equivalent of the external ``halo2-dynamic-sha256`` crate the
reference depends on (Cargo.toml:15; used via ``Sha256Chip::{init, finalize,
decompose_digest_to_bytes}`` at halo2-rsa `src/lib.rs:203-212`).

Realization is bit-sliced over the trace builder's main gate: 32-bit words
are carried both as a composed field cell and as 32 boolean cells; XOR/CH/MAJ
are one-or-two-row bit gates; rotations are free re-indexing; mod-2^32
additions use a witnessed carry with a range-checked quotient.

Two entry points: :meth:`Sha256Chip.digest` fixes the circuit shape per
message length (padding as circuit constants — cheapest when one length is
proved repeatedly), while :meth:`Sha256Chip.digest_dynamic` emits ONE shape
for every length <= max_len (witnessed padding + in-circuit length
constraints), matching ``halo2-dynamic-sha256``'s single-vk capability.

The full compression function is checked in-circuit — message bytes are
8-bit-lookup-checked witnesses, so a verifier of the trace verifies the hash.
"""

from __future__ import annotations

from typing import NamedTuple

from ..circuit.builder import Builder, Cell
from ..circuit.main_gate import MainGate
from ..circuit.range_chip import RangeChip

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_H0 = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


class Word(NamedTuple):
    """A 32-bit word: composed field cell + 32 bit cells (LSB-first)."""

    cell: Cell
    bits: tuple


class Sha256Chip:
    def __init__(self, builder: Builder):
        self.b = builder
        self.mg = MainGate(builder)
        self.rc = RangeChip(builder)

    # --- word helpers ----------------------------------------------------

    def _const_word(self, v: int) -> Word:
        cell = self.mg.assign_constant(v)
        bits = tuple(self.mg.assign_constant((v >> i) & 1) for i in range(32))
        return Word(cell, bits)

    def _compose_bits(self, bits) -> Cell:
        """Composition of bit cells into one field cell, 4 bits to a row
        (3 + running sum thereafter): 11 rows for a 32-bit word instead of
        32 — the single biggest row sink of the compression function."""
        return self.mg.linear_combination(
            [(bit, 1 << i) for i, bit in enumerate(bits)]
        )

    def _decompose_word(self, cell: Cell) -> Word:
        """Witness 32 boolean bits and constrain their composition == cell."""
        v = self.b.val(cell)
        assert v < (1 << 32)
        bits = tuple(
            self.mg.assign_bit((v >> i) & 1, prov=("shrmask", cell.idx, i, 1))
            for i in range(32)
        )
        composed = self._compose_bits(bits)
        self.mg.assert_equal(composed, cell)
        return Word(cell, bits)

    def _xor(self, x: Cell, y: Cell) -> Cell:
        """Bit XOR in one row: x + y - 2xy - out == 0."""
        b = self.b
        out = b.new_cell(b.val(x) ^ b.val(y), ("full", x.idx, y.idx, 0, 1, 1, -2))
        b.gate([x, y, out], (1, 1, -1, 0, 0, -2, 0, 0))
        return out

    def _xor3_bits(self, xs, ys, zs):
        return tuple(self._xor(self._xor(x, y), z) for x, y, z in zip(xs, ys, zs))

    @staticmethod
    def _rotr(bits, r):
        return tuple(bits[(i + r) % 32] for i in range(32))

    def _shr(self, bits, n):
        zero = self.b.zero
        return tuple(bits[i + n] if i + n < 32 else zero for i in range(32))

    def _ch_bits(self, e, f, g):
        """ch = e ? f : g per bit — exactly the select gate (1 row/bit)."""
        return tuple(
            self.mg.select(fb, gb, eb) for eb, fb, gb in zip(e, f, g)
        )

    def _maj_bits(self, a, b_, c):
        """maj = ab + c·(a ^ b) per bit: one xor row + one two-product row
        (the gate's q_ab·ab + q_cd·(a^b)·c wires) — 2 rows/bit."""
        out = []
        for ab_, bb, cb in zip(a, b_, c):
            x = self._xor(ab_, bb)
            out.append(self.mg.mul2_add(ab_, bb, x, cb))
        return tuple(out)

    def _mod32(self, cell: Cell, max_carry_bits: int = 4) -> Cell:
        """Split cell = q*2^32 + r; range-check q (small) and return r.

        One constraint row q·2^32 + r − cell == 0 (no recompose chain).
        r's bit decomposition is done by the caller when needed."""
        b = self.b
        v = b.val(cell)
        q_v, r_v = v >> 32, v & 0xFFFFFFFF
        q = self.rc.assign(q_v, max_carry_bits, max_carry_bits, source=cell, source_shift=32)
        r = self.rc.assign(r_v, 8, 32, source=cell)
        b.gate([q, r, cell], (1 << 32, 1, -1, 0, 0, 0, 0, 0))
        return r

    def _add_words_mod32(self, cells, const: int = 0) -> Word:
        """Sum of composed word cells (+ constant), reduced mod 2^32 and
        re-bit-decomposed. The sum is one linear-combination row for up to
        4 terms."""
        if len(cells) == 1 and const == 0:
            acc = cells[0]
        else:
            acc = self.mg.linear_combination(
                [(c, 1) for c in cells], const=const
            )
        r = self._mod32(acc)
        return self._decompose_word(r)

    # --- message handling ------------------------------------------------

    def assign_message(self, msg: bytes) -> list[Cell]:
        """Witness the message bytes, each 8-bit lookup-checked."""
        return [self.rc.assign(byte, 8, 8) for byte in msg]

    # --- dynamic-length mode ---------------------------------------------

    @staticmethod
    def num_blocks(max_len: int) -> int:
        """SHA-256 blocks needed for any message of length <= max_len."""
        return (max_len + 8) // 64 + 1

    def digest_dynamic(self, msg: bytes, max_len: int):
        """Hash ``msg`` under ONE circuit shape for every length <= max_len.

        Capability parity with ``halo2-dynamic-sha256``'s
        ``Sha256Chip::configure(max_input_size)`` — the reference verifies
        any message up to a configured max under a single vk
        (halo2-rsa `src/lib.rs:144-146`, 308-320). The trace emitted
        here depends only on ``max_len``; the message enters purely through
        witness values, so one keygen serves all lengths.

        In-circuit dynamic machinery (all constraints, no trust in the
        prover):

        * every byte of the padded buffer (``PB = 64·num_blocks`` bytes) is
          a witnessed, 8-bit-lookup-checked cell;
        * a *monotone boolean mask* (mask_i = [i < len]): each bit boolean,
          differences boolean (so the mask is a prefix of ones), and
          Σ mask_i == len — this pins the mask exactly;
        * the byte AT position len must be 0x80 (one gate per byte:
          (m_i − 0x80)·p_i == 0 with p_i the mask step indicator);
        * a one-hot *block selector* s_b for the final block, tied to len by
          the 6-bit range check len + 8 − 64·Σ b·s_b ∈ [0, 64);
        * every byte after the 0x80 that is not in the selected block's
          64-bit length field must be 0;
        * the selected block's length field must compose (big-endian) to
          8·len;
        * the compression runs over ALL blocks; the returned digest is the
          s-selected h-state.

        Returns (digest_words, digest_bytes, msg_cells, len_cell) where
        ``msg_cells`` are the first max_len padded-byte cells (the message
        region) and ``len_cell`` the witnessed byte length.
        """
        assert len(msg) <= max_len, f"message longer than max_len={max_len}"
        mg, b = self.mg, self.b
        nblocks = self.num_blocks(max_len)
        pb = 64 * nblocks
        mlen = len(msg)
        nb_used = (mlen + 8) // 64 + 1  # blocks actually covering msg+pad

        # host-side padded buffer (values only; ALL constrained below)
        padded = bytearray(pb)
        padded[:mlen] = msg
        padded[mlen] = 0x80
        lf = 64 * nb_used - 8
        padded[lf : lf + 8] = (8 * mlen).to_bytes(8, "big")

        # witnessed bytes, 8-bit lookups
        byte_cells = [self.rc.assign(v, 8, 8) for v in padded]

        # witnessed length + monotone mask
        len_cell = mg.assign_value(mlen, prov=("in",))
        mask = [
            mg.assign_bit(1 if i < mlen else 0, prov=("in",)) for i in range(pb)
        ]
        for i in range(pb - 1):
            # prefix-of-ones: m_{i+1}·(1 − m_i) == 0 (one row, no new cell;
            # both already boolean)
            b.gate([mask[i + 1], mask[i]], (1, 0, 0, 0, 0, -1, 0, 0))
        mask_sum = mg.linear_combination([(m_bit, 1) for m_bit in mask])
        mg.assert_equal(mask_sum, len_cell)  # Σ mask == len

        # 0x80 pinned at position len: (m_i − 0x80)·p_i == 0 with the step
        # indicator p_i = mask_{i-1} − mask_i expanded in-row (both products
        # ride the gate's q_ab/q_cd wires; no p cells materialized)
        b.gate([byte_cells[0], mask[0]], (1, 0x80, 0, 0, 0, -1, 0, -0x80))
        for i in range(1, pb):
            b.gate(
                [byte_cells[i], mask[i - 1], byte_cells[i], mask[i]],
                (0, -0x80, 0, 0x80, 0, 1, -1, 0),
            )

        # one-hot block selector tied to len
        s_cells = [
            mg.assign_bit(1 if bi == nb_used - 1 else 0, prov=("in",))
            for bi in range(nblocks)
        ]
        sel_sum = mg.linear_combination([(s, 1) for s in s_cells])
        mg.assert_one(sel_sum)
        # r = len + 8 − 64·(nb−1) ∈ [0, 64)
        r_expr = mg.linear_combination(
            [(len_cell, 1)] + [(s, -64 * bi) for bi, s in enumerate(s_cells)],
            const=8,
        )
        r_rc = self.rc.assign(b.val(r_expr), 6, 6, source=r_expr)
        mg.assert_equal(r_rc, r_expr)

        # zero region: after 0x80, outside the selected block's length field.
        # (1 − mask_i)(1 − p_i) = 1 − mask_{i-1} for the monotone mask, so
        # the constraint is m_i·(1 − mask_{i-1}) == 0 — one row outside the
        # length fields, two (via a materialized product) inside them.
        for i in range(1, pb):
            m_c = byte_cells[i]
            if i % 64 >= 56:
                t = b.new_cell(
                    b.val(m_c) * (1 - b.val(mask[i - 1])),
                    ("full", m_c.idx, mask[i - 1].idx, 0, 1, 0, -1),
                )
                b.gate([m_c, mask[i - 1], t], (1, 0, -1, 0, 0, -1, 0, 0))
                b.gate([t, s_cells[i // 64]], (1, 0, 0, 0, 0, -1, 0, 0))
            else:
                b.gate([m_c, mask[i - 1]], (1, 0, 0, 0, 0, -1, 0, 0))

        # selected block's length field composes to 8·len (big-endian)
        sel_len = b.zero
        for bi in range(nblocks):
            comp = mg.linear_combination(
                [
                    (byte_cells[64 * bi + 56 + j], 1 << (8 * (7 - j)))
                    for j in range(8)
                ]
            )
            sel_len = mg.mul_add(s_cells[bi], comp, sel_len)
        # sel_len − 8·len == 0
        b.gate([sel_len, len_cell], (1, -8, 0, 0, 0, 0, 0, 0))

        # --- compression over all blocks, recording each block's h-state --
        h = [self._const_word(x) for x in _H0]
        h_after: list[list[Word]] = []
        for blk in range(nblocks):
            h = self._compress_block(h, byte_cells[64 * blk : 64 * (blk + 1)])
            h_after.append(h)

        # --- s-selected digest -------------------------------------------
        digest_words = []
        for j in range(8):
            acc = b.zero
            for bi in range(nblocks):
                acc = mg.mul_add(s_cells[bi], h_after[bi][j].cell, acc)
            digest_words.append(acc)
        digest_bytes = []
        for j in range(8):
            for byte_i in range(4):
                acc = b.zero
                for bi in range(nblocks):
                    word = h_after[bi][j]
                    bits = word.bits[8 * (3 - byte_i) : 8 * (3 - byte_i) + 8]
                    acc = mg.mul_add(s_cells[bi], self._compose_bits(bits), acc)
                digest_bytes.append(acc)
        return digest_words, digest_bytes, byte_cells[:max_len], len_cell

    def _compress_block(self, h, block_cells):
        """One SHA-256 compression round over 64 byte cells; returns new h."""
        mg = self.mg
        w: list[Word] = []
        for i in range(16):
            cells4 = block_cells[4 * i : 4 * i + 4]
            acc = mg.linear_combination(
                [(bc, 1 << (8 * (3 - j))) for j, bc in enumerate(cells4)]
            )
            w.append(self._decompose_word(acc))
        for i in range(16, 64):
            s0b = self._xor3_bits(
                self._rotr(w[i - 15].bits, 7),
                self._rotr(w[i - 15].bits, 18),
                self._shr(w[i - 15].bits, 3),
            )
            s1b = self._xor3_bits(
                self._rotr(w[i - 2].bits, 17),
                self._rotr(w[i - 2].bits, 19),
                self._shr(w[i - 2].bits, 10),
            )
            s0 = self._compose_bits(s0b)
            s1 = self._compose_bits(s1b)
            w.append(self._add_words_mod32([w[i - 16].cell, s0, w[i - 7].cell, s1]))

        a, bb, c, d, e, f, g, hh = h
        for i in range(64):
            S1 = self._compose_bits(
                self._xor3_bits(
                    self._rotr(e.bits, 6), self._rotr(e.bits, 11), self._rotr(e.bits, 25)
                )
            )
            ch = self._compose_bits(self._ch_bits(e.bits, f.bits, g.bits))
            # t1 = hh + S1 + ch + w_i + K_i: one row (K_i rides q_const)
            t1 = mg.linear_combination(
                [(hh.cell, 1), (S1, 1), (ch, 1), (w[i].cell, 1)], const=_K[i]
            )
            S0 = self._compose_bits(
                self._xor3_bits(
                    self._rotr(a.bits, 2), self._rotr(a.bits, 13), self._rotr(a.bits, 22)
                )
            )
            maj = self._compose_bits(self._maj_bits(a.bits, bb.bits, c.bits))
            new_e = self._add_words_mod32([d.cell, t1])
            new_a = self._add_words_mod32([t1, S0, maj])
            a, bb, c, d, e, f, g, hh = new_a, a, bb, c, new_e, e, f, g

        return [
            self._add_words_mod32([x.cell, y.cell])
            for x, y in zip(h, [a, bb, c, d, e, f, g, hh])
        ]

    def digest(self, msg: bytes, msg_cells: list[Cell] | None = None):
        """Hash ``msg`` in-circuit.

        Returns (digest_words, digest_bytes, msg_cells): 8 word cells, 32
        byte cells in big-endian order (the pre-reverse order of
        ``decompose_digest_to_bytes``, lib.rs:210-212), and the assigned
        message byte cells.
        """
        if msg_cells is None:
            msg_cells = self.assign_message(msg)
        assert len(msg_cells) == len(msg)

        # --- padding (static per message length; constants in-circuit) ---
        ml = len(msg) * 8
        pad = b"\x80" + b"\x00" * ((55 - len(msg)) % 64) + ml.to_bytes(8, "big")
        pad_cells = [self.mg.assign_constant(x) for x in pad]
        all_cells = msg_cells + pad_cells
        all_bytes = msg + pad
        assert len(all_bytes) % 64 == 0

        h = [self._const_word(x) for x in _H0]

        for blk in range(0, len(all_bytes), 64):
            h = self._compress_block(h, all_cells[blk : blk + 64])

        digest_words = [word.cell for word in h]
        # big-endian digest bytes: word j, byte 0 = bits 24..32
        digest_bytes = []
        for word in h:
            for j in range(4):
                bits = word.bits[8 * (3 - j) : 8 * (3 - j) + 8]
                digest_bytes.append(self._compose_bits(bits))
        return digest_words, digest_bytes, msg_cells

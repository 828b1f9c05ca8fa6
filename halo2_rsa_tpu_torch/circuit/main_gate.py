"""MainGate: the scalar constraint op-set.

Functional equivalent of halo2wrong's ``MainGate``/``MainGateInstructions``
(imported by the reference at halo2-rsa `src/lib.rs:17-20` and used for
every scalar constraint — see SURVEY.md §2.2 row 1 for the full op list).
Each op computes the witness value host-side (Python ints), emits one or two
rows of the vectorized gate trace, and records value *provenance* so batched
witness re-generation can replay the whole circuit on device
(witness/replay.py).
"""

from __future__ import annotations

from .builder import Builder, Cell


class MainGate:
    def __init__(self, builder: Builder):
        self.b = builder
        self.p = builder.field.p

    # --- assignment ------------------------------------------------------

    def assign_constant(self, c: int) -> Cell:
        return self.b.assign_constant(c)

    def assign_value(self, v: int, prov=("in",)) -> Cell:
        """Unconstrained witness (constrained by later uses). By default it
        is an *input* of the batched witness replay."""
        return self.b.new_cell(v, prov)

    def assign_bit(self, v: int, prov=None) -> Cell:
        """Witness constrained to {0, 1} via b*b - b == 0."""
        if prov is None:
            prov = ("const", v % self.p) if v in (0, 1) else ("in",)
        cell = self.b.new_cell(v, prov)
        self.b.gate([cell, cell], (-1, 0, 0, 0, 0, 1, 0, 0))
        return cell

    # --- arithmetic ------------------------------------------------------

    def add(self, a: Cell, b: Cell) -> Cell:
        out = self.b.new_cell(
            self.b.val(a) + self.b.val(b), ("lin", a.idx, b.idx, 0, 1, 1)
        )
        self.b.gate([a, b, out], (1, 1, -1, 0, 0, 0, 0, 0))
        return out

    def sub(self, a: Cell, b: Cell) -> Cell:
        out = self.b.new_cell(
            self.b.val(a) - self.b.val(b), ("lin", a.idx, b.idx, 0, 1, -1)
        )
        self.b.gate([a, b, out], (1, -1, -1, 0, 0, 0, 0, 0))
        return out

    def neg(self, a: Cell) -> Cell:
        out = self.b.new_cell(-self.b.val(a), ("lin", a.idx, 0, 0, -1, 0))
        self.b.gate([a, out], (1, 1, 0, 0, 0, 0, 0, 0))
        return out

    def mul(self, a: Cell, b: Cell) -> Cell:
        out = self.b.new_cell(
            self.b.val(a) * self.b.val(b), ("full", a.idx, b.idx, 0, 0, 0, 1)
        )
        self.b.gate([a, b, out], (0, 0, -1, 0, 0, 1, 0, 0))
        return out

    def mul_add(self, a: Cell, b: Cell, c: Cell) -> Cell:
        """out = a*b + c (the hot op of the O(n^2) bigint product,
        halo2-rsa `src/big_integer/chip.rs:408`)."""
        out = self.b.new_cell(
            self.b.val(a) * self.b.val(b) + self.b.val(c),
            ("mul3", a.idx, b.idx, c.idx),
        )
        self.b.gate([a, b, c, out], (0, 0, 1, -1, 0, 1, 0, 0))
        return out

    def add_constant(self, a: Cell, k: int) -> Cell:
        out = self.b.new_cell(self.b.val(a) + k, ("lin", a.idx, 0, k, 1, 0))
        self.b.gate([a, out], (1, -1, 0, 0, 0, 0, 0, k))
        return out

    def add_with_constant(self, a: Cell, b: Cell, k: int) -> Cell:
        """out = a + b + k (used by the carry-equality gadget,
        halo2-rsa `src/big_integer/chip.rs:861`)."""
        out = self.b.new_cell(
            self.b.val(a) + self.b.val(b) + k, ("lin", a.idx, b.idx, k, 1, 1)
        )
        self.b.gate([a, b, out], (1, 1, -1, 0, 0, 0, 0, k))
        return out

    def mul_by_constant(self, a: Cell, k: int) -> Cell:
        out = self.b.new_cell(self.b.val(a) * k, ("lin", a.idx, 0, 0, k, 0))
        self.b.gate([a, out], (k, -1, 0, 0, 0, 0, 0, 0))
        return out

    def linear_combination(self, terms, const: int = 0) -> Cell:
        """out = const + Σ k_i·c_i for [(c_i, k_i), ...], packed 4 terms to a
        row (the 5-wire gate's full linear capacity; chained rows carry the
        running sum). The row-count win over per-term ``add``/``mul_add``
        chains is what the SHA-256 bit compositions ride."""
        b = self.b
        z = b.zero
        acc = None  # (cell, is_first)
        i = 0
        n = len(terms)
        while i < n or acc is None:
            take = terms[i : i + (4 if acc is None else 3)]
            i += len(take)
            cells = [c for c, _ in take]
            coefs = [k for _, k in take]
            if acc is not None:
                cells.append(acc)
                coefs.append(1)
            k0 = const if acc is None else 0
            while len(cells) < 4:
                cells.append(z)
                coefs.append(0)
            v = k0
            for c, kk in zip(cells, coefs):
                v += kk * b.val(c)
            out = b.new_cell(
                v,
                ("linc", cells[0].idx, cells[1].idx, cells[2].idx,
                 cells[3].idx, k0, coefs[0], coefs[1], coefs[2], coefs[3]),
            )
            b.gate(
                cells[:4] + [out],
                (coefs[0], coefs[1], coefs[2], coefs[3], -1, 0, 0, k0),
            )
            acc = out
        return acc

    def mul2_add(self, a: Cell, b_: Cell, c: Cell, d: Cell) -> Cell:
        """out = a·b + c·d in one row (both product wires of the gate)."""
        b = self.b
        out = b.new_cell(
            b.val(a) * b.val(b_) + b.val(c) * b.val(d),
            ("mul2", a.idx, b_.idx, c.idx, d.idx),
        )
        b.gate([a, b_, c, d, out], (0, 0, 0, 0, -1, 1, 1, 0))
        return out

    # --- logic -----------------------------------------------------------

    def select(self, a: Cell, b: Cell, cond: Cell) -> Cell:
        """cond ? a : b. One row: cond*a - cond*b + b - out == 0."""
        va, vb, vc = self.b.val(a), self.b.val(b), self.b.val(cond)
        assert vc in (0, 1), "select condition must be boolean"
        out = self.b.new_cell(va if vc == 1 else vb, ("sel", cond.idx, a.idx, b.idx))
        # slots: s0=cond, s1=a, s2=cond, s3=b, s4=out
        self.b.gate([cond, a, cond, b, out], (0, 0, 0, 1, -1, 1, -1, 0))
        return out

    def is_zero(self, a: Cell) -> Cell:
        """Bit: 1 iff a == 0 (inverse-witness trick, two rows)."""
        va = self.b.val(a)
        i = self.b.new_cell(pow(va, -1, self.p) if va != 0 else 0, ("inv0", a.idx))
        z = self.b.new_cell(1 if va == 0 else 0, ("eqz", a.idx))
        # a * z == 0
        self.b.gate([a, z], (0, 0, 0, 0, 0, 1, 0, 0))
        # z + a*i - 1 == 0
        self.b.gate([a, i, z], (0, 0, 1, 0, 0, 1, 0, -1))
        return z

    def is_equal(self, a: Cell, b: Cell) -> Cell:
        return self.is_zero(self.sub(a, b))

    def and_(self, a: Cell, b: Cell) -> Cell:
        """Boolean AND (inputs must already be bits)."""
        return self.mul(a, b)

    def or_(self, a: Cell, b: Cell) -> Cell:
        """a + b - a*b."""
        va, vb = self.b.val(a), self.b.val(b)
        out = self.b.new_cell(
            va + vb - va * vb, ("full", a.idx, b.idx, 0, 1, 1, -1)
        )
        self.b.gate([a, b, out], (1, 1, -1, 0, 0, -1, 0, 0))
        return out

    def not_(self, a: Cell) -> Cell:
        """1 - a (input must be a bit)."""
        out = self.b.new_cell(1 - self.b.val(a), ("lin", a.idx, 0, 1, -1, 0))
        self.b.gate([a, out], (1, 1, 0, 0, 0, 0, 0, -1))
        return out

    # --- assertions ------------------------------------------------------

    def assert_zero(self, a: Cell) -> None:
        self.b.gate([a], (1, 0, 0, 0, 0, 0, 0, 0))

    def assert_one(self, a: Cell) -> None:
        self.b.gate([a], (1, 0, 0, 0, 0, 0, 0, -1))

    def assert_equal(self, a: Cell, b: Cell) -> None:
        self.b.gate([a, b], (1, -1, 0, 0, 0, 0, 0, 0))

    def assert_bit(self, a: Cell) -> None:
        self.b.gate([a, a], (-1, 0, 0, 0, 0, 1, 0, 0))

    # --- decomposition ---------------------------------------------------

    def to_bits(self, a: Cell, nbits: int) -> list[Cell]:
        """Decompose into ``nbits`` bit cells (LSB first), with boolean gates
        and a recomposition chain (analog of MainGateInstructions::to_bits,
        used at halo2-rsa `src/big_integer/chip.rs:677`)."""
        va = self.b.val(a)
        assert va < (1 << nbits), "value does not fit in nbits"
        bits = [
            self.assign_bit((va >> i) & 1, prov=("shrmask", a.idx, i, 1))
            for i in range(nbits)
        ]
        # acc chain: acc_{i+1} = acc_i + 2^i * bit_i ; final acc must equal a.
        acc = self.b.zero
        for i, bit in enumerate(bits):
            nxt = self.b.new_cell(
                self.b.val(acc) + (1 << i) * self.b.val(bit),
                ("lin", acc.idx, bit.idx, 0, 1, 1 << i),
            )
            self.b.gate([acc, bit, nxt], (1, 1 << i, -1, 0, 0, 0, 0, 0))
            acc = nxt
        self.assert_equal(acc, a)
        return bits

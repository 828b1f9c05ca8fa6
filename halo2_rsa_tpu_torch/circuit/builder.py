"""Trace-based constraint builder — the TPU-native replacement for halo2's
``ConstraintSystem``/``Region``/``RegionCtx`` synthesis model.

halo2 (used by the reference at e.g.
halo2-rsa `src/big_integer/chip.rs:1403-1429`) assigns witness cells one
``assign_advice`` call at a time into a 2-D column/row layout, and relies on a
permutation argument for equality wiring. That cell-at-a-time,
interior-mutability model is the opposite of TPU-idiomatic.

Here, synthesis appends to a *flat witness vector* and records a *static
vectorized gate trace*: each constraint row stores 5 witness indices and 8
coefficients for the relation

    q0*w[s0] + q1*w[s1] + q2*w[s2] + q3*w[s3] + q4*w[s4]
      + q_ab*w[s0]*w[s1] + q_cd*w[s2]*w[s3] + q_const  ==  0   (mod p)

which is the same expressive power as halo2wrong's 5-wire MainGate (two
product terms + linear combination + constant). Copy constraints need no
permutation argument at check time: rows reference shared witness indices
directly (the permutation argument reappears only in the real prover, where
the trace is compiled to columns).

Range checks are recorded as (witness_index, bit_width) lookup records; the
checker verifies membership in the 2^bits table as one vectorized compare.

The result of synthesis is (witness values, trace), both of which freeze into
numpy/JAX arrays: constraint checking over all rows is a single jitted,
shardable gather + field-evaluation kernel (see ``checker.py``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

from ..fields.field import PrimeField


class Cell(NamedTuple):
    """A handle to one witness value (an index into the flat witness vector).

    Analog of maingate's ``AssignedValue`` (a cell in an advice column).
    """

    idx: int


class Builder:
    """Accumulates witness values and the static constraint trace."""

    def __init__(self, field: PrimeField):
        self.field = field
        self.values: list[int] = []  # witness values, Python ints in [0, p)
        self.gate_idx: list[tuple] = []  # (s0..s4) witness indices per row
        self.gate_coef: list[tuple] = []  # (q0..q4, q_ab, q_cd, q_const)
        self.lookups: list[tuple] = []  # (witness index, bit width)
        self.instance: list[int] = []  # public-input witness indices, in order
        self._const_cache: dict[int, int] = {}
        # --- witness provenance (for vectorized batched re-generation) ---
        # One entry per cell describing how its value derives from earlier
        # cells; None = opaque (replay unsupported for that circuit).
        # Opcodes: ("in",) ("const",c) ("lin",s0,s1,k0,k1,k2)
        # ("full",s0,s1,k0,k1,k2,k3) ("mul3",s0,s1,s2) ("sel",c,a,b)
        # ("inv0",s) ("eqz",s) ("shrmask",s,shift,bits)
        # ("bigq",id,j) ("bigr",id,j) ("bigsub",id,j)
        self.prov: list = []
        # big integer macro-ops evaluated host-side during replay:
        # ("divmod", a_cells, b_cells|None, n_cells, limb_width) or
        # ("sub", a_cells, b_cells, limb_width)
        self.bigops: list[tuple] = []
        # --- gate provenance (MockProver-style failure locating) ----------
        # One entry per gate row: the "/"-joined path of gadget ops active
        # when the row was recorded (e.g. "pow_mod_fixed_exp/mul_mod"), or
        # "" outside any tagged op. The capability of halo2 MockProver's
        # typed ``VerifyFailure`` (its per-region constraint locations,
        # halo2-rsa `src/big_integer/chip.rs:1433-1458`): a failing row
        # names the gadget call that emitted it (see checker.explain).
        self.gate_tags: list[str] = []
        self._op_stack: list[str] = []
        self._op_path: str = ""
        # Cell 0 is the constant 0; unused gate slots point at it (with zero
        # coefficient), keeping the trace rectangular.
        self.zero = self.assign_constant(0)

    @contextlib.contextmanager
    def op(self, name: str):
        """Tag gate rows recorded inside the block with the gadget-op path."""
        self._op_stack.append(name)
        self._op_path = "/".join(self._op_stack)
        try:
            yield
        finally:
            self._op_stack.pop()
            self._op_path = "/".join(self._op_stack)

    # --- core primitives -------------------------------------------------

    def new_cell(self, value: int, prov=None) -> Cell:
        """Append an (as yet unconstrained) witness value."""
        v = value % self.field.p
        self.values.append(v)
        self.prov.append(prov)
        return Cell(len(self.values) - 1)

    def add_bigop(self, op: tuple) -> int:
        self.bigops.append(op)
        return len(self.bigops) - 1

    def input_cells(self) -> list[int]:
        """Ordered indices of the cells a batched replay must be fed."""
        return [i for i, p in enumerate(self.prov) if p is not None and p[0] == "in"]

    def val(self, cell: Cell) -> int:
        return self.values[cell.idx]

    def gate(self, slots, coefs) -> None:
        """Record one constraint row.

        slots: up to 5 Cells (padded with the zero cell);
        coefs: (q0..q4, q_ab, q_cd, q_const), ints (reduced mod p).
        """
        p = self.field.p
        s = [c.idx for c in slots] + [0] * (5 - len(slots))
        q = tuple(c % p for c in coefs)
        assert len(s) == 5 and len(q) == 8
        self.gate_idx.append(tuple(s))
        self.gate_coef.append(q)
        self.gate_tags.append(self._op_path)

    def lookup(self, cell: Cell, bits: int) -> None:
        """Record that w[cell] must lie in [0, 2^bits)."""
        assert bits > 0
        self.lookups.append((cell.idx, bits))

    def assign_constant(self, c: int) -> Cell:
        """Witness cell pinned to a constant by the gate w - c == 0 (dedup'd)."""
        c = c % self.field.p
        hit = self._const_cache.get(c)
        if hit is not None:
            return Cell(hit)
        cell = self.new_cell(c, ("const", c))
        # w - c == 0
        self.gate([cell], (1, 0, 0, 0, 0, 0, 0, -c))
        self._const_cache[c] = cell.idx
        return cell

    def expose_public(self, cell: Cell) -> None:
        """Mark a cell as a public input (instance column analog)."""
        self.instance.append(cell.idx)

    # --- introspection ---------------------------------------------------

    @property
    def num_witness(self) -> int:
        return len(self.values)

    @property
    def num_gates(self) -> int:
        return len(self.gate_idx)

    @property
    def num_lookups(self) -> int:
        return len(self.lookups)

    def stats(self) -> dict:
        return {
            "witness_cells": self.num_witness,
            "gate_rows": self.num_gates,
            "lookups": self.num_lookups,
            "public_inputs": len(self.instance),
        }

"""BigIntChip: constraints for integers larger than the native field.

Re-implements the full ``BigIntInstructions`` op set of the reference
(halo2-rsa `src/big_integer/instructions.rs:7-260`, implemented in
src/big_integer/chip.rs) against the TPU-native trace builder. Semantics are
kept bit-exact (same limb decompositions, same carry equations, same
range-check widths) so the reference's hardcoded test vectors pin this
implementation; only the backend differs (vectorized trace instead of halo2
regions).
"""

from __future__ import annotations

import functools

from ..circuit.builder import Builder, Cell
from ..circuit.main_gate import MainGate
from ..circuit.range_chip import NUM_LOOKUP_LIMBS, RangeChip, sublimb_bit_len
from .types import FRESH, MULED, AssignedInteger, RefreshAux


def tag_ops(cls):
    """Wrap every public chip method so its gate rows carry the op name
    (``Builder.op``) — the provenance behind ``checker.explain``'s
    MockProver-style failure locations."""
    for name, fn in list(vars(cls).items()):
        if (
            name.startswith("_")
            or not callable(fn)
            or isinstance(fn, (staticmethod, classmethod))
            or isinstance(vars(cls).get(name), (staticmethod, classmethod))
        ):
            continue

        def _make(name, fn):
            @functools.wraps(fn)
            def wrapped(self, *args, **kwargs):
                with self.b.op(name):
                    return fn(self, *args, **kwargs)

            return wrapped

        setattr(cls, name, _make(name, fn))
    return cls


@tag_ops
class BigIntChip:
    """Chip over a trace builder; ``limb_width``/``bits_len`` as in
    ``BigIntChip::new`` (chip.rs:1174-1185)."""

    def __init__(self, builder: Builder, limb_width: int, bits_len: int):
        assert bits_len % limb_width == 0
        self.b = builder
        self.main_gate = MainGate(builder)
        self.range_chip = RangeChip(builder)
        self.limb_width = limb_width
        self.num_limbs = bits_len // limb_width
        max_word = self.compute_mul_word_max(limb_width, self.num_limbs)
        assert max_word.bit_length() <= builder.field.num_bits

    # ------------------------------------------------------------------
    # assignment
    # ------------------------------------------------------------------

    def assign_integer(self, value: int, num_limbs: int | None = None) -> AssignedInteger:
        """Witness a Fresh integer; every limb lookup-range-checked to
        ``limb_width`` bits (chip.rs:62-82)."""
        w = self.limb_width
        n = num_limbs if num_limbs is not None else self.num_limbs
        assert 0 <= value < (1 << (w * n)), "integer does not fit"
        limbs = []
        sub = sublimb_bit_len(w)
        for i in range(n):
            limb_val = (value >> (w * i)) & ((1 << w) - 1)
            limbs.append(self.range_chip.assign(limb_val, sub, w))
        return AssignedInteger(limbs, FRESH)

    def assign_constant_fresh(self, value: int) -> AssignedInteger:
        """Constant Fresh integer with the default limb count (chip.rs:95-102)."""
        return self._assign_constant(value, self.num_limbs, FRESH)

    def assign_constant_muled(self, value: int, num_limbs_l: int, num_limbs_r: int) -> AssignedInteger:
        """Constant Muled integer with l+r-1 limbs (chip.rs:119-128)."""
        return self._assign_constant(value, num_limbs_l + num_limbs_r - 1, MULED)

    def max_value(self, num_limbs: int) -> AssignedInteger:
        """Integer with every limb = 2^w - 1 (chip.rs:138-154)."""
        limb_max = (1 << self.limb_width) - 1
        limbs = [self.main_gate.assign_constant(limb_max) for _ in range(num_limbs)]
        return AssignedInteger(limbs, FRESH)

    def assign_constant(self, value: int, max_num_limbs: int) -> AssignedInteger:
        """Constant Fresh integer with an explicit limb budget (the generic
        internal ``assign_constant``, chip.rs:1252-1281 — public here because
        reference tests call it, e.g. chip.rs:2255)."""
        return self._assign_constant(value, max_num_limbs, FRESH)

    def _assign_constant(self, value: int, max_num_limbs: int, tag: str) -> AssignedInteger:
        """chip.rs:1252-1281: constant limbs, zero-padded to max_num_limbs."""
        w = self.limb_width
        bits = value.bit_length()
        n = max(1, (bits + w - 1) // w) if bits else 1
        # reference computes n = ceil(bits/w) (with n=0 for value=0, then pads)
        if bits == 0:
            n = 0
        assert n <= max_num_limbs
        limbs = []
        for i in range(n):
            limbs.append(
                self.main_gate.assign_constant((value >> (w * i)) & ((1 << w) - 1))
            )
        zero = self.main_gate.assign_constant(0)
        limbs.extend([zero] * (max_num_limbs - n))
        return AssignedInteger(limbs, tag)

    # ------------------------------------------------------------------
    # refresh (Muled -> Fresh)
    # ------------------------------------------------------------------

    def refresh(self, a: AssignedInteger, aux: RefreshAux) -> AssignedInteger:
        """Renormalize overflowed limbs by repeated div-mod-2^w with the
        carry schedule from ``aux`` (chip.rs:168-233)."""
        assert a.tag == MULED
        assert self.limb_width == aux.limb_width
        increased = aux.increased_limbs_vec
        assert a.num_limbs == aux.num_limbs_l + aux.num_limbs_r - 1
        num_limbs_fresh = len(increased)

        mg = self.main_gate
        zero = mg.assign_constant(0)
        refreshed = [a.limb(i) for i in range(a.num_limbs)]
        refreshed += [zero] * (num_limbs_fresh - a.num_limbs)
        limb_max = mg.assign_constant(1 << self.limb_width)
        for i in range(num_limbs_fresh):
            limb = refreshed[i]
            for j in range(increased[i] + 1):
                q, n = self._div_mod_main_gate(limb, limb_max)
                if j == 0:
                    refreshed[i] = n
                else:
                    refreshed[i + j] = mg.add(refreshed[i + j], n)
                limb = q
            mg.assert_zero(limb)
        # re-range-check the fresh limbs (chip.rs:215-226)
        sub = sublimb_bit_len(self.limb_width)
        for i in range(num_limbs_fresh):
            ranged = self.range_chip.assign(
                self.b.val(refreshed[i]), sub, self.limb_width
            )
            mg.assert_equal(refreshed[i], ranged)
            refreshed[i] = ranged
        return AssignedInteger(refreshed, FRESH)

    # ------------------------------------------------------------------
    # add / sub
    # ------------------------------------------------------------------

    def add(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """Limb-aligned schoolbook add with range-checked carry witnesses
        (chip.rs:245-297). Result has max(n1, n2) + 1 limbs."""
        assert a.tag == FRESH and b.tag == FRESH
        w = self.limb_width
        mg = self.main_gate
        n1, n2 = a.num_limbs, b.num_limbs
        max_n = max(n1, n2)
        zero = mg.assign_constant(0)
        a = a.clone()
        a.extend_limbs(max_n - n1, zero)
        b = b.clone()
        b.extend_limbs(max_n - n2, zero)

        c_vals = []
        carrys = [zero]
        limb_max = 1 << w
        limb_max_val = mg.assign_constant(limb_max)
        sub = sublimb_bit_len(w)
        for i in range(max_n):
            a_b = mg.add(a.limb(i), b.limb(i))
            s = mg.add(a_b, carrys[i])
            s_val = self.b.val(s)
            c = self.range_chip.assign(s_val % limb_max, sub, w, source=s)
            # the carry is range-checked to a full limb width, mirroring
            # chip.rs:282 (it is 0/1 in honest traces).
            carry = self.range_chip.assign(s_val >> w, sub, w, source=s, source_shift=w)
            c_add_carry = mg.mul_add(carry, limb_max_val, c)
            mg.assert_equal(s, c_add_carry)
            c_vals.append(c)
            carrys.append(carry)
        c_vals.append(carrys[max_n])
        return AssignedInteger(c_vals, FRESH)

    def sub(self, a: AssignedInteger, b: AssignedInteger) -> tuple[AssignedInteger, Cell]:
        """|a - b| plus an overflow bit, via the inflate-by-max trick
        (chip.rs:310-373): compute a + max - b; the n2-th limb of the result
        decides the sign; select operands and re-subtract checked."""
        assert a.tag == FRESH and b.tag == FRESH
        mg = self.main_gate
        n2 = b.num_limbs
        max_int = self.max_value(n2)
        inflated_a = self.add(a, max_int)
        inflated_subed = self._sub_unchecked(inflated_a, b)
        one = mg.assign_bit(1)
        is_not_overflowed = mg.is_equal(inflated_subed.limb(n2), one)
        is_overflowed = mg.not_(is_not_overflowed)

        num_limbs_l = inflated_subed.num_limbs
        num_limbs_r = max(a.num_limbs, n2)
        zero = mg.assign_constant(0)

        sel_l = []
        for i in range(num_limbs_l):
            if i >= n2:
                sel_l.append(mg.select(inflated_subed.limb(i), zero, is_not_overflowed))
            else:
                sel_l.append(
                    mg.select(inflated_subed.limb(i), b.limb(i), is_not_overflowed)
                )
        sel_r = []
        for i in range(num_limbs_r):
            if i >= a.num_limbs:
                sel_r.append(mg.select(max_int.limb(i), zero, is_not_overflowed))
            elif i >= n2:
                sel_r.append(mg.select(zero, a.limb(i), is_not_overflowed))
            else:
                sel_r.append(mg.select(max_int.limb(i), a.limb(i), is_not_overflowed))

        real_subed = self._sub_unchecked(
            AssignedInteger(sel_l, FRESH), AssignedInteger(sel_r, FRESH)
        )
        return real_subed, is_overflowed

    def _sub_unchecked(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """a - b for a >= b: witness c limbs (range-checked), assert a == b + c
        (chip.rs:1286-1318)."""
        w = self.limb_width
        assert a.num_limbs >= b.num_limbs
        max_n = a.num_limbs
        a_val = a.to_int(self.b, w)
        b_val = b.to_int(self.b, w)
        assert a_val >= b_val, "sub_unchecked requires a >= b"
        c_val = a_val - b_val
        sub = sublimb_bit_len(w)
        big_id = self.b.add_bigop(
            ("sub", tuple(c.idx for c in a.limbs), tuple(c.idx for c in b.limbs), w)
        )
        c_limbs = []
        for j in range(max_n):
            raw = self.b.new_cell(c_val & ((1 << w) - 1), ("bigsub", big_id, j))
            c_limbs.append(
                self.range_chip.assign(self.b.val(raw), sub, w, source=raw)
            )
            c_val >>= w
        c = AssignedInteger(c_limbs, FRESH)
        added = self.add(b, c)
        self.assert_equal_fresh(a, added)
        return c

    # ------------------------------------------------------------------
    # mul
    # ------------------------------------------------------------------

    def mul(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """O(n^2) schoolbook polynomial product via mul_add chains
        (chip.rs:386-419; deliberately no xJsnark regrouping — additions are
        not free in PLONK)."""
        assert a.tag == FRESH and b.tag == FRESH
        d0, d1 = a.num_limbs, b.num_limbs
        d = d0 + d1 - 1
        mg = self.main_gate
        c_vals = []
        for i in range(d):
            acc = mg.assign_constant(0)
            j = 0 if d1 >= i + 1 else i + 1 - d1
            while j < d0 and j <= i:
                acc = mg.mul_add(a.limb(j), b.limb(i - j), acc)
                j += 1
            c_vals.append(acc)
        return AssignedInteger(c_vals, MULED)

    def square(self, a: AssignedInteger) -> AssignedInteger:
        return self.mul(a, a)

    # ------------------------------------------------------------------
    # modular ops
    # ------------------------------------------------------------------

    def add_mod(
        self, a: AssignedInteger, b: AssignedInteger, n: AssignedInteger
    ) -> AssignedInteger:
        """(a + b) mod n, requiring a < n and b < n (chip.rs:452-481)."""
        mg = self.main_gate
        added = self.add(a, b)
        subed, is_overflowed = self.sub(added, n)
        num_limbs = subed.num_limbs
        zero = mg.assign_constant(0)
        added = added.clone()
        added.extend_limbs(num_limbs - added.num_limbs, zero)
        res = []
        for i in range(num_limbs):
            res.append(mg.select(added.limb(i), subed.limb(i), is_overflowed))
        for i in range(n.num_limbs, num_limbs):
            mg.assert_zero(res[i])
        return AssignedInteger(res[: n.num_limbs], FRESH)

    def sub_mod(
        self, a: AssignedInteger, b: AssignedInteger, n: AssignedInteger
    ) -> AssignedInteger:
        """(a - b) mod n, requiring a < n and b < n (chip.rs:495-528)."""
        mg = self.main_gate
        subed1, is_overflowed1 = self.sub(a, b)  # |a-b|
        subed2, is_overflowed2 = self.sub(n, subed1)  # n - |a-b|
        mg.assert_zero(is_overflowed2)
        num_limbs = subed2.num_limbs
        zero = mg.assign_constant(0)
        subed1 = subed1.clone()
        subed1.extend_limbs(num_limbs - subed1.num_limbs, zero)
        res = []
        for i in range(num_limbs):
            res.append(mg.select(subed2.limb(i), subed1.limb(i), is_overflowed1))
        for i in range(n.num_limbs, num_limbs):
            mg.assert_zero(res[i])
        return AssignedInteger(res[: n.num_limbs], FRESH)

    def mul_mod(
        self, a: AssignedInteger, b: AssignedInteger, n: AssignedInteger
    ) -> AssignedInteger:
        """(a * b) mod n — the single hot gadget (chip.rs:542-629).

        Witness q, r = divmod(a*b, n) off-circuit, range-check their limbs,
        then assert a*b == q*n + r over Muled integers via the carry-equality
        gadget."""
        w = self.limb_width
        mg = self.main_gate
        n1 = a.num_limbs
        n2 = b.num_limbs
        assert n1 == n.num_limbs
        a_big = a.to_int(self.b, w)
        b_big = b.to_int(self.b, w)
        n_big = n.to_int(self.b, w)
        q_big, r_big = divmod(a_big * b_big, n_big)

        sub = sublimb_bit_len(w)
        mask = (1 << w) - 1
        big_id = self.b.add_bigop(
            (
                "divmod",
                tuple(c.idx for c in a.limbs),
                tuple(c.idx for c in b.limbs),
                tuple(c.idx for c in n.limbs),
                w,
            )
        )
        q_limbs = []
        for i in range(n2):
            raw = self.b.new_cell((q_big >> (w * i)) & mask, ("bigq", big_id, i))
            q_limbs.append(self.range_chip.assign(self.b.val(raw), sub, w, source=raw))
        assert q_big >> (w * n2) == 0
        r_limbs = []
        for i in range(n1):
            raw = self.b.new_cell((r_big >> (w * i)) & mask, ("bigr", big_id, i))
            r_limbs.append(self.range_chip.assign(self.b.val(raw), sub, w, source=raw))
        quotient_int = AssignedInteger(q_limbs, FRESH)
        prod_int = AssignedInteger(r_limbs, FRESH)

        ab = self.mul(a, b)
        qn = self.mul(quotient_int, n)
        n_sum = n1 + n2
        eq_a = []
        eq_b = []
        for i in range(n_sum - 1):
            eq_a.append(ab.limb(i))
            if i < n1:
                eq_b.append(mg.add(qn.limb(i), prod_int.limb(i)))
            else:
                eq_b.append(qn.limb(i))
        self.assert_equal_muled(
            AssignedInteger(eq_a, MULED), AssignedInteger(eq_b, MULED), n1, n2
        )
        return prod_int

    def square_mod(self, a: AssignedInteger, n: AssignedInteger) -> AssignedInteger:
        return self.mul_mod(a, a, n)

    def pow_mod(
        self,
        a: AssignedInteger,
        e: AssignedInteger,
        n: AssignedInteger,
        exp_limb_bits: int,
    ) -> AssignedInteger:
        """a^e mod n for a variable exponent: in-circuit bit decomposition of
        e, then per-bit select square-and-multiply (chip.rs:664-696)."""
        mg = self.main_gate
        e_bits = []
        for limb in e.limbs:
            e_bits.extend(mg.to_bits(limb, exp_limb_bits))
        acc = self.assign_constant_fresh(1)
        squared = a.clone()
        for e_bit in e_bits:
            muled = self.mul_mod(acc, squared, n)
            for j in range(acc.num_limbs):
                acc.replace_limb(j, mg.select(muled.limb(j), acc.limb(j), e_bit))
            squared = self.square_mod(squared, n)
        return acc

    def pow_mod_fixed_exp(
        self, a: AssignedInteger, e: int, n: AssignedInteger
    ) -> AssignedInteger:
        """a^e mod n for a build-time exponent: LSB-first square-and-multiply,
        skipping mul_mod on zero bits — 17 square_mod + 2 mul_mod for
        e = 65537 (chip.rs:710-742)."""
        num_e_bits = e.bit_length()
        acc = self._assign_constant(1, a.num_limbs, FRESH)
        squared = a.clone()
        for i in range(num_e_bits):
            cur_sq = squared
            squared = self.square_mod(cur_sq, n)
            if (e >> i) & 1:
                acc = self.mul_mod(acc, cur_sq, n)
        return acc

    # ------------------------------------------------------------------
    # comparisons
    # ------------------------------------------------------------------

    def is_zero(self, a: AssignedInteger) -> Cell:
        """AND of per-limb is_zero bits (chip.rs:754-767)."""
        mg = self.main_gate
        bit = mg.assign_bit(1)
        for limb in a.limbs:
            bit = mg.and_(bit, mg.is_zero(limb))
        return bit

    def is_equal_fresh(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        """Per-limb equality AND-chain, zero-extended (chip.rs:780-805)."""
        mg = self.main_gate
        n1, n2 = a.num_limbs, b.num_limbs
        is_a_larger = n1 > n2
        max_n = max(n1, n2)
        bit = mg.assign_bit(1)
        for i in range(max_n):
            if is_a_larger and i >= n2:
                flag = mg.is_zero(a.limb(i))
            elif not is_a_larger and i >= n1:
                flag = mg.is_zero(b.limb(i))
            else:
                flag = mg.is_equal(a.limb(i), b.limb(i))
            bit = mg.and_(bit, flag)
        return bit

    def is_equal_muled(
        self, a: AssignedInteger, b: AssignedInteger, num_limbs_l: int, num_limbs_r: int
    ) -> Cell:
        """Carry-propagating equality for overflowed limbs — the
        "EqualWhenCarried" pattern with lookup-checked carries
        (chip.rs:822-895): verify a - b + word_max stays consistent with an
        accumulated_extra running total."""
        mg = self.main_gate
        min_n = min(num_limbs_l, num_limbs_r)
        word_max = self.compute_mul_word_max(self.limb_width, min_n)
        w = self.limb_width
        num_limbs = num_limbs_l + num_limbs_r - 1
        word_max_width = (2 * word_max).bit_length()
        carry_bits = word_max_width - w

        limb_max = mg.assign_constant(1 << w)
        accumulated_extra = mg.assign_constant(0)
        carry = [mg.assign_constant(0)]
        cs = []
        eq_bit = mg.assign_bit(1)
        for i in range(num_limbs):
            a_b = mg.sub(a.limb(i), b.limb(i))
            s = mg.add_with_constant(a_b, carry[i], word_max)
            new_carry, c = self._div_mod_main_gate(s, limb_max)
            carry.append(new_carry)
            cs.append(c)

            accumulated_extra = mg.add_constant(accumulated_extra, word_max)
            q_acc, mod_acc = self._div_mod_main_gate(accumulated_extra, limb_max)
            cs_acc_eq = mg.is_equal(cs[i], mod_acc)
            eq_bit = mg.and_(eq_bit, cs_acc_eq)
            accumulated_extra = q_acc

            if i < num_limbs - 1:
                ranged = self.range_chip.assign(
                    self.b.val(carry[i + 1]), sublimb_bit_len(carry_bits), carry_bits
                )
                range_eq = mg.is_equal(carry[i + 1], ranged)
                eq_bit = mg.and_(eq_bit, range_eq)
            else:
                final_eq = mg.is_equal(carry[i + 1], accumulated_extra)
                eq_bit = mg.and_(eq_bit, final_eq)
        return eq_bit

    def is_less_than(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        """a < b == (a <= b) AND (a != b) (chip.rs:908-919)."""
        mg = self.main_gate
        is_overflowed = self.is_less_than_or_equal(a, b)
        is_eq = self.is_equal_fresh(a, b)
        return mg.and_(is_overflowed, mg.not_(is_eq))

    def is_less_than_or_equal(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        """Overflow bit of sub(a, b); note it is also 1 when a == b
        (chip.rs:932-941)."""
        _, is_overflowed = self.sub(a, b)
        return is_overflowed

    def is_greater_than(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        return self.main_gate.not_(self.is_less_than_or_equal(a, b))

    def is_greater_than_or_equal(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        return self.main_gate.not_(self.is_less_than(a, b))

    def is_in_field(self, a: AssignedInteger, n: AssignedInteger) -> Cell:
        return self.is_less_than(a, n)

    # ------------------------------------------------------------------
    # assertions (each = is_* then assert_one, chip.rs:1016-1158)
    # ------------------------------------------------------------------

    def assert_zero(self, a: AssignedInteger) -> None:
        self.main_gate.assert_one(self.is_zero(a))

    def assert_equal_fresh(self, a: AssignedInteger, b: AssignedInteger) -> None:
        self.main_gate.assert_one(self.is_equal_fresh(a, b))

    def assert_equal_muled(
        self, a: AssignedInteger, b: AssignedInteger, n1: int, n2: int
    ) -> None:
        self.main_gate.assert_one(self.is_equal_muled(a, b, n1, n2))

    def assert_less_than(self, a: AssignedInteger, b: AssignedInteger) -> None:
        self.main_gate.assert_one(self.is_less_than(a, b))

    def assert_less_than_or_equal(self, a: AssignedInteger, b: AssignedInteger) -> None:
        self.main_gate.assert_one(self.is_less_than_or_equal(a, b))

    def assert_greater_than(self, a: AssignedInteger, b: AssignedInteger) -> None:
        self.main_gate.assert_one(self.is_greater_than(a, b))

    def assert_greater_than_or_equal(self, a: AssignedInteger, b: AssignedInteger) -> None:
        self.main_gate.assert_one(self.is_greater_than_or_equal(a, b))

    def assert_in_field(self, a: AssignedInteger, n: AssignedInteger) -> None:
        self.main_gate.assert_one(self.is_in_field(a, n))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _div_mod_main_gate(self, a: Cell, n: Cell) -> tuple[Cell, Cell]:
        """Witness (q, r) = divmod(a, n) over the *field values* and constrain
        a == n*q + r in one gate row (chip.rs:1323-1349)."""
        mg = self.main_gate
        a_val = self.b.val(a)
        n_val = self.b.val(n)
        q_val, r_val = divmod(a_val, n_val)
        # all in-circuit divisors are powers of two (2^limb_width), so the
        # witness replay provenance is a shift/mask of `a`
        log2_n = n_val.bit_length() - 1
        assert n_val == 1 << log2_n, "div_mod divisor must be a power of two"
        q = mg.assign_value(q_val, prov=("shrmask", a.idx, log2_n, 0))
        r = mg.assign_value(r_val, prov=("shrmask", a.idx, 0, log2_n))
        # n*q + r - a == 0 : slots s0=n, s1=q, s2=r, s3=a
        self.b.gate([n, q, r, a], (0, 0, 1, -1, 0, 1, 0, 0))
        return q, r

    @staticmethod
    def compute_mul_word_max(limb_width: int, min_n: int) -> int:
        """Max limb magnitude of a Muled integer (chip.rs:1368-1372)."""
        out_base = 1 << limb_width
        return min_n * (out_base - 1) ** 2 + (out_base - 1)

    @classmethod
    def compute_range_lens(cls, limb_width: int, num_limbs: int) -> tuple[list, list]:
        """Range-table bit-length parameters (chip.rs:1220-1249). Retained for
        API parity; the trace backend derives tables from recorded lookups."""
        out_comp = limb_width // NUM_LOOKUP_LIMBS
        out_overflow = limb_width % out_comp
        out_base = 1 << limb_width

        fresh_word_max_width = (2 * out_base).bit_length()
        fresh_carry_bits = fresh_word_max_width - limb_width
        fresh_comp = sublimb_bit_len(fresh_carry_bits)
        fresh_overflow = fresh_carry_bits % fresh_comp

        mul_word_max = cls.compute_mul_word_max(limb_width, num_limbs)
        mul_word_max_width = (2 * mul_word_max).bit_length()
        mul_carry_bits = mul_word_max_width - limb_width
        mul_comp = sublimb_bit_len(mul_carry_bits)
        mul_overflow = mul_carry_bits % mul_comp

        return (
            [out_comp, fresh_comp, mul_comp],
            [out_overflow, fresh_overflow, mul_overflow],
        )

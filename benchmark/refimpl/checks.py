"""Gate and lookup violation counts of a witness, in Python integers: a gate
row is violated when q0 w0 + ... + q4 w4 + q_ab w0 w1 + q_cd w2 w3 + q_c is
not 0 mod r, a lookup when its cell is not below 2^bits."""

from __future__ import annotations

from .plonk import R


def violations(st, values: list) -> tuple:
    """(gate rows violated, lookups violated) of ``values`` under the
    structure ``st`` (``plonk.Structure``)."""
    gates = 0
    for s, q in zip(st.gate_idx.tolist(), st.gate_coef):
        w0, w1, w2, w3, w4 = (values[j] for j in s)
        acc = (q[0] * w0 + q[1] * w1 + q[2] * w2 + q[3] * w3 + q[4] * w4
               + q[5] * w0 * w1 + q[6] * w2 * w3 + q[7])
        gates += acc % R != 0
    lookups = sum(int(values[c] >= 1 << bits) for bits, idx in st.lookup_groups
                  for c in idx.tolist())
    return gates, lookups

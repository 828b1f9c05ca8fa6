"""Circuit compilation for the prover.

Counterpart of ``halo2_rsa_tpu/circuit/checker.py:36-128`` — the part the
prover reads: :class:`CompiledCircuit`, :func:`compile_circuit` and
:func:`witness_limbs`. Limb arrays use the port's layout, (..., 8) int32
(little-endian 32-bit limbs). The device constraint checker (``eval_gates``,
``check``, ``run``, ``explain``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fields import vecfield
from ..fields.field import PrimeField
from ..fields.vecfield import FieldConsts
from .builder import Builder

LIMBS = 8


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledCircuit:
    """Frozen, device-ready form of a Builder trace (static per circuit shape)."""

    field: PrimeField
    num_witness: int
    gate_idx: np.ndarray  # (R, 5) int32
    gate_coef_id: np.ndarray  # (R,) int32 — index into coef_table
    coef_table: np.ndarray  # (C, 8, 8) int32 limbs, Montgomery form
    lookup_groups: tuple  # ((bits, idx_array), ...) sorted by bits
    instance_idx: np.ndarray  # (I,) int32

    @property
    def fc(self) -> FieldConsts:
        return vecfield.consts(self.field)

    @property
    def num_gates(self) -> int:
        return self.gate_idx.shape[0]

    @property
    def num_lookups(self) -> int:
        return sum(g[1].shape[0] for g in self.lookup_groups)


def compile_circuit(builder: Builder) -> CompiledCircuit:
    """Freeze a Builder trace into arrays; coefficient rows are
    dictionary-encoded into a (C, 8, 8) table + (R,) ids."""
    field = builder.field
    gate_idx = np.asarray(builder.gate_idx, dtype=np.int32).reshape(-1, 5)

    coef_ids = np.empty(len(builder.gate_coef), dtype=np.int32)
    table: dict[tuple, int] = {}
    for r, row in enumerate(builder.gate_coef):
        hit = table.get(row)
        if hit is None:
            hit = len(table)
            table[row] = hit
        coef_ids[r] = hit
    coef_table = np.empty((len(table), 8, LIMBS), dtype=np.int32)
    for row, cid in table.items():
        coef_table[cid] = _ints_to_limbs_np([field.to_mont(q) for q in row])

    groups: dict[int, list[int]] = {}
    for idx, bits in builder.lookups:
        groups.setdefault(bits, []).append(idx)
    lookup_groups = tuple(
        (bits, np.asarray(idxs, dtype=np.int32)) for bits, idxs in sorted(groups.items())
    )

    return CompiledCircuit(
        field=field,
        num_witness=builder.num_witness,
        gate_idx=gate_idx,
        gate_coef_id=coef_ids,
        coef_table=coef_table,
        lookup_groups=lookup_groups,
        instance_idx=np.asarray(builder.instance, dtype=np.int32),
    )


def _ints_to_limbs_np(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> (len, 8) int32 limbs."""
    buf = b"".join(int(v).to_bytes(4 * LIMBS, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, LIMBS).view(np.int32).copy()


def witness_limbs(builder_or_values) -> np.ndarray:
    """Witness values (Python ints, standard form) -> (W, 8) int32 limbs."""
    values = (
        builder_or_values.values
        if isinstance(builder_or_values, Builder)
        else builder_or_values
    )
    if not len(values):
        return np.zeros((0, LIMBS), np.int32)
    return _ints_to_limbs_np(values)

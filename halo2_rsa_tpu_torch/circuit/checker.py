"""Circuit compilation and the vectorized constraint checker — the
MockProver analog.

Counterpart of ``halo2_rsa_tpu/circuit/checker.py``. halo2's
``MockProver::run`` + ``verify()`` re-synthesizes a circuit and sweeps
every row of every gate and lookup on the host; here the trace is already
vectorized, so checking gathers the witness by the gate index arrays and
evaluates the 8-coefficient gate relation for all rows at once, on the
device of the witness tensor. Lookups of one bit width are one vectorized
bound compare.

Limb arrays use the port's layout, (..., 8) int32 (little-endian 32-bit
limbs; the int32 bit pattern is the uint32 limb). Evaluation happens in the
Montgomery domain: every term of the gate relation carries exactly one
extra factor R, so the relation holds iff the Montgomery-domain sum is
zero. Every product goes through ``vecfield.mont_mul``: K1 on a CUDA
tensor, its plain version on a CPU tensor. ``check``, ``run``,
``failing_gates`` and ``explain`` run on ``device`` ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fields import vecfield
from ..fields.cuda_mont import u64
from ..fields.field import PrimeField
from ..fields.vecfield import FieldConsts, add, is_zero, mont_mul
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


# ---------------------------------------------------------------------------
# evaluation (pure functions of tensors; leading axes batch over witnesses)
# ---------------------------------------------------------------------------


def eval_gates(fc: FieldConsts, gate_idx, coef, w_mont):
    """Evaluate the gate relation for all rows.

    gate_idx (R, 5) int64; coef (R, 8, 8) Montgomery limbs; w_mont (..., W,
    8) — leading axes batch over witness instances sharing one trace shape.
    Returns (..., R) bool — True where the row is satisfied."""
    ws = [w_mont[..., gate_idx[:, k], :] for k in range(5)]
    acc = coef[:, 7]  # q_const (Montgomery ⇒ carries the same single R factor)
    for k in range(5):
        acc = add(fc, acc, mont_mul(fc, coef[:, k], ws[k]))
    acc = add(fc, acc, mont_mul(fc, coef[:, 5], mont_mul(fc, ws[0], ws[1])))
    acc = add(fc, acc, mont_mul(fc, coef[:, 6], mont_mul(fc, ws[2], ws[3])))
    return is_zero(acc)


def eval_lookup(vals_std, bits: int):
    """vals_std (..., 8) standard-form canonical limbs -> (...,) bool:
    v < 2^bits. The limb that holds bit ``bits`` compares as unsigned."""
    q, rem = divmod(bits, 32)
    ok = torch.ones(vals_std.shape[:-1], dtype=torch.bool, device=vals_std.device)
    lo = q  # first limb index that must be all-zero
    if rem:
        ok = ok & (u64(vals_std[..., q]) < (1 << rem))
        lo = q + 1
    for j in range(lo, LIMBS):
        ok = ok & (vals_std[..., j] == 0)
    return ok


def _index(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr, np.int64)).to(device)


def _limbs(w_std, device) -> torch.Tensor:
    """(..., W, 8) int32 limbs, numpy or tensor, on ``device``."""
    if not isinstance(w_std, torch.Tensor):
        w_std = torch.from_numpy(np.ascontiguousarray(w_std, np.int32))
    return w_std.to(device)


def _gates_ok(compiled: CompiledCircuit, w_std: torch.Tensor) -> torch.Tensor:
    """(..., R) bool over standard-form witness limbs; the witness enters
    the Montgomery domain in one product (``vecfield.to_mont``)."""
    dev = w_std.device
    fc = compiled.fc
    coef = torch.from_numpy(compiled.coef_table).to(dev)[_index(compiled.gate_coef_id, dev)]
    return eval_gates(fc, _index(compiled.gate_idx, dev), coef, vecfield.to_mont(fc, w_std))


def check(compiled: CompiledCircuit, w_std, device="cuda") -> dict:
    """Run the full constraint check. ``w_std`` is (W, 8) standard-form
    limbs (numpy or tensor).

    Returns dict(ok, gate_violations, lookup_violations)."""
    w = _limbs(w_std, device)
    gv = (~_gates_ok(compiled, w)).sum()
    lv = torch.zeros((), dtype=torch.int64, device=w.device)
    for bits, idx in compiled.lookup_groups:
        lv = lv + (~eval_lookup(w[_index(idx, w.device)], bits)).sum()
    gv = int(gv)
    lv = int(lv)
    return {"ok": gv == 0 and lv == 0, "gate_violations": gv, "lookup_violations": lv}


def run(builder: Builder, public_inputs: list[int] | None = None, device="cuda") -> dict:
    """One-call MockProver analog: compile, extract witness, check.

    If ``public_inputs`` is given, additionally verifies that the exposed
    instance cells equal them (MockProver::run's public-input argument)."""
    compiled = compile_circuit(builder)
    w = witness_limbs(builder)
    result = check(compiled, w, device=device)
    if public_inputs is not None:
        got = [builder.values[i] for i in compiled.instance_idx]
        want = [x % builder.field.p for x in public_inputs]
        result["instance_ok"] = got == want
        result["ok"] = result["ok"] and result["instance_ok"]
    return result


def failing_gates(compiled: CompiledCircuit, w_std, limit: int = 10, device="cuda") -> list[int]:
    """Debug helper: indices of the first ``limit`` violated gate rows."""
    ok = _gates_ok(compiled, _limbs(w_std, device)).cpu().numpy()
    return list(np.nonzero(~ok)[0][:limit])


def explain(builder: Builder, w_std=None, limit: int = 10, device="cuda") -> list[dict]:
    """MockProver-grade failure report: locate violated constraints and name
    the gadget op that emitted each.

    The capability of halo2 ``MockProver::verify``'s typed ``VerifyFailure``:
    instead of a bare violation count, each entry names the originating
    gadget-op path (recorded by ``Builder.op``), the failing row, its
    witness cells and their values.

    ``w_std``: optional (W, 8) standard-form limb array to check instead of
    the builder's own witness (e.g. a corrupted copy). Returns up to
    ``limit`` entries: {kind, row, op, cells, values} for gates and
    {kind, index, op, cell, value, bits} for lookups; values are Python
    ints."""
    compiled = compile_circuit(builder)
    if w_std is None:
        w_std = witness_limbs(builder)
    if isinstance(w_std, torch.Tensor):
        w_std = w_std.cpu().numpy()
    failures: list[dict] = []

    rows = failing_gates(compiled, w_std, limit, device=device)
    values_of = lambda idxs: [_limbs_to_int_np(w_std[i]) for i in idxs]  # noqa: E731
    for r in rows:
        cells = [int(c) for c in compiled.gate_idx[r]]
        failures.append({
            "kind": "gate",
            "row": int(r),
            "op": builder.gate_tags[r] if r < len(builder.gate_tags) else "",
            "cells": cells,
            "values": values_of(cells),
        })

    if len(failures) < limit:
        w_dev = _limbs(w_std, device)
        for bits, idx in compiled.lookup_groups:
            ok = eval_lookup(w_dev[_index(idx, w_dev.device)], bits).cpu().numpy()
            for j in np.nonzero(~ok)[0]:
                cell = int(idx[j])
                failures.append({
                    "kind": "lookup",
                    "index": int(j),
                    "op": f"range_check[{bits}b]",
                    "cell": cell,
                    "value": _limbs_to_int_np(w_std[cell]),
                    "bits": bits,
                })
                if len(failures) >= limit:
                    break
            if len(failures) >= limit:
                break
    return failures


def format_failures(failures: list[dict]) -> str:
    """Human-readable rendering of :func:`explain` entries."""
    lines = []
    for f in failures:
        if f["kind"] == "gate":
            op = f["op"] or "<untagged>"
            lines.append(
                f"gate row {f['row']} in op '{op}': cells {f['cells']} = "
                f"{[hex(v) for v in f['values']]}"
            )
        else:
            lines.append(
                f"lookup #{f['index']} ({f['op']}): cell {f['cell']} = "
                f"{hex(f['value'])} not < 2^{f['bits']}"
            )
    return "\n".join(lines)


def _limbs_to_int_np(row) -> int:
    """One (8,) int32 limb row -> its value as a Python int."""
    return int.from_bytes(np.ascontiguousarray(row, dtype="<i4").tobytes(), "little")

"""Multi-rank constraint checking.

Counterpart of ``halo2_rsa_tpu/parallel/sharded_checker.py``. The checker's
two long dimensions are split over a (data, rows) mesh (:func:`.comm.make_mesh`):

* ``rows`` — gate rows and lookup entries (the 2^k-row dimension of halo2);
* ``data`` — independent circuit instances (a batch of witnesses).

Each rank evaluates its data block of instances over its rows block of
gates and lookups (``circuit.checker``: K1 for every product). The counts
are summed over the rows group (one all-reduce) and the data blocks are
gathered (one all-gather), so ``check`` returns the per-instance counts, an
``np.ndarray`` of shape (B,), on every rank. Gate rows are padded to a
multiple of the rows axis with rows of all-zero coefficients on cell 0,
lookups with cell 0 (always in range), as in the JAX package. The batch B
must be a multiple of the data axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.checker import CompiledCircuit, eval_gates, eval_lookup, eval_wires
from ..fields import vecfield
from . import comm


def _padded_rows(compiled: CompiledCircuit, d_rows: int) -> tuple:
    """(gate_idx (Rp, 5), coef_id (Rp,), coef_table (C + 1, 8, 8), lookup
    groups), Rp a multiple of d_rows: padded rows use the all-zero
    coefficient row C, padded lookups cell 0."""
    pad_r = -compiled.num_gates % d_rows
    gate_idx = np.concatenate([compiled.gate_idx, np.zeros((pad_r, 5), np.int32)], axis=0)
    zero_cid = compiled.coef_table.shape[0]
    coef_table = np.concatenate(
        [compiled.coef_table, np.zeros((1,) + compiled.coef_table.shape[1:], np.int32)], axis=0)
    coef_id = np.concatenate([compiled.gate_coef_id, np.full((pad_r,), zero_cid, np.int32)])
    lookups = [(bits, np.concatenate([idx, np.zeros((-idx.shape[0] % d_rows,), np.int32)]))
               for bits, idx in compiled.lookup_groups]
    return gate_idx, coef_id, coef_table, lookups


def _block(n: int, d: int, i: int) -> slice:
    return slice(i * (n // d), (i + 1) * (n // d))


def _index(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr, np.int64)).to(device)


class _Sharded:
    def __init__(self, compiled: CompiledCircuit, mesh):
        self.compiled = compiled
        self.mesh = mesh
        self.fc = compiled.fc
        self.d_data = mesh.shape["data"]
        self.d_rows = mesh.shape["rows"]
        gate_idx, coef_id, coef_table, lookups = _padded_rows(compiled, self.d_rows)
        rows = _block(gate_idx.shape[0], self.d_rows, mesh.coords["rows"])
        self.gate_idx_np = gate_idx[rows]
        self.lookup_np = [(bits, idx[_block(idx.shape[0], self.d_rows, mesh.coords["rows"])])
                          for bits, idx in lookups]
        dev = mesh.device
        self.coef = torch.from_numpy(coef_table).to(dev)[_index(coef_id[rows], dev)]

    def _data_block(self, batch: int) -> slice:
        if batch % self.d_data:
            raise ValueError(f"a batch of {batch} does not split over {self.d_data} data ranks")
        return _block(batch, self.d_data, self.mesh.coords["data"])

    def _total(self, viol: torch.Tensor) -> np.ndarray:
        """This rank's per-instance counts over its rows -> every
        instance's total, (B,) on every rank."""
        viol = comm.all_reduce_sum(self.mesh, "rows", viol)
        return comm.all_gather(self.mesh, "data", viol).reshape(-1).cpu().numpy().astype(np.int32)


class ShardedChecker(_Sharded):
    """Row- and batch-sharded constraint evaluation for one circuit shape.
    The witness is replicated along ``rows`` (gate rows gather cells
    anywhere) and split along ``data``."""

    def __init__(self, compiled: CompiledCircuit, mesh):
        super().__init__(compiled, mesh)
        dev = mesh.device
        self.gate_idx = _index(self.gate_idx_np, dev)
        self.lookup_groups = [(bits, _index(idx, dev)) for bits, idx in self.lookup_np]

    def shard_witness(self, w_std_batch) -> torch.Tensor:
        """(B, W, 8) standard-form limbs (numpy or tensor) -> this rank's
        data block on the mesh's device."""
        w = w_std_batch
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.ascontiguousarray(w, np.int32))
        return w[self._data_block(w.shape[0])].to(self.mesh.device)

    def check(self, w_block: torch.Tensor) -> np.ndarray:
        """Per-instance violation counts (B,) from :meth:`shard_witness`'s
        block, the same array on every rank."""
        ok = eval_gates(self.fc, self.gate_idx, self.coef, vecfield.to_mont(self.fc, w_block))
        viol = (~ok).sum(dim=-1)
        for bits, idx in self.lookup_groups:
            viol = viol + (~eval_lookup(w_block[:, idx], bits)).sum(dim=-1)
        return self._total(viol)


class WireShardedChecker(_Sharded):
    """Constraint checking with witness memory scaling 1/D along ``rows``.

    :meth:`route` gathers, once per witness batch and on the host, only this
    rank's block: its instances' operand cells of its gate rows, (B/Dd,
    R/Dr, 5, 8), and their values of its lookup entries — the layout halo2's
    advice columns use. Evaluation is then local to the rank; only the
    counts cross ranks."""

    def route(self, w_std_batch: np.ndarray) -> tuple:
        """(B, W, 8) host witness -> (wires, lookup values) of this rank's
        (data, rows) block, on the mesh's device."""
        w = np.asarray(w_std_batch)[self._data_block(w_std_batch.shape[0])]
        dev = self.mesh.device
        wires = torch.from_numpy(np.ascontiguousarray(w[:, self.gate_idx_np])).to(dev)
        lk_vals = tuple(torch.from_numpy(np.ascontiguousarray(w[:, idx])).to(dev)
                        for _, idx in self.lookup_np)
        return wires, lk_vals

    def check(self, routed) -> np.ndarray:
        """Per-instance violation counts (B,) from :meth:`route`'s output,
        the same array on every rank."""
        wires, lk_vals = routed
        wm = vecfield.to_mont(self.fc, wires)
        viol = (~eval_wires(self.fc, self.coef, [wm[:, :, k] for k in range(5)])).sum(dim=-1)
        for (bits, _), vals in zip(self.lookup_np, lk_vals):
            viol = viol + (~eval_lookup(vals, bits)).sum(dim=-1)
        return self._total(viol)

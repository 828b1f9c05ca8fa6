"""Distributed NTT over the ranks of a mesh axis (four-step / Bailey).

Counterpart of ``halo2_rsa_tpu/parallel/sharded_ntt.py``. Factor N = A · B
and write k = c + A·d (c < A, d < B), i = a·B + b:

    X[c + A·d] = Σ_b [ ω^{bc} · (Σ_a v[a·B+b] · (ω^B)^{ac}) ] · (ω^A)^{bd}

Each rank of the axis holds B/D columns b of the (A, B) matrix and runs:

  1. length-A NTTs down its columns (``prover.ntt._ntt_graph``: K1);
  2. the twiddle ω^{b·c} = hi[e >> h] · lo[e & mask] (e = b·c < N, b the
     rank's global column ids), one K1 product per element, cached per
     (size, direction, rank);
  3. ONE tiled all-to-all (:func:`.comm.all_to_all`): the (A, B/D) block
     is cut into D row tiles, tile j goes to rank j, and the tiles received
     line up along the columns in rank order — (A, B/D) -> (A/D, B);
  4. length-B NTTs along its rows.

The block left on rank r holds X[c + A·d] for its rows c in [r·A/D,
(r+1)·A/D) and every d (:func:`held_indices`). :func:`ntt_sharded` and
:func:`intt_sharded` then all-gather the blocks and transpose them into
natural order, so that every rank returns the whole transform (JAX's GSPMD
does this gather implicitly). The inverse runs the same schedule over
ω^{-1}; the two stages' 1/A and 1/B compose to 1/N.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import vecfield
from ..fields.cuda_mont import LIMBS
from ..fields.field import BN254_FR
from ..fields.vecfield import mont_mul
from ..prover import ntt as ntt_mod
from ..prover.ntt import root_of_unity
from . import comm

FR = vecfield.consts(BN254_FR)
R_MOD = BN254_FR.p


@functools.lru_cache(maxsize=None)
def _full_twiddle_tables(log_n: int, inverse: bool):
    """Two-level tables covering exponents < N: W^e = hi[e >> h]·lo[e & mask]."""
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, R_MOD)
    h = (log_n + 1) // 2
    lo = [pow(w, j, R_MOD) for j in range(1 << h)]
    hi = [pow(w, j << h, R_MOD) for j in range(1 << (log_n - h))]
    return (
        h,
        vecfield.from_ints_np(FR, lo, mont=True),
        vecfield.from_ints_np(FR, hi, mont=True),
    )


def _split(log_n: int, d: int) -> tuple[int, int]:
    """log_A, log_B with A·B = N and d | A, d | B (both stages shardable)."""
    log_d = max(0, (d - 1).bit_length())
    log_a = log_n // 2
    log_b = log_n - log_a
    assert min(log_a, log_b) >= log_d, (
        f"N=2^{log_n} too small to four-step over {d} devices"
    )
    return log_a, log_b


_TW_CACHE: dict = {}


def _block_twiddles(log_n: int, inverse: bool, d: int, r: int, device) -> torch.Tensor:
    """(A, B/D, 8) twiddles ω^{b·c} of rank r's columns b."""
    key = (log_n, inverse, d, r, torch.device(device))
    hit = _TW_CACHE.get(key)
    if hit is None:
        log_a, log_b = _split(log_n, d)
        b_loc = (1 << log_b) // d
        h, lo_np, hi_np = _full_twiddle_tables(log_n, inverse)
        b_ids = r * b_loc + torch.arange(b_loc, device=device)
        c_ids = torch.arange(1 << log_a, device=device)
        e = c_ids[:, None] * b_ids[None, :]  # (A, B_loc) < N
        lo = torch.from_numpy(lo_np).to(device)
        hi = torch.from_numpy(hi_np).to(device)
        hit = mont_mul(FR, hi[e >> h], lo[e & ((1 << h) - 1)])
        _TW_CACHE[key] = hit
    return hit


def _local_ntt(rows: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Length-2^log_n NTTs along axis -2 of (..., 2^log_n, 8)."""
    lead = rows.shape[:-2]
    flat = rows.reshape(-1, 1 << log_n, LIMBS)
    tw = ntt_mod._twiddles_full(log_n, inverse, rows.device)
    return ntt_mod._ntt_graph(flat, log_n, inverse, tw).reshape(rows.shape)


def _four_step_block(block: torch.Tensor, log_n: int, inverse: bool, mesh, axis: str):
    """One rank's four steps: its columns (P, A, B/D, 8) -> its rows
    (P, A/D, B, 8)."""
    d = mesh.shape[axis]
    log_a, log_b = _split(log_n, d)
    p, a_len, b_loc, _ = block.shape
    # 1. length-A NTT down each local column (columns to the batch axis)
    y = _local_ntt(block.transpose(1, 2), log_a, inverse).transpose(1, 2)
    # 2. twiddle ω^{b·c}
    y = mont_mul(FR, y, _block_twiddles(log_n, inverse, d, mesh.coords[axis], block.device))
    # 3. the one exchange: row tile j to rank j, the rank axis first
    tiles = y.reshape(p, d, a_len // d, b_loc, LIMBS).transpose(0, 1)
    got = comm.all_to_all(mesh, axis, tiles)  # (D, P, A/D, B/D, 8): got[s] from rank s
    y = got.permute(1, 2, 0, 3, 4).reshape(p, a_len // d, d * b_loc, LIMBS)
    # 4. length-B NTT along each local row
    return _local_ntt(y, log_b, inverse)


def column_block(x: torch.Tensor, log_n: int, mesh, axis: str) -> torch.Tensor:
    """Rank r's columns of natural-order (P, N, 8) values: (P, A, B/D, 8)."""
    d = mesh.shape[axis]
    log_a, log_b = _split(log_n, d)
    b_loc = (1 << log_b) // d
    r = mesh.coords[axis]
    m = x.reshape(x.shape[0], 1 << log_a, 1 << log_b, LIMBS)
    return m[:, :, r * b_loc : (r + 1) * b_loc]


@functools.lru_cache(maxsize=None)
def held_indices(log_n: int, d: int, r: int) -> np.ndarray:
    """The global indices c + A·d' of the block rank r holds after the four
    steps, in the block's (row, column) order: (A/D · B,)."""
    log_a, log_b = _split(log_n, d)
    a_loc = (1 << log_a) // d
    c = r * a_loc + np.arange(a_loc)
    return (c[:, None] + (np.arange(1 << log_b) << log_a)[None, :]).reshape(-1)


def gather_natural(blocks: torch.Tensor, log_n: int, mesh, axis: str) -> torch.Tensor:
    """Every rank's (P, A/D, B, 8) four-step output -> the whole (P, N, 8)
    transform in natural order, on every rank (one all-gather)."""
    p = blocks.shape[0]
    full = comm.all_gather(mesh, axis, blocks)  # (D, P, A/D, B, 8)
    # full[s, :, c_l, d'] = X[s·A/D + c_l + A·d']: order (d', s, c_l)
    return full.permute(1, 3, 0, 2, 4).reshape(p, 1 << log_n, LIMBS)


def _transform(x: torch.Tensor, log_n: int, mesh, axis: str, inverse: bool) -> torch.Tensor:
    batched = x.dim() == 3
    xb = x if batched else x[None]
    out = _four_step_block(column_block(xb, log_n, mesh, axis), log_n, inverse, mesh, axis)
    out = gather_natural(out, log_n, mesh, axis)
    return out if batched else out[0]


def ntt_sharded(x: torch.Tensor, log_n: int, mesh, axis: str = "rows") -> torch.Tensor:
    """Forward NTT of (N, 8) or (P, N, 8) Montgomery limbs, held whole on
    every rank, sharded over ``mesh``'s ``axis``; returns the whole result
    on every rank. Bit-identical to :func:`..prover.ntt.ntt`."""
    return _transform(x, log_n, mesh, axis, False)


def intt_sharded(x: torch.Tensor, log_n: int, mesh, axis: str = "rows") -> torch.Tensor:
    """Inverse NTT (includes the 1/N scale); sharded counterpart of
    :func:`..prover.ntt.intt`."""
    return _transform(x, log_n, mesh, axis, True)


@functools.lru_cache(maxsize=None)
def _column_plan(log_n: int, d: int, r: int):
    """How the four-step output blocks become the column blocks a second
    four-step reads: (rows of rank r's block to send, in send order; the
    count for each rank; the count from each rank; the order that puts the
    received rows in place; whether any row changes rank at all)."""
    log_a, log_b = _split(log_n, d)
    a_len, b_len = 1 << log_a, 1 << log_b
    a_loc, b_loc = a_len // d, b_len // d

    def wanted(e):  # rank e's column block, global indices in (a, b_l) order
        return (np.arange(a_len)[:, None] * b_len + e * b_loc + np.arange(b_loc)[None, :]).reshape(-1)

    def owner_pos(g):  # g = c + A·d' lies in block c // a_loc at (c % a_loc, d')
        c = g & (a_len - 1)
        return c // a_loc, (c % a_loc) * b_len + (g >> log_a)

    plans = []
    for s in range(d):
        send = [owner_pos(wanted(e)) for e in range(d)]
        send = [pos[own == s] for own, pos in send]
        own, _ = owner_pos(wanted(s))
        recv = [int((own == j).sum()) for j in range(d)]
        order = np.concatenate([np.nonzero(own == j)[0] for j in range(d)])
        plans.append((np.concatenate(send), [len(x) for x in send], recv, np.argsort(order)))
    cross = any(plans[s][1][e] for s in range(d) for e in range(d) if e != s)
    return plans[r] + (cross,)


def held_to_columns(held: torch.Tensor, log_n: int, mesh, axis: str) -> torch.Tensor:
    """(P, A/D·B, 8) values at :func:`held_indices` (a four-step output) ->
    this rank's column block (P, A, B/D, 8) of the same vector, the input of
    a second four-step. The rows that change rank move in one
    :func:`.comm.all_to_all_v`; when none does (log2 N even: A = B and each
    rank's rows are its columns), nothing is exchanged."""
    d = mesh.shape[axis]
    log_a, log_b = _split(log_n, d)
    send, send_n, recv_n, place, cross = _column_plan(log_n, d, mesh.coords[axis])
    dev = held.device
    rows = held[:, torch.from_numpy(send).to(dev)].transpose(0, 1)  # (rows, P, 8)
    if cross:
        rows = comm.all_to_all_v(mesh, axis, rows, send_n, recv_n)
    cols = rows[torch.from_numpy(place).to(dev)].transpose(0, 1)
    return cols.reshape(held.shape[0], 1 << log_a, (1 << log_b) // d, LIMBS)

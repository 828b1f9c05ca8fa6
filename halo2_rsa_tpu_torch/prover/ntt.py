"""Radix-2 NTT over BN254 Fr in PyTorch.

Counterpart of ``halo2_rsa_tpu/prover/ntt.py``: the constant-geometry
(Pease) decimation-in-frequency transform. Every one of the log2(N) stages
applies the same data movement

    s_i = x_i + x_{i+N/2}
    d_i = (x_i - x_{i+N/2}) * W^{(i >> t) << t}
    x'  = interleave(s, d)

and the bit-reversed output is put back in natural order by one gather. The
stage loop is a Python loop of torch ops; its Montgomery products go to K1.
Stage twiddles are assembled from two sqrt(N)-sized tables and cached per
(size, direction, device) up to ``_TW_FULL_MAX_LOG_N``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import vecfield
from ..fields.cuda_mont import LIMBS
from ..fields.field import BN254_FR
from ..fields.vecfield import add, mont_mul, sub

FR = vecfield.consts(BN254_FR)
R_MOD = BN254_FR.p

TWO_ADICITY = 28


@functools.lru_cache(maxsize=None)
def _max_root() -> int:
    """An element of multiplicative order exactly 2^TWO_ADICITY."""
    odd = (R_MOD - 1) >> TWO_ADICITY
    g = 2
    while True:
        c = pow(g, odd, R_MOD)
        if pow(c, 1 << (TWO_ADICITY - 1), R_MOD) != 1:
            return c
        g += 1


@functools.lru_cache(maxsize=None)
def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity in Fr."""
    assert log_n <= TWO_ADICITY
    return pow(_max_root(), 1 << (TWO_ADICITY - log_n), R_MOD)


@functools.lru_cache(maxsize=None)
def _twiddle_tables(log_n: int, inverse: bool):
    """Two-level twiddle tables for exponents < N/2 (host numpy, Montgomery):
    W^e = hi[e >> h] * lo[e & (2^h - 1)]."""
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, R_MOD)
    ebits = max(log_n - 1, 1)
    h = (ebits + 1) // 2
    lo = [pow(w, j, R_MOD) for j in range(1 << h)]
    hi = [pow(w, j << h, R_MOD) for j in range(1 << (ebits - h))]
    return h, vecfield.from_ints_np(FR, lo), vecfield.from_ints_np(FR, hi)


@functools.lru_cache(maxsize=None)
def _bitrev(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for i in range(log_n):
        rev |= ((idx >> i) & 1) << (log_n - 1 - i)
    return rev


@functools.lru_cache(maxsize=None)
def _n_inv_mont(log_n: int) -> np.ndarray:
    return vecfield.from_ints_np(FR, [pow(1 << log_n, -1, R_MOD)])[0]


def _stage_twiddles(log_n: int, inverse: bool, t: int, device) -> torch.Tensor:
    """Stage t's (N/2, 8) twiddles W^{(i >> t) << t}, from the sqrt tables."""
    h, lo_tab, hi_tab = _twiddle_tables(log_n, inverse)
    e = (torch.arange(1 << (log_n - 1), device=device) >> t) << t
    lo = torch.from_numpy(lo_tab).to(device)
    hi = torch.from_numpy(hi_tab).to(device)
    return mont_mul(FR, hi[e >> h], lo[e & ((1 << h) - 1)])


_TW_FULL_CACHE: dict = {}

# Above this size the full stage-twiddle tensor (log_n * N/2 * 32 bytes per
# direction) is no longer cheap; the stages then assemble their twiddles.
_TW_FULL_MAX_LOG_N = 20


def _twiddles_full(log_n: int, inverse: bool, device):
    """(log_n, N/2, 8) stage twiddles, built once per (log_n, direction,
    device) and cached; None above _TW_FULL_MAX_LOG_N."""
    if log_n > _TW_FULL_MAX_LOG_N or log_n == 0:
        return None
    key = (log_n, inverse, torch.device(device))
    hit = _TW_FULL_CACHE.get(key)
    if hit is None:
        hit = torch.stack(
            [_stage_twiddles(log_n, inverse, t, device) for t in range(log_n)]
        )
        _TW_FULL_CACHE[key] = hit
    return hit


def _ntt_graph(a: torch.Tensor, log_n: int, inverse: bool, tw_full=None) -> torch.Tensor:
    """Batched Pease NTT over ``a`` (P, N, 8); ``tw_full`` optional
    precomputed stage twiddles (see :func:`_twiddles_full`)."""
    n = 1 << log_n
    p = a.shape[0]
    assert a.shape == (p, n, LIMBS)
    if log_n == 0:
        return a
    half = n // 2
    for t in range(log_n):
        tw = tw_full[t] if tw_full is not None else _stage_twiddles(log_n, inverse, t, a.device)
        top = a[:, :half]
        bot = a[:, half:]
        s = add(FR, top, bot)
        d = mont_mul(FR, sub(FR, top, bot), tw[None])
        a = torch.stack([s, d], dim=2).reshape(p, n, LIMBS)
        del s, d
    a = a[:, torch.from_numpy(_bitrev(log_n)).to(a.device)]
    if inverse:
        a = mont_mul(FR, a, torch.from_numpy(_n_inv_mont(log_n)).to(a.device))
    return a


def ntt(a: torch.Tensor, log_n: int) -> torch.Tensor:
    """Forward NTT. ``a`` (N, 8) Montgomery Fr limbs, N = 2^log_n."""
    return _ntt_graph(a[None], log_n, False, _twiddles_full(log_n, False, a.device))[0]


def intt(a: torch.Tensor, log_n: int) -> torch.Tensor:
    """Inverse NTT (includes the 1/N scale)."""
    return _ntt_graph(a[None], log_n, True, _twiddles_full(log_n, True, a.device))[0]


def ntt_batch(a: torch.Tensor, log_n: int) -> torch.Tensor:
    """Forward NTT over a batch (P, N, 8), one shared twiddle plan."""
    return _ntt_graph(a, log_n, False, _twiddles_full(log_n, False, a.device))


def intt_batch(a: torch.Tensor, log_n: int) -> torch.Tensor:
    """Inverse NTT over a batch (P, N, 8)."""
    return _ntt_graph(a, log_n, True, _twiddles_full(log_n, True, a.device))


# --- host helpers -----------------------------------------------------------


def ntt_host(values: list[int], inverse: bool = False) -> list[int]:
    """O(N^2) host reference DFT over Fr."""
    n = len(values)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, R_MOD)
    out = []
    for i in range(n):
        acc = 0
        for j, v in enumerate(values):
            acc = (acc + v * pow(w, i * j, R_MOD)) % R_MOD
        out.append(acc)
    if inverse:
        n_inv = pow(n, -1, R_MOD)
        out = [x * n_inv % R_MOD for x in out]
    return out

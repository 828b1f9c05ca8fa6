"""K1: batched Montgomery multiplication — the CUDA kernel's wrapper, its
plain PyTorch version, and its launch counter.

Counterpart of ``halo2_rsa_tpu/fields/pallas_mont.py``. The kernel
(``csrc/mont.cu``) replaces ``_mont_mul_kernel_body``: a CIOS over 8 x 32-bit
limbs with 64-bit accumulators, one thread per element.

:func:`mont_mul` takes two ``(..., 8)`` int32 tensors of one shape (the
int32 bit pattern is the uint32 limb). On a CUDA tensor it launches the
kernel; on a CPU tensor it runs :func:`mont_mul_plain`, the same function in
plain torch ops. There is no size threshold and no fallback.

The plain version widens to int64 and works on 16 x 16-bit limbs (torch has
no 64-bit-wide product of two 32-bit limbs in int64 without overflow):
schoolbook column sums, then a word-parallel Montgomery reduction
(m = T·(−p⁻¹) mod R, (T + m·p)/R), with every carry chain resolved by
:func:`carry_normalize`. The result is the unique canonical residue, so it
equals the kernel's and the JAX package's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LIMBS = 8
LAUNCHES = {"mont_mul": 0}

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_CHUNK = 1 << 13  # rows per pass of the plain version (bounds its temporaries)


# ---------------------------------------------------------------------------
# limb helpers shared by the plain versions (int64 lanes, nonnegative limbs)
# ---------------------------------------------------------------------------


def u64(x: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> their uint32 values in int64."""
    return x.to(torch.int64) & _M32


def to_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits (the
    narrowing conversion keeps the low 32 bits)."""
    return u.to(torch.int32)


def _shift_up(c: torch.Tensor, d: int = 1) -> torch.Tensor:
    """Move each limb's value d limbs up (the top d drop, zeros come in)."""
    return F.pad(c[..., :-d], (d, 0))


def carry_normalize(x: torch.Tensor, bits: int, rounds: int = 1):
    """Exact carry propagation over the last axis.

    ``x``: (..., L) int64 limbs in radix 2^bits, each >= 0. ``rounds``
    shift-and-add passes must bring every limb to <= 2^bits: one pass when
    every limb is < 2^(bits + 1), three for 16-bit limbs < 2^48. The last
    0/1 carries are resolved by a Kogge–Stone carry lookahead over the
    limbs (log2(L) steps of generate/propagate), so the op count does not
    depend on the data. Returns (limbs < 2^bits, carry out of the top limb
    (...,))."""
    mask = (1 << bits) - 1
    carry = 0
    for _ in range(rounds):
        c = x >> bits
        carry = carry + c[..., -1]
        x = (x & mask) + _shift_up(c)
    gen = x > mask  # limb is exactly 2^bits: carries out whatever comes in
    prop = x == mask  # carries out only what comes in
    d = 1
    while d < x.shape[-1]:
        gen = gen | (prop & _shift_up(gen, d))
        prop = prop & _shift_up(prop, d)
        d <<= 1
    cout = gen.to(torch.int64)  # carry out of each limb, carry-in 0 at limb 0
    return (x + _shift_up(cout)) & mask, carry + cout[..., -1]


def split16(v: torch.Tensor) -> torch.Tensor:
    """(..., 8) int64 32-bit limbs -> (..., 16) int64 16-bit limbs."""
    return torch.stack((v & _M16, v >> 16), dim=-1).flatten(-2)


def join16(v: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 16-bit limbs -> (..., 8) int64 32-bit limbs."""
    w = v.unflatten(-1, (LIMBS, 2))
    return w[..., 0] | (w[..., 1] << 16)


def _mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of (n, 16)-limb numbers as (n, 32) column sums
    (< 2^36). Few rows: the (16, 16) partial-product matrix, padded to rows
    of 32 and read with a row stride of 31 so that row i shifts right by i,
    summed over rows. Many rows: 16 shifted multiply-adds (no (n, 16, 32)
    temporary)."""
    n = a.shape[0]
    if n <= 256:
        prod = a[:, :, None] * b[:, None, :]  # (n, 16, 16), each < 2^32
        padded = F.pad(prod, (0, 16))
        return padded.as_strided((n, 16, 32), (512, 31, 1)).sum(dim=1)
    out = torch.zeros((n, 32), dtype=torch.int64, device=a.device)
    for i in range(16):
        out[:, i : i + 16] += a[:, i : i + 1] * b
    return out


def _mul_const_cols(a: torch.Tensor, toeplitz: torch.Tensor) -> torch.Tensor:
    """Column sums of a (n, 16)-limb number times a constant, as one float64
    matrix product with the constant's (16, L) Toeplitz matrix: every
    partial sum is an integer < 2^36 < 2^53, so float64 is exact."""
    return (a.to(torch.float64) @ toeplitz).to(torch.int64)


def _redc16(fc, a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    dev = a16.device
    t = _mul_cols(a16, b16)
    t_lo, _ = carry_normalize(t[:, :16], 16, 3)  # T mod R
    m, _ = carry_normalize(_mul_const_cols(t_lo, fc.tensor("nprime_toep", dev)), 16, 3)
    u, _ = carry_normalize(t + _mul_const_cols(m, fc.tensor("p_toep", dev)), 16, 3)
    hi = u[:, 16:]  # (T + m p) / R < 2p
    w, ge = carry_normalize(hi + fc.tensor("pc16", dev), 16)  # hi + 2^256 - p
    return torch.where(ge[:, None] > 0, w, hi)


def mont_mul_u64(fc, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain Montgomery product on int64 lanes: (..., 8) canonical 32-bit
    limbs in and out, both of one shape."""
    shape = a.shape
    a2 = split16(a.reshape(-1, LIMBS))
    b2 = split16(b.reshape(-1, LIMBS))
    outs = [
        join16(_redc16(fc, a2[i : i + _CHUNK], b2[i : i + _CHUNK]))
        for i in range(0, a2.shape[0], _CHUNK)
    ]
    if not outs:
        return torch.empty(shape, dtype=torch.int64, device=a.device)
    return torch.cat(outs, dim=0).reshape(shape)


def mont_mul_plain(fc, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·2⁻²⁵⁶ mod p in plain torch ops; same contract as :func:`mont_mul`."""
    return to_int32(mont_mul_u64(fc, u64(a), u64(b)))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def p_arg(fc):
    """p's limbs as a ctypes uint32[8] (kept alive on the FieldConsts)."""
    arr = getattr(fc, "_p_ctypes", None)
    if arr is None:
        arr = (ctypes.c_uint32 * LIMBS)(*[(fc.field.p >> (32 * j)) & _M32 for j in range(LIMBS)])
        fc._p_ctypes = arr
    return arr


def check_cuda_int32(*ts: torch.Tensor) -> None:
    """What every kernel wrapper requires: CUDA int32 contiguous tensors,
    all of one shape on one device."""
    t0 = ts[0]
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"kernel argument on {t.device}, expected a CUDA tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel argument of dtype {t.dtype}, expected torch.int32")
        if not t.is_contiguous():
            raise ValueError("kernel argument is not contiguous")
        if t.shape != t0.shape or t.device != t0.device:
            raise ValueError("kernel arguments differ in shape or device")


def check_kernel_args(*ts: torch.Tensor) -> None:
    """:func:`check_cuda_int32`, and field elements: a trailing dim of 8."""
    check_cuda_int32(*ts)
    for t in ts:
        if t.shape[-1:] != (LIMBS,):
            raise ValueError(f"kernel argument of shape {tuple(t.shape)}, trailing dim must be 8")


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError_t {err}")


def mont_mul(fc, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product over two (..., 8) int32 tensors of one shape.

    CUDA tensor: launches K1 on the current stream (one thread per
    element). CPU tensor: :func:`mont_mul_plain`."""
    if a.device.type == "cpu":
        return mont_mul_plain(fc, a, b)
    check_kernel_args(a, b)
    from ..utils.cuda_build import library

    out = torch.empty_like(a)
    n = a.numel() // LIMBS
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = library().h2r_mont_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, p_arg(fc), fc.n0inv32, stream
    )
    check_launch(err, "h2r_mont_mul")
    LAUNCHES["mont_mul"] += 1
    return out

"""K1: batched Montgomery multiplication — the CUDA kernels' wrappers, their
plain PyTorch versions, and their launch counters.

Counterpart of ``halo2_rsa_tpu/fields/pallas_mont.py``. The kernel
(``csrc/mont.cu``) replaces ``_mont_mul_kernel_body``: a CIOS over 8 x 32-bit
limbs with 64-bit accumulators, one thread per element, with a broadcast
operand read in place from its distinct rows (:data:`BCAST`). The JAX package
also runs K1 inside compiled loops; the port runs those loops as kernels
of their own on the same CIOS core, each computing the same canonical
residues: :func:`mont_pow`, a whole square-and-multiply per element in one
launch (``csrc/mont_pow.cu``; the JAX package's ``vecfield._pow_bits``), and
:func:`mont_prefix`, a prefix (or suffix) product along a row in at most
three launches (``csrc/mont_scan.cu``; its ``_hs_scan`` of K1 products).

:func:`mont_mul` takes ``(..., 8)`` int32 tensors (the int32 bit pattern
is the uint32 limb), b of a's shape or a's broadcast rows. On a CUDA tensor
each wrapper launches its kernel; on a CPU tensor it runs its ``*_plain``
version, the same function in plain torch ops. There is no size threshold
and no fallback.

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
LAUNCHES = {"mont_mul": 0, "mont_pow": 0, "mont_prefix": 0}
# how mont_mul's b stands for a's n elements, by K1's mode: b of a's shape;
# "cycle", b's nb rows repeated over a's leading axes (element i reads row
# i mod nb); "repeat", each of b's nb rows repeated over a's trailing axes
# (element i reads row i div (n / nb))
BCAST = (None, "cycle", "repeat")
PREFIX_TILE = 512  # elements per tile of K1-prefix (csrc/mont_scan.cu's SCAN_TILE)

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


def expand_rows(b: torch.Tensor, n: int, bcast: str) -> torch.Tensor:
    """The (n, 8) elements that b's rows stand for under ``bcast``."""
    rows = b.reshape(-1, LIMBS)
    if n % rows.shape[0]:
        raise ValueError(f"{rows.shape[0]} broadcast rows do not divide {n} elements")
    if bcast == "cycle":
        return rows.repeat(n // rows.shape[0], 1)
    if bcast == "repeat":
        return rows.repeat_interleave(n // rows.shape[0], dim=0)
    raise ValueError(f"unknown broadcast {bcast!r}")


def mont_mul_plain(fc, a: torch.Tensor, b: torch.Tensor, bcast: str | None = None) -> torch.Tensor:
    """a·b·2⁻²⁵⁶ mod p in plain torch ops; same contract as :func:`mont_mul`."""
    if bcast is not None:
        b = expand_rows(b, a.numel() // LIMBS, bcast).reshape(a.shape)
    return to_int32(mont_mul_u64(fc, u64(a), u64(b)))


def mont_pow_plain(fc, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e by LSB-first square-and-multiply over :func:`mont_mul_plain`
    (the JAX package's ``_pow_bits``); same contract as :func:`mont_pow`."""
    acc = fc.tensor("r_limbs", a.device).expand(a.shape).contiguous()
    sq = a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            acc = mont_mul_plain(fc, acc, sq)
        if i + 1 < e.bit_length():
            sq = mont_mul_plain(fc, sq, sq)
    return acc


def hs_scan(op, fill: torch.Tensor, vals: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive Hillis-Steele scan along axis -2 of (..., N, 8) (the
    suffix scan when ``reverse``); ``fill`` is op's identity row (8,)."""
    n = vals.shape[-2]
    d = 1
    while d < n:
        pad = fill.expand(vals.shape[:-2] + (d, LIMBS))
        if reverse:
            shifted = torch.cat([vals[..., d:, :], pad], dim=-2)
        else:
            shifted = torch.cat([pad, vals[..., :-d, :]], dim=-2)
        vals = op(vals, shifted)
        d <<= 1
    return vals


def mont_prefix_plain(fc, vals: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The prefix product by :func:`hs_scan` over :func:`mont_mul_plain`
    (the JAX package's ``prefix_mul``); same contract as :func:`mont_prefix`."""
    one = fc.tensor("r_limbs", vals.device)
    return hs_scan(lambda a, b: mont_mul_plain(fc, a, b), one, vals, reverse)


def prefix_launches(n: int) -> int:
    """K1-prefix's launches per call for rows of n elements: one when a row
    fits in one tile, else three (tile totals, their scan, the tiles)."""
    return 1 if n <= PREFIX_TILE else 3


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def limbs_arg(x: int):
    """A 256-bit int's limbs as a ctypes uint32[8]."""
    return (ctypes.c_uint32 * LIMBS)(*[(x >> (32 * j)) & _M32 for j in range(LIMBS)])


def p_arg(fc):
    """p's limbs as a ctypes uint32[8] (kept alive on the FieldConsts)."""
    arr = getattr(fc, "_p_ctypes", None)
    if arr is None:
        arr = fc._p_ctypes = limbs_arg(fc.field.p)
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


def mont_mul(fc, a: torch.Tensor, b: torch.Tensor, bcast: str | None = None) -> torch.Tensor:
    """Montgomery product over (..., 8) int32 tensors, in a's shape: b of
    a's shape, or, with ``bcast`` ("cycle" or "repeat", :data:`BCAST`), b's
    rows (any shape (..., 8), nb of them dividing a's n elements) read in
    place for the elements they stand for.

    CUDA tensor (16-byte aligned): launches K1 on the current stream (one
    thread per product; a block size chosen by n). CPU tensor:
    :func:`mont_mul_plain`."""
    if a.device.type == "cpu":
        return mont_mul_plain(fc, a, b, bcast)
    mode = BCAST.index(bcast)
    if mode == 0:
        check_kernel_args(a, b)
    else:
        check_kernel_args(a)
        check_kernel_args(b)
        if b.device != a.device:
            raise ValueError("kernel arguments differ in device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("K1's tensors must be 16-byte aligned")
    n, nb = a.numel() // LIMBS, b.numel() // LIMBS
    out = torch.empty_like(a)
    if n == 0:
        return out
    if mode and (nb == 0 or n % nb or n >= 1 << 32):
        raise ValueError(f"K1 broadcasts {nb} rows over {n} elements: nb must divide n < 2^32")
    from ..utils.cuda_build import library

    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = library().h2r_mont_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, nb, mode, p_arg(fc), fc.n0inv32, stream
    )
    check_launch(err, "h2r_mont_mul")
    LAUNCHES["mont_mul"] += 1
    return out


def mont_pow(fc, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e over a (..., 8) int32 tensor for one exponent 0 <= e < 2^256;
    Montgomery in and out (e = 0 gives Montgomery 1, 0^e = 0 for e > 0).

    CUDA tensor (16-byte aligned): one launch of K1-pow on the current
    stream (one thread per element, the whole square-and-multiply in
    registers). CPU tensor: :func:`mont_pow_plain`."""
    if not 0 <= e < 1 << 256:
        raise ValueError(f"exponent {e} is outside [0, 2^256)")
    if a.device.type == "cpu":
        return mont_pow_plain(fc, a, e)
    check_kernel_args(a)
    if a.data_ptr() % 16:
        raise ValueError("K1-pow's tensor must be 16-byte aligned")
    from ..utils.cuda_build import library

    out = torch.empty_like(a)
    n = a.numel() // LIMBS
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = library().h2r_mont_pow(
        a.data_ptr(), out.data_ptr(), n, limbs_arg(e), e.bit_length(), p_arg(fc), fc.n0inv32,
        stream,
    )
    check_launch(err, "h2r_mont_pow")
    LAUNCHES["mont_pow"] += 1
    return out


def mont_prefix(fc, vals: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix product along axis -2 of a (..., n, 8) int32 tensor,
    or the suffix product (out[i] = vals[i]·…·vals[n-1]) when ``reverse``;
    Montgomery in and out.

    CUDA tensor (16-byte aligned): K1-prefix on the current stream,
    :func:`prefix_launches` launches, the tile totals in a scratch tensor
    allocated here. CPU tensor: :func:`mont_prefix_plain`."""
    if vals.device.type == "cpu":
        return mont_prefix_plain(fc, vals, reverse)
    check_kernel_args(vals)
    if vals.dim() < 2:
        raise ValueError(f"K1-prefix takes rows (..., n, 8), got {tuple(vals.shape)}")
    if vals.data_ptr() % 16:
        raise ValueError("K1-prefix's tensor must be 16-byte aligned")
    from ..utils.cuda_build import library

    lib = library()
    if lib.h2r_mont_prefix_tile() != PREFIX_TILE:
        raise RuntimeError(f"K1-prefix's tile is {lib.h2r_mont_prefix_tile()}, the wrapper's "
                           f"PREFIX_TILE {PREFIX_TILE}")
    out = torch.empty_like(vals)
    if out.numel() == 0:
        return out
    n = vals.shape[-2]
    rows = vals.numel() // (n * LIMBS)
    tiles = -(-n // PREFIX_TILE)
    scratch = (torch.empty((rows, tiles, LIMBS), dtype=torch.int32, device=vals.device)
               if tiles > 1 else None)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = lib.h2r_mont_prefix(
        vals.data_ptr(), out.data_ptr(), rows, n, int(reverse),
        None if scratch is None else scratch.data_ptr(), p_arg(fc), fc.n0inv32, stream,
    )
    check_launch(err, "h2r_mont_prefix")
    LAUNCHES["mont_prefix"] += prefix_launches(n)
    return out

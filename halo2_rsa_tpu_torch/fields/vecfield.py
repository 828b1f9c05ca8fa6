"""Vectorized prime-field arithmetic in PyTorch.

Counterpart of ``halo2_rsa_tpu/fields/vecfield.py`` (``vecfield.py:112-536``).
An element is a canonical Montgomery value (R = 2^256) stored as a
``(..., 8)`` int32 tensor of little-endian 32-bit limbs; the int32 bit
pattern is the uint32 limb. Leading axes are batch axes and broadcast like
any torch op. Every function takes its device from its tensor arguments.

``mont_mul`` goes to K1 (:mod:`.cuda_mont`): the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor. Additions and subtractions are
plain torch ops on both: the limbs widen to int64, and the carry chain is
resolved by :func:`.cuda_mont.carry_normalize` (a fixed number of ops, so no
host synchronisation on the card).

The reference layout is ``(..., 16)`` uint32 arrays of 16-bit limbs; both
layouts hold the same 256-bit value, and :func:`limbs_from_ref` /
:func:`limbs_to_ref` convert between them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_mont
from .cuda_mont import LIMBS, carry_normalize, to_int32, u64
from .field import R_BITS, PrimeField

_M32 = 0xFFFFFFFF


def _limbs32(x: int) -> np.ndarray:
    return np.array([(x >> (32 * j)) & _M32 for j in range(LIMBS)], np.int64)


def _limbs16(x: int) -> np.ndarray:
    return np.array([(x >> (16 * j)) & 0xFFFF for j in range(2 * LIMBS)], np.int64)


def _toeplitz16(x: int, cols: int) -> np.ndarray:
    """(16, cols) float64 matrix T with T[i, i + j] = limb j of x (16-bit
    limbs): a 16-limb row vector times T gives the column sums of its
    product with x, truncated to ``cols`` columns."""
    limbs = _limbs16(x)
    t = np.zeros((2 * LIMBS, cols), np.float64)
    for i in range(2 * LIMBS):
        for j in range(2 * LIMBS):
            if i + j < cols:
                t[i, i + j] = limbs[j]
    return t


class FieldConsts:
    """Constants of one prime field: host ints, numpy limb rows, and the
    same rows as torch tensors cached per device (:meth:`tensor`).

    ``n0inv32`` is −p⁻¹ mod 2^32, the CIOS constant of 32-bit limbs (the
    reference's ``PrimeField.n0inv`` is −p⁻¹ mod 2^16, for 16-bit limbs).
    Obtain instances through :func:`consts`."""

    def __init__(self, field: PrimeField):
        p = field.p
        self.field = field
        self.n0inv32 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.rinv = pow(1 << R_BITS, -1, p)
        self._np = {
            "p32": _limbs32(p),
            "pc32": _limbs32((1 << R_BITS) - p),
            "pc16": _limbs16((1 << R_BITS) - p),
            "p_toep": _toeplitz16(p, 32),
            "nprime_toep": _toeplitz16((-pow(p, -1, 1 << R_BITS)) % (1 << R_BITS), 16),
            "r_limbs": from_ints_np(self, [field.r], mont=False)[0],
            "r2_limbs": from_ints_np(self, [field.r2], mont=False)[0],
            "one_std": from_ints_np(self, [1], mont=False)[0],
        }
        self._cache: dict = {}

    def tensor(self, name: str, device) -> torch.Tensor:
        """Constant row ``name`` on ``device`` (built once per device)."""
        key = (name, torch.device(device))
        t = self._cache.get(key)
        if t is None:
            t = torch.from_numpy(self._np[name]).to(device)
            self._cache[key] = t
        return t

    def __repr__(self) -> str:
        return f"FieldConsts({self.field.name}, p={self.field.p:#x})"


@functools.lru_cache(maxsize=None)
def consts(field: PrimeField) -> FieldConsts:
    return FieldConsts(field)


# ---------------------------------------------------------------------------
# core ops
# ---------------------------------------------------------------------------


def add_u64(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on int64 lanes holding canonical 32-bit limbs."""
    s, _ = carry_normalize(a + b, 32)
    w, ge = carry_normalize(s + fc.tensor("pc32", s.device), 32)  # s + 2^256 - p
    return torch.where(ge[..., None] > 0, w, s)


def sub_u64(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p on int64 lanes: a + (2^256 - 1 - b) + 1, whose carry
    out says a >= b; otherwise p is added back mod 2^256."""
    x = a + (_M32 - b)
    x[..., 0] += 1
    w, ge = carry_normalize(x, 32)
    wp, _ = carry_normalize(w + fc.tensor("p32", w.device), 32)
    return torch.where(ge[..., None] > 0, w, wp)


def add(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    return to_int32(add_u64(fc, u64(a), u64(b)))


def sub(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    return to_int32(sub_u64(fc, u64(a), u64(b)))


def neg(fc: FieldConsts, a: torch.Tensor) -> torch.Tensor:
    return sub(fc, torch.zeros_like(a), a)


def mont_mul(fc: FieldConsts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product (a·b·R⁻¹) mod p; inputs broadcast, outputs canonical."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return cuda_mont.mont_mul(fc, a.contiguous(), b.contiguous())


def to_mont(fc: FieldConsts, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(fc, a, fc.tensor("r2_limbs", a.device))


def from_mont(fc: FieldConsts, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(fc, a, fc.tensor("one_std", a.device))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(...,) bool: whether the limb value is zero."""
    return (a == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def pow_const(fc: FieldConsts, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a Python-int exponent; Montgomery in and out (LSB-first
    square-and-multiply)."""
    acc = fc.tensor("r_limbs", a.device).expand(a.shape).contiguous()
    sq = a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            acc = mont_mul(fc, acc, sq)
        if i + 1 < e.bit_length():
            sq = mont_mul(fc, sq, sq)
    return acc


def inv(fc: FieldConsts, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse via Fermat (a^(p-2)); Montgomery domain; 0 -> 0."""
    return pow_const(fc, a, fc.field.p - 2)


def batch_inv_nz(fc: FieldConsts, a: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick batched inverse of (..., 8) elements, all nonzero:
    x_i^-1 = (prod_{j<i} x_j)(prod_{j>i} x_j)(prod_j x_j)^-1."""
    shape = a.shape
    m = a.reshape(-1, LIMBS)
    pre = prefix_mul(fc, m)
    tinv = inv(fc, pre[-1:])
    one = fc.tensor("r_limbs", a.device)[None]
    pre_excl = torch.cat([one, pre[:-1]], dim=0)
    suf_incl = prefix_mul(fc, m.flip(0)).flip(0)
    suf_excl = torch.cat([suf_incl[1:], one], dim=0)
    out = mont_mul(fc, mont_mul(fc, pre_excl, suf_excl), tinv)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# log-depth scans along axis -2 of (..., N, 8)
# ---------------------------------------------------------------------------


def _hs_scan(op, fill: torch.Tensor, vals: torch.Tensor, reverse: bool = False):
    """Inclusive Hillis-Steele scan along axis -2; ``fill`` is op's identity
    row (8,)."""
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


def prefix_mul(fc: FieldConsts, vals_mont: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product (Montgomery) along axis -2."""
    one = fc.tensor("r_limbs", vals_mont.device)
    return _hs_scan(lambda a, b: mont_mul(fc, a, b), one, vals_mont)


def prefix_add(fc: FieldConsts, vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum mod p along axis -2."""
    zero = torch.zeros(LIMBS, dtype=torch.int32, device=vals.device)
    return _hs_scan(lambda a, b: add(fc, a, b), zero, vals)


def suffix_add(fc: FieldConsts, vals: torch.Tensor) -> torch.Tensor:
    """s_i = sum_{j >= i} vals_j (mod p) along axis -2."""
    zero = torch.zeros(LIMBS, dtype=torch.int32, device=vals.device)
    return _hs_scan(lambda a, b: add(fc, a, b), zero, vals, reverse=True)


def reduce_add(fc: FieldConsts, vals: torch.Tensor) -> torch.Tensor:
    """Sum along axis 0 of (N, ..., 8), mod p: log-depth halving fold."""
    n = vals.shape[0]
    while n > 1:
        half = n // 2
        merged = add(fc, vals[:half], vals[half : 2 * half])
        if n % 2:
            merged = torch.cat([merged, vals[2 * half :]], dim=0)
        vals = merged
        n = vals.shape[0]
    return vals[0]


def pow_series(fc: FieldConsts, x_int: int, n: int, device="cuda") -> torch.Tensor:
    """[x^0, x^1, ..., x^{n-1}] as an (n, 8) Montgomery tensor on ``device``
    (prefix product of the rows [1, x, x, ...])."""
    n = max(n, 1)
    x_m = from_ints(fc, [x_int % fc.field.p], device=device)
    rows = torch.cat([fc.tensor("r_limbs", device)[None], x_m.expand(n - 1, LIMBS)], dim=0)
    return prefix_mul(fc, rows)


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------


def from_ints_np(fc: FieldConsts, xs, mont: bool = True) -> np.ndarray:
    """Python ints -> host (len, 8) int32 limb array."""
    field = fc.field
    if mont:
        xs = [(x % field.p) * field.r % field.p for x in xs]
    else:
        xs = [x % field.p for x in xs]
    buf = b"".join(int(x).to_bytes(4 * LIMBS, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(-1, LIMBS)
    return arr.view(np.int32).copy()


def from_ints(fc: FieldConsts, xs, mont: bool = True, device="cuda") -> torch.Tensor:
    """Python ints -> (len, 8) limb tensor on ``device``."""
    return torch.from_numpy(from_ints_np(fc, xs, mont)).to(device)


def to_ints(fc: FieldConsts, arr, mont: bool = True) -> list[int]:
    """(..., 8) limb tensor or array -> list of Python ints (standard form
    when ``mont``)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.ascontiguousarray(arr, dtype=np.int32).reshape(-1, LIMBS).view("<u4")
    vals = [int.from_bytes(row.tobytes(), "little") for row in flat]
    if mont:
        p, rinv = fc.field.p, fc.rinv
        vals = [v * rinv % p for v in vals]
    return vals


def limbs_from_ref(arr16) -> np.ndarray:
    """Reference layout (..., 16) uint32 16-bit limbs -> (..., 8) int32."""
    a = np.asarray(arr16).astype(np.uint32)
    v = a[..., 0::2] | (a[..., 1::2] << np.uint32(16))
    return np.ascontiguousarray(v).view(np.int32)


def limbs_to_ref(arr8) -> np.ndarray:
    """(..., 8) int32 limbs (array or tensor) -> reference (..., 16) uint32."""
    if isinstance(arr8, torch.Tensor):
        arr8 = arr8.detach().cpu().numpy()
    v = np.ascontiguousarray(arr8, dtype=np.int32).view(np.uint32)
    out = np.stack([v & np.uint32(0xFFFF), v >> np.uint32(16)], axis=-1)
    return out.reshape(v.shape[:-1] + (2 * LIMBS,))

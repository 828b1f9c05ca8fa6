"""BN254 G1 in Python integers: y^2 = x^3 + 3 over q, affine points as
(x, y) and the identity as None; sums in Jacobian coordinates."""

from __future__ import annotations

Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
GEN = (1, 2)
_SQRT_EXP = (Q + 1) // 4  # q = 3 mod 4


def on_curve(p) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - 3) % Q == 0


def decompress(b: bytes):
    """32 bytes, x little-endian with y's parity in bit 255, all zeros for
    the identity; raises ValueError for an encoding of no point."""
    if b == bytes(32):
        return None
    if b[31] & 0x40:
        raise ValueError("reserved flag set")
    x = int.from_bytes(b[:31] + bytes([b[31] & 0x3F]), "little")
    if x >= Q:
        raise ValueError("x out of range")
    rhs = (x * x % Q * x + 3) % Q
    y = pow(rhs, _SQRT_EXP, Q)
    if y * y % Q != rhs:
        raise ValueError("not on the curve")
    if (y & 1) != b[31] >> 7:
        y = Q - y
    return (x, y)


def _dbl(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) ** 2 - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q


def _add(p, r):
    x1, y1, z1 = p
    x2, y2, z2 = r
    if z1 == 0:
        return r
    if z2 == 0:
        return p
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return _dbl(p) if s1 == s2 else (1, 1, 0)
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    rr = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (rr * rr - j - 2 * v) % Q
    y3 = (rr * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) * h % Q
    return x3, y3, z3


def _jac(p):
    return (1, 1, 0) if p is None else (p[0], p[1], 1)


def _affine(p):
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, Q)
    zi2 = zi * zi % Q
    return x * zi2 % Q, y * zi2 * zi % Q


def add(p, r):
    return _affine(_add(_jac(p), _jac(r)))


def neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def msm(scalars, points):
    """sum_i s_i P_i (affine, None for the identity), by 4-bit windows with
    the doublings shared across points."""
    table = []
    for p in points:
        row = [(1, 1, 0), _jac(p)]
        for _ in range(14):
            row.append(_add(row[-1], row[1]))
        table.append(row)
    scs = [s % R for s in scalars]
    acc = (1, 1, 0)
    for win in range(63, -1, -1):
        for _ in range(4):
            acc = _dbl(acc)
        for s, row in zip(scs, table):
            d = (s >> (4 * win)) & 15
            if d:
                acc = _add(acc, row[d])
    return _affine(acc)


def mul_gen(s: int):
    return msm([s], [GEN])

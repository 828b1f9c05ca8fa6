"""BN254 (alt_bn128 / bn256) curve layer.

Host-side reference implementation (Python ints): G1/G2 arithmetic, the Fq
tower (Fq2/Fq6/Fq12), and the optimal-ate pairing — the capability the
reference pulls from halo2's ``bn256`` crate (used at
halo2-rsa `benches/bench.rs:15-27` for the KZG pipeline). The pairing
runs host-side only (2 pairings per proof verification); all bulk G1 work
(MSM) runs on TPU via ``msm.py``.

Curve: y^2 = x^3 + 3 over Fq; G2 on the sextic twist y^2 = x^3 + 3/(9+u).
"""

from __future__ import annotations

from ..fields.field import BN254_FQ, BN254_FR

Q = BN254_FQ.p  # base field modulus
R = BN254_FR.p  # scalar field modulus (group order)

# BN parameter t: q = 36t^4 + 36t^3 + 24t^2 + 6t + 1
BN_T = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_T + 2

G1_GEN = (1, 2)

# Standard BN254 G2 generator (c1*u + c0 encoding below is [c0, c1])
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


# ---------------------------------------------------------------------------
# Fq2 / Fq6 / Fq12 tower (host ints; tuples of coefficients)
# Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - (9+u)); Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0 % Q
    t1 = a1 * b1 % Q
    return ((t0 - t1) % Q, ((a0 + a1) * (b0 + b1) - t0 - t1) % Q)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % Q
    inv = pow(norm, -1, Q)
    return (a0 * inv % Q, (-a1 * inv) % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)
XI = (9, 1)  # the twist constant 9 + u


def fq2_mul_xi(a):
    """Multiply by xi = 9 + u."""
    return fq2_mul(a, XI)


# Fq6 elements: (c0, c1, c2) with c_i in Fq2; v^3 = xi
def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)),
        fq2_mul_xi(t2),
    )
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))), fq2_mul(a0, c0)
    )
    t_inv = fq2_inv(t)
    return (fq2_mul(c0, t_inv), fq2_mul(c1, t_inv), fq2_mul(c2, t_inv))


# Fq12 elements: (c0, c1) with c_i in Fq6; w^2 = v
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_inv(fq6_sub(fq6_sqr(a0), fq6_mul_by_v(fq6_sqr(a1))))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


# Frobenius coefficients for Fq2 components: gamma_1,i = xi^((q-1)*i/6)
_FROB_GAMMA1 = [pow_xi := None]


def _xi_pow(e_num: int, e_den: int):
    """xi^((q-1)*e_num/e_den) in Fq2 via exponentiation."""
    e = (Q - 1) * e_num // e_den
    # compute xi^e by square-and-multiply in Fq2
    result = FQ2_ONE
    base = XI
    while e > 0:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


_G1_ = [_xi_pow(i, 6) for i in range(6)]  # gamma_1,i = xi^(i(q-1)/6)


def fq6_frobenius(a):
    """a -> a^q componentwise with gamma twists."""
    c0 = fq2_conj(a[0])
    c1 = fq2_mul(fq2_conj(a[1]), _G1_[2])
    c2 = fq2_mul(fq2_conj(a[2]), _G1_[4])
    return (c0, c1, c2)


def fq12_frobenius(a):
    a0, a1 = a
    c0 = fq6_frobenius(a0)
    t = fq6_frobenius(a1)
    c1 = tuple(fq2_mul(x, _G1_[1]) for x in t)
    return (c0, c1)


# ---------------------------------------------------------------------------
# G1 / G2 affine+jacobian host arithmetic
# ---------------------------------------------------------------------------


def g1_is_on_curve(P) -> bool:
    if P is None:
        return True
    x, y = P
    return (y * y - x * x * x - 3) % Q == 0


def g1_add(P, Q_):
    """Affine addition with None as infinity (host reference)."""
    if P is None:
        return Q_
    if Q_ is None:
        return P
    x1, y1 = P
    x2, y2 = Q_
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_neg(P):
    if P is None:
        return None
    return (P[0], (-P[1]) % Q)


def g1_mul(P, k: int):
    k %= R
    result = None
    add = P
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_add(add, add)
        k >>= 1
    return result


def g2_is_on_curve(P) -> bool:
    if P is None:
        return True
    x, y = P
    b2 = fq2_mul((3, 0), fq2_inv(XI))
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), b2)
    return lhs == rhs


def g2_add(P, Q_):
    if P is None:
        return Q_
    if Q_ is None:
        return P
    x1, y1 = P
    x2, y2 = Q_
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_scalar(fq2_sqr(x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(P):
    if P is None:
        return None
    return (P[0], fq2_neg(P[1]))


def g2_mul(P, k: int):
    k %= R
    result = None
    add = P
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


G2_GEN = (G2_GEN_X, G2_GEN_Y)


# ---------------------------------------------------------------------------
# Optimal ate pairing
# ---------------------------------------------------------------------------


def _line_double(T, P):
    """Line function of the tangent at T (G2 jacobian-free affine),
    evaluated at P in G1. Returns (new_T, line in Fq12 sparse form)."""
    x_t, y_t = T
    x_p, y_p = P
    lam = fq2_mul(fq2_scalar(fq2_sqr(x_t), 3), fq2_inv(fq2_scalar(y_t, 2)))
    new_t = g2_add(T, T)
    # l(P) = lam * x_p - y_p * 1 ... embedded: (y_p in Fq, terms in Fq12)
    return new_t, _line_eval(lam, T, x_p, y_p)


def _line_add(T, Q_, P):
    x_t, y_t = T
    x_q, y_q = Q_
    lam = fq2_mul(fq2_sub(y_q, y_t), fq2_inv(fq2_sub(x_q, x_t)))
    new_t = g2_add(T, Q_)
    return new_t, _line_eval(lam, T, P[0], P[1])


def _line_eval(lam, T, x_p, y_p):
    """Evaluate the line through the untwist-embedded T at a G1 point.

    D-type twist untwist map (with w^2 = v, v^3 = xi, so w^6 = xi):
    psi(x', y') = (x' w^2, y' w^3). The embedded line slope is lam*w, so

        l(x, y) = (y - y_T w^3) - lam w (x - x_T w^2)
                = y_p  +  (-lam x_p) w  +  (lam x_T - y_T) w^3.

    Fq12 basis mapping w^k: k=0 -> c0.e0, k=1 -> c1.e0, k=2 -> c0.e1,
    k=3 -> c1.e1, k=4 -> c0.e2, k=5 -> c1.e2.
    """
    x_t, y_t = T
    w0 = (y_p % Q, 0)
    w1 = fq2_scalar(lam, (-x_p) % Q)
    w3 = fq2_sub(fq2_mul(lam, x_t), y_t)
    l_c0 = (w0, FQ2_ZERO, FQ2_ZERO)
    l_c1 = (w1, w3, FQ2_ZERO)
    return (l_c0, l_c1)


def miller_loop(P, Q_):
    """Optimal ate Miller loop f_{6t+2, Q}(P) with frobenius end-steps."""
    if P is None or Q_ is None:
        return FQ12_ONE
    f = FQ12_ONE
    T = Q_
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip leading 1
    for bit in bits:
        T, l = _line_double(T, P)
        f = fq12_mul(fq12_sqr(f), l)
        if bit == "1":
            T, l = _line_add(T, Q_, P)
            f = fq12_mul(f, l)
    # frobenius steps: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1 = _g2_frobenius(Q_)
    T, l = _line_add(T, q1, P)
    f = fq12_mul(f, l)
    q2 = g2_neg(_g2_frobenius(q1))
    _, l = _line_add(T, q2, P)
    f = fq12_mul(f, l)
    return f


def _g2_frobenius(P):
    """pi(x, y) = (x^q * gamma_{1,2}, y^q * gamma_{1,3}) on the twist."""
    x, y = P
    x_f = fq2_mul(fq2_conj(x), _G1_[2])
    y_f = fq2_mul(fq2_conj(y), _G1_[3])
    return (x_f, y_f)


def _easy_part(f):
    """f^((q^6 - 1)(q^2 + 1)) — lands in the cyclotomic subgroup."""
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    return fq12_mul(fq12_frobenius(fq12_frobenius(f1)), f1)


def final_exponentiation_generic(f):
    """f^((q^12 - 1) / r) with a generic ~3046-bit hard-part ladder.

    Kept as the correctness oracle for the addition-chain version below
    (tests assert equality); ~13x slower than :func:`final_exponentiation`.
    """
    f2 = _easy_part(f)
    hard = (Q**4 - Q**2 + 1) // R
    return fq12_pow(f2, hard)


_BN_U_BITS = bin(BN_T)[3:]


def _exp_by_u(f):
    """f^u for the BN parameter u (63-bit fixed square-and-multiply)."""
    r = f
    for bit in _BN_U_BITS:
        r = fq12_sqr(r)
        if bit == "1":
            r = fq12_mul(r, f)
    return r


def _hard_part(f):
    """Exact hard part f^((q^4 - q^2 + 1)/r) for BN curves via the Scott et
    al. 2009 vectorial addition chain (3 exps by u + ~13 muls + 4 squarings
    + 7 frobenius), replacing the 3046-bit generic ladder. The chain's
    exponent is verified symbolically equal to the hard part in
    tests/test_curve_msm.py. Input must be in the cyclotomic subgroup
    (output of :func:`_easy_part`), where inverse = conjugate."""
    fx = _exp_by_u(f)
    fx2 = _exp_by_u(fx)
    fx3 = _exp_by_u(fx2)
    fp = fq12_frobenius(f)
    fp2 = fq12_frobenius(fp)
    fp3 = fq12_frobenius(fp2)
    fxp = fq12_frobenius(fx)
    fx2p = fq12_frobenius(fx2)
    fx3p = fq12_frobenius(fx3)
    fx2p2 = fq12_frobenius(fq12_frobenius(fx2))
    y0 = fq12_mul(fq12_mul(fp, fp2), fp3)
    y1 = fq12_conj(f)
    y2 = fx2p2
    y3 = fq12_conj(fxp)
    y4 = fq12_conj(fq12_mul(fx, fx2p))
    y5 = fq12_conj(fx2)
    y6 = fq12_conj(fq12_mul(fx3, fx3p))
    t0 = fq12_mul(fq12_mul(fq12_sqr(y6), y4), y5)
    t1 = fq12_mul(fq12_mul(y3, y5), t0)
    t0 = fq12_mul(t0, y2)
    t1 = fq12_sqr(fq12_mul(fq12_sqr(t1), t0))
    t0 = fq12_mul(t1, y1)
    t1 = fq12_mul(t1, y0)
    return fq12_mul(fq12_sqr(t0), t1)


def final_exponentiation(f):
    """f^((q^12 - 1) / r): easy part + the Scott et al. 2009 exact
    hard-part addition chain (see :func:`_hard_part`)."""
    return _hard_part(_easy_part(f))


# ---------------------------------------------------------------------------
# Precomputed-line Miller loop (fixed G2 arguments: the SRS [tau]_2 / [1]_2)
# ---------------------------------------------------------------------------


def precompute_g2_lines(Q_):
    """All Miller-loop line slopes/anchors for a fixed G2 point.

    Each entry is (lam, x_t, y_t): the (tangent or chord) slope and the
    anchor point, from which the sparse Fq12 line at any G1 point follows
    with 2 Fq2 scalings (see :func:`_line_sparse`). Verification pairs every
    proof against the same two SRS G2 points, so these are computed once per
    verifying key (halo2's analog: the G2 prep baked into ParamsVerifierKZG).

    Precondition: ``Q_`` must be a non-identity point of the r-order G2
    subgroup (true for any honest SRS point). Enforced here because the
    doubling/chord slopes below divide by 2*y_T and x_Q - x_T, which only a
    small-order or identity point can drive to zero."""
    assert Q_ is not None and g2_mul(Q_, R) is None, (
        "precompute_g2_lines requires a non-identity r-order G2 point"
    )
    lines = []
    T = Q_
    for bit in _ATE_BITS:
        lam = fq2_mul(fq2_scalar(fq2_sqr(T[0]), 3), fq2_inv(fq2_scalar(T[1], 2)))
        lines.append((lam, T[0], T[1]))
        T = g2_add(T, T)
        if bit == "1":
            lam = fq2_mul(fq2_sub(Q_[1], T[1]), fq2_inv(fq2_sub(Q_[0], T[0])))
            lines.append((lam, T[0], T[1]))
            T = g2_add(T, Q_)
    q1 = _g2_frobenius(Q_)
    lam = fq2_mul(fq2_sub(q1[1], T[1]), fq2_inv(fq2_sub(q1[0], T[0])))
    lines.append((lam, T[0], T[1]))
    T = g2_add(T, q1)
    q2 = g2_neg(_g2_frobenius(q1))
    lam = fq2_mul(fq2_sub(q2[1], T[1]), fq2_inv(fq2_sub(q2[0], T[0])))
    lines.append((lam, T[0], T[1]))
    return lines


_G2_LINE_CACHE: dict = {}
_G2_LINE_CACHE_MAX = 16  # a vk pairs against 2 fixed SRS points; 16 covers
# every vk a process realistically holds while bounding memory (each entry
# is a ~130-line list).


def _g2_lines(Q_):
    hit = _G2_LINE_CACHE.get(Q_)
    if hit is None:
        if len(_G2_LINE_CACHE) >= _G2_LINE_CACHE_MAX:
            _G2_LINE_CACHE.pop(next(iter(_G2_LINE_CACHE)))
        hit = _G2_LINE_CACHE[Q_] = precompute_g2_lines(Q_)
    return hit


def _fq6_mul_01(a, b0, b1):
    """a * (b0, b1, 0) in Fq6 — 5 Fq2 muls instead of 6."""
    a0, a1, a2 = a
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_mul(a2, b1)))
    c1 = fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1))
    c2 = fq2_add(fq2_mul(a2, b0), t1)
    return (c0, c1, c2)


def _fq6_scalar_fq(a, k):
    return tuple(fq2_scalar(x, k) for x in a)


def _mul_by_line(f, y_p, w1, w3):
    """f * l where l = ((y_p, 0, 0), (w1, w3, 0)) in Fq12 — the sparse line
    shape of :func:`_line_eval`; ~10 Fq2 muls vs 18 for a generic fq12_mul."""
    a0, a1 = f
    c0 = fq6_add(_fq6_scalar_fq(a0, y_p), fq6_mul_by_v(_fq6_mul_01(a1, w1, w3)))
    c1 = fq6_add(_fq6_mul_01(a0, w1, w3), _fq6_scalar_fq(a1, y_p))
    return (c0, c1)


_ATE_BITS = bin(ATE_LOOP_COUNT)[3:]


def miller_loop_lines(P, lines):
    """Miller loop against precomputed lines (see precompute_g2_lines)."""
    x_p, y_p = P
    x_p = x_p % Q
    y_p = y_p % Q
    f = FQ12_ONE
    i = 0

    def absorb(f, i):
        lam, x_t, y_t = lines[i]
        w1 = fq2_scalar(lam, (-x_p) % Q)
        w3 = fq2_sub(fq2_mul(lam, x_t), y_t)
        return _mul_by_line(f, y_p, w1, w3), i + 1

    for bit in _ATE_BITS:
        f, i = absorb(fq12_sqr(f), i)
        if bit == "1":
            f, i = absorb(f, i)
    f, i = absorb(f, i)
    f, i = absorb(f, i)
    assert i == len(lines)
    return f


def pairing(P, Q_):
    """e: G1 x G2 -> Fq12. P in G1 (affine int pair), Q_ in G2."""
    return final_exponentiation(miller_loop(P, Q_))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1: precomputed-line Miller loops (the G2 side is
    the fixed SRS pair), one batched fast final exponentiation."""
    f = FQ12_ONE
    for P, Q_ in pairs:
        if P is None or Q_ is None:
            continue
        f = fq12_mul(f, miller_loop_lines(P, _g2_lines(Q_)))
    return final_exponentiation(f) == FQ12_ONE

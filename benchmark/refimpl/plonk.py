"""The reference verifier of a proof: the verifying key worked out again from
the circuit and tau, and the proof checked against one request's public
inputs.

The protocol is the port's (``prover/plonk.py``: 5 advice wires, 8 fixed
columns, a chunked permutation product, LogUp range lookups, a quotient in
pieces of n, GWC openings at x and omega*x, a Blake2b transcript). Nothing
here reads what the program made: the fixed, permutation and table columns
come from the frozen synthesis, and each commitment is [f(tau)]G1 for the
column's polynomial f, evaluated from its values on the domain through the
Lagrange basis at tau.

The final KZG check e(W, [tau]G2) = e(F, G2) holds exactly when
tau*W = F in G1, since the pairing is non-degenerate and G1 has prime order.
The benchmark knows tau (its SRS is made from tau = 777), so it checks that
equation in G1 and needs no pairing.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import g1

R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
TWO_ADICITY = 28
COSET_GEN = 7
BLIND = 4
PERM_CHUNK = 6
PERSONAL = b"halo2rsa-tpu-fs1"


# --- domain ----------------------------------------------------------------


def _max_root() -> int:
    odd = (R - 1) >> TWO_ADICITY
    g = 2
    while True:
        c = pow(g, odd, R)
        if pow(c, 1 << (TWO_ADICITY - 1), R) != 1:
            return c
        g += 1


def omega(k: int) -> int:
    """The primitive 2^k-th root of unity the domain uses."""
    return pow(_max_root(), 1 << (TWO_ADICITY - k), R)


def perm_chunks(num_wires: int) -> list:
    if num_wires <= PERM_CHUNK:
        return [num_wires]
    chunks, rem = [], num_wires
    while rem > PERM_CHUNK - 1:
        c = min(PERM_CHUNK, rem)
        if rem - c == 0:
            c = PERM_CHUNK - 1
        chunks.append(c)
        rem -= c
    chunks.append(rem)
    return chunks


def num_pieces(num_wires: int) -> int:
    chunks = perm_chunks(num_wires)
    deg = chunks[0] + 1 if len(chunks) == 1 else max(
        max(c + 1 for c in chunks[:-1]), chunks[-1] + 2, 4)
    return max(deg, 4)


def coset_ids(num_wires: int) -> list:
    return [pow(COSET_GEN, w, R) for w in range(num_wires)]


# --- the circuit's structure -------------------------------------------------


class Structure:
    """What the verifying key depends on, from a synthesised builder: each
    gate row's 5 cells and 8 coefficients, the lookups grouped by width, the
    public cells."""

    def __init__(self, builder):
        self.num_cells = len(builder.values)
        self.gate_idx = np.asarray(builder.gate_idx, dtype=np.int64).reshape(-1, 5)
        self.gate_coef = [tuple(c % R for c in row) for row in builder.gate_coef]
        groups: dict = {}
        for idx, bits in builder.lookups:
            groups.setdefault(bits, []).append(idx)
        self.lookup_groups = [(bits, np.asarray(groups[bits], np.int64)) for bits in sorted(groups)]
        self.instance = list(builder.instance)

    @property
    def num_gates(self) -> int:
        return self.gate_idx.shape[0]

    def same_as(self, other: "Structure") -> bool:
        return (np.array_equal(self.gate_idx, other.gate_idx) and self.gate_coef == other.gate_coef
                and self.instance == other.instance
                and [b for b, _ in self.lookup_groups] == [b for b, _ in other.lookup_groups]
                and all(np.array_equal(a, b) for (_, a), (_, b) in
                        zip(self.lookup_groups, other.lookup_groups)))


def sigma_cells(wire_source: np.ndarray) -> np.ndarray:
    """The permutation over (wire, row) cells: the cells that hold one witness
    index form a cycle in the order of their flat index, each pointing to the
    next and the last to the first; a free cell (-1) points to itself."""
    key = wire_source.reshape(-1)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    first = np.ones(len(sk), dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    starts = np.nonzero(first)[0]
    ends = np.concatenate([starts[1:] - 1, [len(sk) - 1]])
    nxt = np.empty_like(order)
    nxt[:-1] = order[1:]
    nxt[ends] = order[starts]
    sigma = np.empty_like(order)
    sigma[order] = nxt
    free = key < 0
    sigma[free] = np.arange(len(key))[free]
    return sigma.reshape(wire_source.shape)


# --- the verifying key ---------------------------------------------------------


class VerifyingKey:
    def __init__(self, k, num_wires, lookup_bits, fixed, sigma, tables, pub_rows):
        self.k, self.n = k, 1 << k
        self.num_wires = num_wires
        self.lookup_bits = lookup_bits
        self.fixed_commitments = fixed
        self.sigma_commitments = sigma
        self.table_commitments = tables
        self.pub_rows = pub_rows


def lagrange_at(k: int, tau: int) -> list:
    """L_i(tau) for i < n: omega^i (tau^n - 1) / (n (tau - omega^i))."""
    n = 1 << k
    w = omega(k)
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * w % R
    diffs = [(tau - p) % R for p in pows]
    assert all(diffs), "tau lies on the domain"
    # batch inversion
    pre = [1] * (n + 1)
    for i, d in enumerate(diffs):
        pre[i + 1] = pre[i] * d % R
    inv = pow(pre[n], -1, R)
    invs = [0] * n
    for i in range(n - 1, -1, -1):
        invs[i] = inv * pre[i] % R
        inv = inv * diffs[i] % R
    c = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
    return [p * q % R * c % R for p, q in zip(pows, invs)], pows


def verifying_key(st: Structure, k: int, tau: int) -> VerifyingKey:
    """The key that a proof of this circuit on the domain 2^k, under the SRS
    of ``tau``, is checked against."""
    n = 1 << k
    rows = st.num_gates
    tables = st.lookup_groups
    num_wires = 5 + len(tables)
    need = max([rows + len(st.instance)] + [1 << b for b, _ in tables]
               + [len(i) for _, i in tables])
    assert need <= n, f"the circuit needs {need} rows > 2^{k}"
    lag, pows = lagrange_at(k, tau)

    wire_source = np.full((num_wires, n), -1, np.int64)
    wire_source[:5, :rows] = st.gate_idx.T
    pub_rows = [rows + j for j in range(len(st.instance))]
    wire_source[0, rows:rows + len(st.instance)] = st.instance
    for t, (_, idx) in enumerate(tables):
        wire_source[5 + t, :len(idx)] = idx

    fixed = []
    for c in range(8):
        s = sum(coef[c] * lag[i] for i, coef in enumerate(st.gate_coef) if coef[c])
        if c == 0:
            s += sum(lag[r] for r in pub_rows)
        fixed.append(s % R)

    # sigma_w(tau) = sum_i L_i(tau) k_{w'} omega^{i'} over the permuted cells;
    # a cell that maps to itself adds L_i(tau) k_w omega^i, and those sum to
    # k_w tau over a whole column, so only moved cells are visited.
    ks = coset_ids(num_wires)
    sig = sigma_cells(wire_source)
    flat = np.arange(num_wires * n).reshape(num_wires, n)
    sigma = []
    for w in range(num_wires):
        s = ks[w] * tau
        moved = np.nonzero(sig[w] != flat[w])[0]
        for i, dst in zip(moved.tolist(), sig[w][moved].tolist()):
            w2, i2 = divmod(dst, n)
            s += lag[i] * (ks[w2] * pows[i2] - ks[w] * pows[i])
        sigma.append(s % R)

    table = [sum(j * lag[j] for j in range(1, 1 << bits)) % R for bits, _ in tables]
    return VerifyingKey(k, num_wires, tuple(b for b, _ in tables),
                        [g1.mul_gen(s) for s in fixed], [g1.mul_gen(s) for s in sigma],
                        [g1.mul_gen(s) for s in table], pub_rows)


# --- transcript ------------------------------------------------------------------


class Transcript:
    """Blake2b-512 with the program's absorb and squeeze convention: a scalar
    is 0x01 and 32 bytes little-endian, a point 0x02 and x, y (64 zero bytes
    for the identity), a challenge the digest of the state and b"\\x03challenge"
    mod r, absorbed back as 0x04 and its 32 bytes."""

    def __init__(self, proof: bytes):
        self.h = hashlib.blake2b(person=PERSONAL, digest_size=64)
        self.buf, self.pos = proof, 0

    def scalar(self, s: int) -> None:
        self.h.update(b"\x01" + (s % R).to_bytes(32, "little"))

    def point(self, p) -> None:
        b = bytes(64) if p is None else p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")
        self.h.update(b"\x02" + b)

    def challenge(self) -> int:
        st = self.h.copy()
        st.update(b"\x03challenge")
        out = int.from_bytes(st.digest(), "little") % R
        self.h.update(b"\x04" + out.to_bytes(32, "little"))
        return out

    def _take(self) -> bytes:
        b = self.buf[self.pos:self.pos + 32]
        self.pos += 32
        if len(b) != 32:
            raise ValueError("proof truncated")
        return b

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(), "little")
        if s >= R:
            raise ValueError("scalar out of range")
        self.scalar(s)
        return s

    def read_point(self):
        p = g1.decompress(self._take())
        self.point(p)
        return p


# --- verification ------------------------------------------------------------------


def verify(vk: VerifyingKey, proof: bytes, public_inputs: list, tau: int) -> bool:
    """Whether ``proof`` shows the circuit satisfied with these public inputs."""
    try:
        return _verify(vk, proof, public_inputs, tau)
    except ValueError:
        return False


def _verify(vk: VerifyingKey, proof: bytes, public_inputs: list, tau: int) -> bool:
    n, k = vk.n, vk.k
    nw = vk.num_wires
    nt = len(vk.lookup_bits)
    om = omega(k)
    pubs = [p % R for p in public_inputs]
    if len(pubs) != len(vk.pub_rows):
        return False

    t = Transcript(proof)
    for c in vk.fixed_commitments + vk.sigma_commitments + vk.table_commitments:
        t.point(c)
    t.scalar(n)
    for p in pubs:
        t.scalar(p)

    chunks = perm_chunks(nw)
    nc = len(chunks)
    npc = num_pieces(nw)
    wire_c = [t.read_point() for _ in range(nw)]
    m_c = [t.read_point() for _ in range(nt)]
    beta, gamma, beta_lk = t.challenge(), t.challenge(), t.challenge()
    a_c = [t.read_point() for _ in range(nc - 1)]
    z_c = t.read_point()
    h_c = [t.read_point() for _ in range(nt)]
    alpha = t.challenge()
    piece_c = [t.read_point() for _ in range(npc)]
    x = t.challenge()
    count_x = nw + 8 + nw + nt + nt + (nc - 1) + 1 + nt + npc
    ev_x = [t.read_scalar() for _ in range(count_x)]
    ev_w = [t.read_scalar() for _ in range(1 + nt)]
    v = t.challenge()
    u = t.challenge()
    pi_x = t.read_point()
    pi_w = t.read_point()
    if t.pos != len(proof):
        return False

    pos = 0

    def take(m):
        nonlocal pos
        pos += m
        return ev_x[pos - m:pos]

    wire_e, fixed_e, sigma_e = take(nw), take(8), take(nw)
    table_e, m_e, a_e = take(nt), take(nt), take(nc - 1)
    (z_e,) = take(1)
    h_e, piece_e = take(nt), take(npc)
    zw_e, hw_e = ev_w[0], ev_w[1:]

    # the quotient identity at x
    xn = pow(x, n, R)
    van = (xn - 1) % R
    if van == 0:
        return False
    n_inv = pow(n, -1, R)

    def lag(i):
        wi = pow(om, i, R)
        return wi * van % R * pow((x - wi) % R, -1, R) % R * n_inv % R

    l0 = lag(0)
    pi_val = sum(-p * lag(row) for row, p in zip(vk.pub_rows, pubs)) % R
    gate = fixed_e[7] + sum(fixed_e[c] * wire_e[c] for c in range(5))
    gate += fixed_e[5] * wire_e[0] * wire_e[1] + fixed_e[6] * wire_e[2] * wire_e[3] + pi_val
    ks = coset_ids(nw)
    ap = alpha
    acc = gate + ap * l0 * (z_e - 1)
    w = 0
    prev_a = None
    for j, cs in enumerate(chunks):
        num = den = 1
        for _ in range(cs):
            num = num * (wire_e[w] + beta * ks[w] * x + gamma) % R
            den = den * (wire_e[w] + beta * sigma_e[w] + gamma) % R
            w += 1
        ap = ap * alpha % R
        if j < nc - 1:
            rhs = num if prev_a is None else prev_a * num
            acc += ap * (a_e[j] * den - rhs)
            prev_a = a_e[j]
        else:
            zn = z_e * num * (1 if prev_a is None else prev_a)
            acc += ap * (zn - zw_e * den)
    for tt in range(nt):
        a_b = wire_e[5 + tt] + beta_lk
        t_b = table_e[tt] + beta_lk
        ap = ap * alpha % R
        acc += ap * ((hw_e[tt] - h_e[tt]) * a_b * t_b - (t_b - m_e[tt] * a_b))
        ap = ap * alpha % R
        acc += ap * l0 * h_e[tt]
    t_x = sum(e * pow(xn, i, R) for i, e in enumerate(piece_e))
    if acc % R != van * t_x % R:
        return False

    # the batched opening: tau (W_x + u W_w) = F, F the fold of the
    # commitments less the evaluations, plus x W_x + u omega x W_w
    comms_x = (wire_c + vk.fixed_commitments + vk.sigma_commitments + vk.table_commitments
               + m_c + a_c + [z_c] + h_c + piece_c)
    comms_w = [z_c] + h_c
    pts, scs = [], []
    vp, v1 = 1, 0
    for c, e in zip(comms_x, ev_x):
        pts.append(c)
        scs.append(vp)
        v1 += vp * e
        vp = vp * v % R
    vp, v2 = 1, 0
    for c, e in zip(comms_w, ev_w):
        pts.append(c)
        scs.append(u * vp % R)
        v2 += vp * e
        vp = vp * v % R
    xw = x * om % R
    pts += [g1.GEN, pi_x, pi_w]
    scs += [(-(v1 + u * v2)) % R, (x - tau) % R, u * (xw - tau) % R]
    return g1.msm(scs, pts) is None

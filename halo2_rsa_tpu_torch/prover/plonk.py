"""PLONK-style zk-SNARK prover/verifier over the trace constraint system.

Counterpart of ``halo2_rsa_tpu/prover/plonk.py``, round for round: 5 advice
wires + 8 fixed columns, a chunked permutation grand product, LogUp range
lookups, ZK blinding b(X)·(X^n − 1) per committed polynomial, a quotient on
the 8n extended coset, and GWC openings at x and ωx. With the same
``rng`` the proof bytes equal the JAX package's: the blinding draws, the
polynomial order and the transcript absorbs are the reference's.

Device work runs where the proving key's tensors live: NTTs, MSMs and the
round-2/round-3 algebra are torch ops over K1–K4. The verifier is host
Python apart from its fold MSM, which runs on ``verify``'s ``device``.
"""

from __future__ import annotations

import dataclasses
import secrets

import numpy as np
import torch

from ..circuit.checker import CompiledCircuit, witness_limbs
from ..fields import vecfield
from ..fields.cuda_mont import LIMBS, u64
from ..fields.field import BN254_FR
from ..fields.vecfield import add as _vadd, mont_mul as _vmul, sub as _vsub
from . import curve, g1_vec, kzg, msm, ntt
from .transcript import Transcript, TranscriptReader

FR = vecfield.consts(BN254_FR)
R = BN254_FR.p

COSET_GEN = 7  # extended-domain coset representative; also the base for k_w

# Extra coefficient slots per committed polynomial for the ZK blinding
# b(X)·(X^n − 1), deg b < BLIND.
BLIND = 4


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VerifyingKey:
    k: int
    n: int
    num_wires: int  # 5 + num lookup tables
    lookup_bits: tuple  # per-table bit widths
    fixed_commitments: list  # [Q_c] (8)
    sigma_commitments: list  # per wire column
    table_commitments: list  # per lookup table
    pub_rows: list  # row index per public input
    srs_g2_gen: tuple
    srs_g2_tau: tuple
    g1_gen: tuple = curve.G1_GEN


@dataclasses.dataclass
class ProvingKey:
    """Prover precomputation: Montgomery-limb (…, 8) int32 tensors on the
    proving device (evaluation form, coefficient form, extended coset)."""

    vk: VerifyingKey
    srs: kzg.SRS
    wire_source: np.ndarray  # (num_wires, n) int32; -1 = free (value 0) cell
    k_cosets: list  # k_w coset ids (host ints)
    log_ext: int
    # evaluation form (…, n, 8)
    id_vals: torch.Tensor  # (num_wires, n, 8): k_w · ω^i
    sigma_vals: torch.Tensor  # (num_wires, n, 8)
    table_vals: torch.Tensor | None  # (num_tables, n, 8)
    # coefficient form (…, n, 8)
    fixed_polys: torch.Tensor  # (8, n, 8)
    sigma_polys: torch.Tensor  # (num_wires, n, 8)
    table_polys: torch.Tensor | None  # (num_tables, n, 8)
    # extended-coset evaluation form (…, n_ext, 8)
    fixed_ext: torch.Tensor
    sigma_ext: torch.Tensor
    table_ext: torch.Tensor | None
    l0_ext: torch.Tensor  # (n_ext, 8)
    x_ext: torch.Tensor  # (n_ext, 8): coset · ω_ext^j
    van_inv: torch.Tensor  # (n_ext, 8): 1 / (X^n − 1) on the coset
    g1_tail: list  # host affine [τ^{n+j}]G1, j < BLIND

    @property
    def device(self) -> torch.device:
        return self.fixed_polys.device


def _omega(k: int) -> int:
    return ntt.root_of_unity(k)


# Permutation-argument chunking: the per-row ratio splits into chunks of
# <= _PERM_CHUNK wires with committed partial-product columns A_j, capping
# the identity degree at _PERM_CHUNK + 1 (log_ext = k + 3 for every circuit).
_PERM_CHUNK = 6


def _perm_chunks(num_wires: int) -> list:
    """Chunk sizes; A columns exist for chunks[:-1], the last chunk folds
    into the Z recurrence (so it must leave room for Z·A_{m-2}: <= 5 when
    chunked)."""
    if num_wires <= _PERM_CHUNK:
        return [num_wires]
    chunks = []
    rem = num_wires
    while rem > _PERM_CHUNK - 1:
        c = min(_PERM_CHUNK, rem)
        if rem - c == 0:  # last chunk would be empty but c too big to fold
            c = _PERM_CHUNK - 1
        chunks.append(c)
        rem -= c
    chunks.append(rem)
    return chunks


def _perm_ident_degree(num_wires: int) -> int:
    chunks = _perm_chunks(num_wires)
    if len(chunks) == 1:
        return chunks[0] + 1
    return max(max(c + 1 for c in chunks[:-1]), chunks[-1] + 2, 4)


def _coset_ids(num_wires: int, k: int) -> list:
    """Distinct coset representatives k_w = COSET_GEN^w, verified disjoint."""
    ids = [1]
    g = COSET_GEN
    cur = 1
    for _ in range(num_wires - 1):
        cur = cur * g % R
        ids.append(cur)
    n = 1 << k
    for d in range(1, num_wires):
        assert pow(pow(g, d, R), n, R) != 1, "coset collision"
    return ids


def _sigma_cells(wire_source: np.ndarray) -> np.ndarray:
    """Permutation sigma over (wire, row) cells as flat cell indices.

    Cells sharing a witness index form a cycle (each maps to the next);
    free cells (source −1) are identity. Pure vectorized numpy — the
    device-friendly replacement for the reference stack's per-cell
    permutation bookkeeping (halo2 ``permutation::keygen``)."""
    num_wires, n = wire_source.shape
    key = wire_source.reshape(-1)
    total = key.shape[0]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    boundary = np.empty(total, dtype=bool)
    boundary[0] = True
    boundary[1:] = sk[1:] != sk[:-1]
    starts_idx = np.nonzero(boundary)[0]
    # next element within each group, cyclic
    nxt = np.empty_like(order)
    nxt[:-1] = order[1:]
    nxt[-1] = order[0]
    ends_idx = np.concatenate([starts_idx[1:] - 1, [total - 1]])
    nxt[ends_idx] = order[starts_idx]
    sigma = np.empty_like(order)
    sigma[order] = nxt
    free = key < 0
    sigma[free] = np.arange(total)[free]
    return sigma.reshape(num_wires, n)


def _keygen_vals_graph(k_mont, omega_pows, sigma_cells, n):
    """id[w, i] = k_w · ω^i ; sigma[w, i] = k_{w2} · ω^{i2} for the
    permuted cell (w2, i2)."""
    id_vals = _vmul(FR, k_mont[:, None, :], omega_pows[None, :, :])
    sigma_vals = _vmul(FR, k_mont[sigma_cells // n], omega_pows[sigma_cells % n])
    return id_vals, sigma_vals


def rows_needed(compiled: CompiledCircuit) -> int:
    """Rows the circuit occupies: gates + public-input rows, the largest
    lookup table (2^bits rows), and the longest lookup input column."""
    table_sizes = [1 << bits for bits, _ in compiled.lookup_groups]
    lookup_counts = [idx.shape[0] for _, idx in compiled.lookup_groups]
    return max(
        compiled.num_gates + len(compiled.instance_idx),
        max(table_sizes, default=1),
        max(lookup_counts, default=1),
    )


def min_k(compiled: CompiledCircuit) -> int:
    """Smallest k with 2^k >= rows_needed (what keygen picks for k=None)."""
    return max(2, (rows_needed(compiled) - 1).bit_length())


def keygen(compiled: CompiledCircuit, srs: kzg.SRS, k: int | None = None):
    """Proving/verifying keys from a compiled trace, on the SRS's device.
    Witness-free: only the trace structure is read."""
    dev = srs.g1_powers[0].device
    R_rows = compiled.num_gates
    lookup_groups = compiled.lookup_groups
    num_tables = len(lookup_groups)

    rows_need = rows_needed(compiled)
    if k is None:
        k = min_k(compiled)
    n = 1 << k
    assert n >= rows_need, f"circuit needs {rows_need} rows > 2^{k}"

    num_wires = 5 + num_tables
    md = max(_perm_ident_degree(num_wires), 4)
    log_blow = max(1, (md - 1).bit_length())
    while (md * (n + BLIND - 1) + 2) >= (n << log_blow):
        log_blow += 1
    log_ext = k + log_blow
    assert log_ext <= ntt.TWO_ADICITY, f"2^{log_ext} exceeds Fr two-adicity"
    assert srs.n >= n + BLIND, f"SRS has {srs.n} powers; need {n + BLIND}"
    omega = _omega(k)

    # --- wire sources: which witness index feeds each (wire, row) cell ---
    wire_source = np.full((num_wires, n), -1, np.int32)  # -1 = free cell
    wire_source[:5, :R_rows] = compiled.gate_idx.T
    pub_rows = []
    for j, widx in enumerate(compiled.instance_idx):
        row = R_rows + j
        wire_source[0, row] = widx
        pub_rows.append(row)
    for t, (bits, idx) in enumerate(lookup_groups):
        wire_source[5 + t, : idx.shape[0]] = idx

    # --- fixed coefficient columns (Montgomery eval form) ----------------
    assert compiled.field is BN254_FR, "SNARK proving requires BN254 Fr circuits"
    coef_table = torch.from_numpy(compiled.coef_table).to(dev)
    coef_rows = coef_table[torch.from_numpy(compiled.gate_coef_id.astype(np.int64)).to(dev)]
    fixed_vals = torch.zeros((8, n, LIMBS), dtype=torch.int32, device=dev)
    fixed_vals[:, :R_rows] = coef_rows.permute(1, 0, 2)
    if pub_rows:
        fixed_vals[0, torch.tensor(pub_rows, device=dev)] = FR.tensor("r_limbs", dev)

    # --- permutation id/sigma columns --------------------------------------
    k_cosets = _coset_ids(num_wires, k)
    k_mont = vecfield.from_ints(FR, k_cosets, device=dev)
    omega_pows = vecfield.pow_series(FR, omega, n, dev)
    sigma_cells = torch.from_numpy(_sigma_cells(wire_source).astype(np.int64)).to(dev)
    id_vals, sigma_vals = _keygen_vals_graph(k_mont, omega_pows, sigma_cells, n)

    # --- lookup tables: t_j = j for j < 2^bits else 0 ---------------------
    if num_tables:
        tv = np.zeros((num_tables, n, LIMBS), np.int32)
        for t, (bits, _) in enumerate(lookup_groups):
            vals = np.arange(n, dtype=np.int32)
            vals[1 << bits :] = 0
            tv[t, :, 0] = vals
        table_vals = vecfield.to_mont(FR, torch.from_numpy(tv).to(dev))
    else:
        table_vals = None

    # --- coefficient polys (batched iNTT) --------------------------------
    stack = [fixed_vals, sigma_vals] + ([table_vals] if num_tables else [])
    all_polys = ntt.intt_batch(torch.cat(stack, dim=0), k)
    fixed_polys = all_polys[:8]
    sigma_polys = all_polys[8 : 8 + num_wires]
    table_polys = all_polys[8 + num_wires :] if num_tables else None
    del stack, fixed_vals, coef_rows

    # --- verifying-key commitments (one batched MSM over all columns) ----
    comms = _commit_batch(srs, all_polys)
    fixed_commitments = comms[:8]
    sigma_commitments = comms[8 : 8 + num_wires]
    table_commitments = comms[8 + num_wires :]
    del all_polys

    fixed_ext, sigma_ext, table_ext, l0_ext, x_ext, van_inv = build_ext_arrays(
        fixed_polys, sigma_polys, table_polys, k, log_ext
    )
    g1_tail = g1_vec.points_from_device(tuple(c[n : n + BLIND] for c in srs.g1_powers))

    vk = VerifyingKey(
        k=k,
        n=n,
        num_wires=num_wires,
        lookup_bits=tuple(bits for bits, _ in lookup_groups),
        fixed_commitments=fixed_commitments,
        sigma_commitments=sigma_commitments,
        table_commitments=table_commitments,
        pub_rows=pub_rows,
        srs_g2_gen=srs.g2_gen,
        srs_g2_tau=srs.g2_tau,
    )
    pk = ProvingKey(
        vk=vk,
        srs=srs,
        wire_source=wire_source,
        k_cosets=k_cosets,
        log_ext=log_ext,
        id_vals=id_vals,
        sigma_vals=sigma_vals,
        table_vals=table_vals,
        fixed_polys=fixed_polys,
        sigma_polys=sigma_polys,
        table_polys=table_polys,
        fixed_ext=fixed_ext,
        sigma_ext=sigma_ext,
        table_ext=table_ext,
        l0_ext=l0_ext,
        x_ext=x_ext,
        van_inv=van_inv,
        g1_tail=g1_tail,
    )
    return pk, vk


def build_ext_arrays(fixed_polys, sigma_polys, table_polys, k: int, log_ext: int):
    """The proving key's extended-coset precomputation, one family at a
    time."""
    dev = fixed_polys.device
    n = 1 << k
    scale = vecfield.pow_series(FR, COSET_GEN, n, dev)
    fixed_ext = _coset_eval_batch(fixed_polys, log_ext, scale)
    sigma_ext = _coset_eval_batch(sigma_polys, log_ext, scale)
    table_ext = (
        _coset_eval_batch(table_polys, log_ext, scale)
        if table_polys is not None and table_polys.shape[0]
        else None
    )

    # L0 / X / 1/(X^n − 1) on the extended coset
    n_ext = 1 << log_ext
    l0_vals = torch.zeros((1, n, LIMBS), dtype=torch.int32, device=dev)
    l0_vals[0, 0] = FR.tensor("r_limbs", dev)
    l0_ext = _coset_eval_batch(ntt.intt_batch(l0_vals, k), log_ext, scale)[0]
    w_ext_root = ntt.root_of_unity(log_ext)
    x_ext = _vmul(
        FR,
        vecfield.pow_series(FR, w_ext_root, n_ext, dev),
        vecfield.from_ints(FR, [COSET_GEN], device=dev)[0],
    )
    period = n_ext // n
    cn = pow(COSET_GEN, n, R)
    wn = pow(w_ext_root, n, R)
    van_inv_period = []
    cur = cn
    for _ in range(period):
        van_inv_period.append(pow((cur - 1) % R, -1, R))
        cur = cur * wn % R
    van_inv = vecfield.from_ints(FR, van_inv_period, device=dev).repeat(n_ext // period, 1)
    return fixed_ext, sigma_ext, table_ext, l0_ext, x_ext, van_inv


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


# Poly-axis chunk for big extended-domain NTT batches.
_COSET_CHUNK = 4


def _coset_eval_graph(polys, log_ext: int, scale, tw_fwd):
    """(P, L, 8) Montgomery coefficients -> evals on coset·H_ext (P, E, 8).
    ``scale``: (L, 8) powers of the coset representative."""
    p, l, _ = polys.shape
    n_ext = 1 << log_ext
    scaled = _vmul(FR, polys, scale[None])

    def padded(chunk):
        z = torch.zeros((chunk.shape[0], n_ext - l, LIMBS), dtype=torch.int32, device=chunk.device)
        return torch.cat([chunk, z], dim=1)

    if p <= _COSET_CHUNK or (p << log_ext) <= (1 << 22):
        return ntt._ntt_graph(padded(scaled), log_ext, False, tw_fwd)
    out = torch.empty((p, n_ext, LIMBS), dtype=torch.int32, device=polys.device)
    for i in range(0, p, _COSET_CHUNK):
        out[i : i + _COSET_CHUNK] = ntt._ntt_graph(
            padded(scaled[i : i + _COSET_CHUNK]), log_ext, False, tw_fwd
        )
    return out


def _coset_eval_batch(polys, log_ext: int, scale):
    return _coset_eval_graph(polys, log_ext, scale, ntt._twiddles_full(log_ext, False, polys.device))


def _gather_wires(wire_source: torch.Tensor, w_std: torch.Tensor) -> torch.Tensor:
    """(num_wires, n) sources (−1 = zero) × (W, 8) witness limbs
    -> (num_wires, n, 8) standard-form wire columns."""
    vals = w_std[wire_source.clamp(min=0)]
    return torch.where((wire_source >= 0)[..., None], vals, 0)


def _m_counts(wire_std_lk: torch.Tensor, table_sizes: tuple, n: int) -> torch.Tensor:
    """LogUp multiplicities: (num_tables, n, 8) std limbs -> (num_tables, n)
    counts of each table value (out-of-table entries dropped)."""
    outs = []
    for t, size in enumerate(table_sizes):
        limb0 = u64(wire_std_lk[t, :, 0])
        ok = (limb0 < size) & (wire_std_lk[t, :, 1:] == 0).all(dim=-1)
        idx = torch.where(ok, limb0, n)  # n: the dropped slot
        counts = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
        counts.index_add_(0, idx, torch.ones_like(idx))
        outs.append(counts[:n])
    return torch.stack(outs)


def _counts_to_mont(counts: torch.Tensor) -> torch.Tensor:
    """(…,) small ints -> (…, 8) Montgomery limbs."""
    std = torch.zeros(counts.shape + (LIMBS,), dtype=torch.int32, device=counts.device)
    std[..., 0] = counts.to(torch.int32)
    return vecfield.to_mont(FR, std)


def _apply_blind(polys, b_mont):
    """(P, n, 8) coefficient polys += b(X)·(X^n − 1), b per-poly (P, BLIND, 8).
    Returns (P, n+BLIND, 8): coeffs[j] −= b_j, coeffs[n+j] = b_j."""
    head = _vsub(FR, polys[:, :BLIND], b_mont)
    return torch.cat([head, polys[:, BLIND:], b_mont], dim=1)


def _rand_blind(num_polys: int, rng, device) -> torch.Tensor:
    """Secret uniform blinding coefficients, (num_polys, BLIND, 8) Montgomery;
    the rng draws exactly as the reference does."""
    if rng is None:
        vals = [secrets.randbits(253) for _ in range(num_polys * BLIND)]
    else:
        vals = [rng.getrandbits(253) for _ in range(num_polys * BLIND)]
    arr = vecfield.from_ints_np(FR, vals, mont=True)
    return torch.from_numpy(arr.reshape(num_polys, BLIND, LIMBS)).to(device)


class LocalKernels:
    """Single-device kernel provider, the default compute backend of
    :func:`prove` (the interface a multi-device provider would implement)."""

    def intt_batch(self, vals, k: int):
        return ntt.intt_batch(vals, k)

    def msm_many(self, scalars, points, z_one: bool = False):
        return msm.msm_many(scalars, points, z_one)

    def round3_t(self, pk: "ProvingKey", num_tables: int, wire_polys,
                 m_polys, a_polys, z_poly, h_polys, pi_poly, table_ext,
                 coset_scale, omega_scale, cinv_scale, alpha_pows, beta_m,
                 gamma_m, beta_lk_m, kw_beta):
        dev = pk.device
        return _round3_graph(
            pk.log_ext, pk.vk.num_wires, num_tables,
            wire_polys, m_polys, a_polys, z_poly, h_polys, pi_poly,
            pk.fixed_ext, pk.sigma_ext, table_ext,
            pk.l0_ext, pk.x_ext, pk.van_inv,
            coset_scale, omega_scale, cinv_scale,
            alpha_pows, beta_m, gamma_m, beta_lk_m, kw_beta,
            ntt._twiddles_full(pk.log_ext, False, dev),
            ntt._twiddles_full(pk.log_ext, True, dev),
        )


_LOCAL_KERNELS = LocalKernels()


def _commit_batch(srs: kzg.SRS, polys_mont, kern=None) -> list:
    """Commit (P, L, 8) Montgomery coefficient polys: one batched MSM."""
    kern = kern or _LOCAL_KERNELS
    l = polys_mont.shape[1]
    std = vecfield.from_mont(FR, polys_mont)
    pts = tuple(c[:l] for c in srs.g1_powers)
    return g1_vec.points_from_device(kern.msm_many(std, pts, z_one=True))


def _add_tails(heads, tails, g1_tail) -> list:
    """heads[i] + Σ_j tails[i·BLIND + j]·[τ^{n+j}]G1 on the host."""
    out = []
    for i, acc in enumerate(heads):
        for j in range(BLIND):
            bj = tails[i * BLIND + j]
            if bj:
                acc = curve.g1_add(acc, curve.g1_mul(g1_tail[j], bj))
        out.append(acc)
    return out


def _commit_blinded_batch(pk: ProvingKey, polys_pad, kern=None) -> list:
    """Commit (P, n+BLIND, 8) blinded polys: batched n-MSM for the heads +
    host fixed-base adds of the BLIND tail coefficients."""
    kern = kern or _LOCAL_KERNELS
    n = polys_pad.shape[1] - BLIND
    std = vecfield.from_mont(FR, polys_pad[:, :n])
    pts = tuple(c[:n] for c in pk.srs.g1_powers)
    heads = g1_vec.points_from_device(kern.msm_many(std, pts, z_one=True))
    tails = vecfield.to_ints(FR, polys_pad[:, n:], mont=True)
    return _add_tails(heads, tails, pk.g1_tail)


def _batch_eval_graph(polys, xpow):
    """Evaluate (P, L, 8) polys at the point with power series xpow (L, 8)."""
    terms = _vmul(FR, polys, xpow[None])
    return vecfield.reduce_add(FR, terms.transpose(0, 1))


def _batch_eval(polys_pad, x: int) -> list:
    xp = vecfield.pow_series(FR, x, polys_pad.shape[1], polys_pad.device)
    return vecfield.to_ints(FR, _batch_eval_graph(polys_pad, xp), mont=True)


def _fold_graph(polys, weights):
    """GWC fold Σ_p v^p · poly_p: (P, L, 8) × (P, 8) -> (L, 8)."""
    return vecfield.reduce_add(FR, _vmul(FR, polys, weights[:, None]))


def _open_many(pk: ProvingKey, polys_points, kern=None):
    """Batched KZG openings: [(coeffs_pad, z), ...] -> [(value, π), ...];
    every quotient head commits in one batched MSM."""
    kern = kern or _LOCAL_KERNELS
    n = polys_points[0][0].shape[0] - BLIND
    qs, vals = [], []
    for coeffs_pad, z in polys_points:
        q_mont, v = kzg.quotient_poly(coeffs_pad, z)
        qs.append(q_mont)
        vals.append(v)
    q_all = torch.stack(qs)
    heads_std = vecfield.from_mont(FR, q_all[:, :n])
    pts = kern.msm_many(heads_std, tuple(c[:n] for c in pk.srs.g1_powers), z_one=True)
    accs = g1_vec.points_from_device(pts)
    tails = vecfield.to_ints(FR, q_all[:, n:], mont=True)
    return list(zip(vals, _add_tails(accs, tails, pk.g1_tail)))


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------


def _bcast(x_int: int, device) -> torch.Tensor:
    return vecfield.from_ints(FR, [x_int], device=device)[0]


def _round2_graph(wire_mont, id_vals, sigma_vals, num_tables: int, beta_m,
                  gamma_m, beta_lk_m, table_vals, m_mont):
    """Permutation partial products A_j + grand product Z + LogUp running
    sums h (evaluation form). Returns (a_cols (m-1, n, 8), z_col (n, 8),
    h_cols (num_tables, n, 8))."""
    num_wires, n, _ = wire_mont.shape
    dev = wire_mont.device
    chunks = _perm_chunks(num_wires)
    fn = _vadd(FR, wire_mont, _vadd(FR, _vmul(FR, beta_m, id_vals), gamma_m))
    fd = _vadd(FR, wire_mont, _vadd(FR, _vmul(FR, beta_m, sigma_vals), gamma_m))
    num = fn[0]
    den = fd[0]
    num_pref, den_pref = [], []  # chunk-boundary prefixes (first m-1)
    boundary = chunks[0]
    for w in range(1, num_wires):
        if w == boundary:
            num_pref.append(num)
            den_pref.append(den)
            boundary += chunks[len(num_pref)]
        num = _vmul(FR, num, fn[w])
        den = _vmul(FR, den, fd[w])
    # one Montgomery-trick batch inversion for every denominator of the round
    if num_tables:
        a_b = _vadd(FR, wire_mont[5:], beta_lk_m)
        t_b = _vadd(FR, table_vals, beta_lk_m)
        lk_terms = [a_b, t_b]
    else:
        lk_terms = []
    inv_in = torch.cat([torch.stack(den_pref + [den])] + lk_terms, dim=0)
    invs = vecfield.batch_inv_nz(FR, inv_in)
    nm = len(den_pref)
    a_cols = (
        _vmul(FR, torch.stack(num_pref), invs[:nm])
        if num_pref
        else torch.zeros((0, n, LIMBS), dtype=torch.int32, device=dev)
    )
    ratio = _vmul(FR, num, invs[nm])
    zprod = vecfield.prefix_mul(FR, ratio)
    z_col = torch.cat([FR.tensor("r_limbs", dev)[None], zprod[:-1]], dim=0)

    if num_tables == 0:
        return a_cols, z_col, torch.zeros((0, n, LIMBS), dtype=torch.int32, device=dev)
    inv_a = invs[nm + 1 : nm + 1 + num_tables]
    inv_t = invs[nm + 1 + num_tables :]
    term = _vsub(FR, inv_a, _vmul(FR, m_mont, inv_t))
    ps = vecfield.prefix_add(FR, term)
    h_cols = torch.cat(
        [torch.zeros((num_tables, 1, LIMBS), dtype=torch.int32, device=dev), ps[:, :-1]], dim=1
    )
    return a_cols, z_col, h_cols


def _round3_stack(num_tables: int, wire_polys, m_polys, a_polys, z_poly,
                  h_polys, pi_poly, omega_scale):
    """Every polynomial round 3 needs on the extended coset (committed polys
    in padded coefficient form + the ω-shifted Z/h variants)."""
    z_shift = _vmul(FR, z_poly, omega_scale)
    stack = [wire_polys]
    if num_tables:
        stack.append(m_polys)
    stack += [a_polys, z_poly[None], z_shift[None]]
    if num_tables:
        stack += [h_polys, _vmul(FR, h_polys, omega_scale[None])]
    stack.append(pi_poly[None])
    return torch.cat(stack, dim=0)


def _quotient_ident_ext(num_wires: int, num_tables: int, big_ext,
                        fixed_ext, sigma_ext, table_ext, l0_ext, x_ext,
                        van_inv, alpha_pows, beta_m, gamma_m, beta_lk_m,
                        kw_beta):
    """The alpha-folded PLONK identities on the extended coset, divided by
    X^n − 1. ``big_ext``: the :func:`_round3_stack` polys on the coset."""
    n_ext = big_ext.shape[1]
    nt = num_tables
    chunks = _perm_chunks(num_wires)
    m_chunks = len(chunks)
    pos = 0
    wire_ext = big_ext[pos : pos + num_wires]; pos += num_wires
    if nt:
        m_ext = big_ext[pos : pos + nt]; pos += nt
    a_ext = big_ext[pos : pos + m_chunks - 1]; pos += m_chunks - 1
    z_ext = big_ext[pos]; pos += 1
    zw_ext = big_ext[pos]; pos += 1
    if nt:
        h_ext = big_ext[pos : pos + nt]; pos += nt
        hw_ext = big_ext[pos : pos + nt]; pos += nt
    pi_ext = big_ext[pos]

    # gate identity (+ public inputs)
    gate = _vmul(FR, fixed_ext[5], _vmul(FR, wire_ext[0], wire_ext[1]))
    gate = _vadd(FR, gate, _vmul(FR, fixed_ext[6], _vmul(FR, wire_ext[2], wire_ext[3])))
    for c in range(5):
        gate = _vadd(FR, gate, _vmul(FR, fixed_ext[c], wire_ext[c]))
    gate = _vadd(FR, gate, fixed_ext[7])
    gate = _vadd(FR, gate, pi_ext)

    # permutation identities (chunked, per-wire streaming)
    one_ext = FR.tensor("r_limbs", big_ext.device).expand(n_ext, LIMBS)
    i_z1 = _vmul(FR, l0_ext, _vsub(FR, z_ext, one_ext))

    ap = 0
    acc = _vadd(FR, gate, _vmul(FR, alpha_pows[ap][None], i_z1)); ap += 1
    del gate, i_z1

    w = 0
    prev_a = None  # A_{j-1} on the coset (None = 1)
    for j, csize in enumerate(chunks):
        pnum = None
        pden = None
        for _ in range(csize):
            t_n = _vadd(FR, wire_ext[w], _vadd(FR, _vmul(FR, kw_beta[w], x_ext), gamma_m))
            t_d = _vadd(FR, wire_ext[w], _vadd(FR, _vmul(FR, beta_m, sigma_ext[w]), gamma_m))
            pnum = t_n if pnum is None else _vmul(FR, pnum, t_n)
            pden = t_d if pden is None else _vmul(FR, pden, t_d)
            w += 1
        if j < len(chunks) - 1:
            # A_j·Π d − A_{j−1}·Π n == 0
            rhs = pnum if prev_a is None else _vmul(FR, prev_a, pnum)
            i_a = _vsub(FR, _vmul(FR, a_ext[j], pden), rhs)
            acc = _vadd(FR, acc, _vmul(FR, alpha_pows[ap][None], i_a)); ap += 1
            prev_a = a_ext[j]
        else:
            # Z(X)·A_{m−2}·Π n − Z(ωX)·Π d == 0
            zn = _vmul(FR, z_ext, pnum)
            if prev_a is not None:
                zn = _vmul(FR, zn, prev_a)
            i_z2 = _vsub(FR, zn, _vmul(FR, zw_ext, pden))
            acc = _vadd(FR, acc, _vmul(FR, alpha_pows[ap][None], i_z2)); ap += 1

    # LogUp identities
    for t in range(nt):
        a_b = _vadd(FR, wire_ext[5 + t], beta_lk_m)
        t_b = _vadd(FR, table_ext[t], beta_lk_m)
        i_h = _vsub(
            FR,
            _vmul(FR, _vsub(FR, hw_ext[t], h_ext[t]), _vmul(FR, a_b, t_b)),
            _vsub(FR, t_b, _vmul(FR, m_ext[t], a_b)),
        )
        acc = _vadd(FR, acc, _vmul(FR, alpha_pows[ap][None], i_h)); ap += 1
        i_h0 = _vmul(FR, l0_ext, h_ext[t])
        acc = _vadd(FR, acc, _vmul(FR, alpha_pows[ap][None], i_h0)); ap += 1

    return _vmul(FR, acc, van_inv)


def _round3_graph(log_ext: int, num_wires: int, num_tables: int,
                  wire_polys, m_polys, a_polys, z_poly, h_polys, pi_poly,
                  fixed_ext, sigma_ext, table_ext, l0_ext, x_ext, van_inv,
                  coset_scale, omega_scale, cinv_scale,
                  alpha_pows, beta_m, gamma_m, beta_lk_m, kw_beta,
                  tw_fwd, tw_inv):
    """The quotient polynomial t (coefficient form, (n_ext, 8))."""
    big = _round3_stack(num_tables, wire_polys, m_polys, a_polys, z_poly,
                        h_polys, pi_poly, omega_scale)
    big_ext = _coset_eval_graph(big, log_ext, coset_scale, tw_fwd)
    del big
    t_ext = _quotient_ident_ext(
        num_wires, num_tables, big_ext, fixed_ext, sigma_ext, table_ext,
        l0_ext, x_ext, van_inv, alpha_pows, beta_m, gamma_m, beta_lk_m,
        kw_beta,
    )
    del big_ext
    t_coeffs = ntt._ntt_graph(t_ext[None], log_ext, True, tw_inv)[0]
    return _vmul(FR, t_coeffs, cinv_scale)


def prove(pk: ProvingKey, witness, public_inputs: list[int],
          rng=None, phases=None, kern=None) -> bytes:
    """A zero-knowledge proof for the trace with the given witness, computed
    on the proving key's device.

    ``witness``: list of Python ints or a (W, 8) int32 standard-form limb
    array. ``rng``: optional random.Random for reproducible blinding;
    defaults to OS entropy. ``phases``: optional utils.profiling.Phases.
    ``kern``: kernel provider (default :class:`LocalKernels`)."""
    from ..utils.profiling import Phases

    kern = kern or _LOCAL_KERNELS
    ph = phases if phases is not None else Phases()
    dev = pk.device
    vk = pk.vk
    n, k = vk.n, vk.k
    num_wires = vk.num_wires
    num_tables = len(vk.lookup_bits)
    omega = _omega(k)
    log_ext = pk.log_ext
    empty = torch.zeros((0, n, LIMBS), dtype=torch.int32, device=dev)

    pubs = [p % R for p in public_inputs]
    assert len(pubs) == len(vk.pub_rows)

    t = Transcript()
    _absorb_vk(t, vk, pubs)

    # --- round 1: wire columns + lookup multiplicities -------------------
    with ph.phase("witness", cells=len(witness)):
        if isinstance(witness, np.ndarray):
            w_std = witness
        else:
            w_std = witness_limbs(list(witness))
        w_dev = torch.from_numpy(w_std).to(dev)
        wire_source = torch.from_numpy(pk.wire_source.astype(np.int64)).to(dev)
        wire_std = _gather_wires(wire_source, w_dev)
        wire_mont = vecfield.to_mont(FR, wire_std)
        if num_tables:
            table_sizes = tuple(1 << b for b in vk.lookup_bits)
            m_mont = _counts_to_mont(_m_counts(wire_std[5:], table_sizes, n))
        # public-input consistency (host, O(num_pub))
        for row, p in zip(vk.pub_rows, pubs):
            widx = int(pk.wire_source[0, row])
            assert _limbs_to_int(w_std[widx]) == p, "public input mismatch"

    with ph.phase("round1_commit"):
        cols = [wire_mont] + ([m_mont] if num_tables else [])
        polys_r1 = kern.intt_batch(torch.cat(cols, dim=0), k)
        blinds_r1 = _rand_blind(polys_r1.shape[0], rng, dev)
        polys_r1 = _apply_blind(polys_r1, blinds_r1)
        comms_r1 = _commit_blinded_batch(pk, polys_r1, kern)
        wire_polys = polys_r1[:num_wires]
        m_polys = polys_r1[num_wires:]
    for c in comms_r1:
        t.write_point(c)

    beta = t.challenge()
    gamma = t.challenge()
    beta_lk = t.challenge()

    # --- round 2: permutation grand product + LogUp running sums ---------
    with ph.phase("round2_commit"):
        beta_m = _bcast(beta, dev)
        gamma_m = _bcast(gamma, dev)
        beta_lk_m = _bcast(beta_lk, dev)
        a_cols, z_col, h_cols = _round2_graph(
            wire_mont, pk.id_vals, pk.sigma_vals, num_tables,
            beta_m, gamma_m, beta_lk_m,
            pk.table_vals if num_tables else empty,
            m_mont if num_tables else empty,
        )
        num_chunks = len(_perm_chunks(num_wires))
        polys_r2 = kern.intt_batch(torch.cat([a_cols, z_col[None], h_cols], dim=0), k)
        blinds_r2 = _rand_blind(polys_r2.shape[0], rng, dev)
        polys_r2 = _apply_blind(polys_r2, blinds_r2)
        comms_r2 = _commit_blinded_batch(pk, polys_r2, kern)
        a_polys = polys_r2[: num_chunks - 1]
        z_poly = polys_r2[num_chunks - 1]
        h_polys = polys_r2[num_chunks:]
    for c in comms_r2:
        t.write_point(c)

    alpha = t.challenge()

    # --- round 3: quotient -------------------------------------------------
    with ph.phase("round3_quotient"):
        # PI polynomial (unblinded; the verifier recomputes it)
        pi_np = np.zeros((n, LIMBS), np.int32)
        if pubs:
            pi_np[np.asarray(vk.pub_rows)] = vecfield.from_ints_np(
                FR, [(-p) % R for p in pubs], mont=False
            )
        pi_poly = ntt.intt(vecfield.to_mont(FR, torch.from_numpy(pi_np).to(dev)), k)
        pi_poly = torch.cat(
            [pi_poly, torch.zeros((BLIND, LIMBS), dtype=torch.int32, device=dev)], dim=0
        )

        num_idents = 1 + num_chunks + 2 * num_tables
        apows = []
        cur = alpha
        for _ in range(num_idents):
            apows.append(cur)
            cur = cur * alpha % R
        alpha_pows = vecfield.from_ints(FR, apows, device=dev)

        l_pad = n + BLIND
        coset_scale = vecfield.pow_series(FR, COSET_GEN, l_pad, dev)
        omega_scale = vecfield.pow_series(FR, omega, l_pad, dev)
        cinv_scale = vecfield.pow_series(FR, pow(COSET_GEN, -1, R), 1 << log_ext, dev)
        kw_beta = vecfield.from_ints(FR, [beta * kw % R for kw in pk.k_cosets], device=dev)

        t_coeffs = kern.round3_t(
            pk, num_tables,
            wire_polys, m_polys, a_polys, z_poly, h_polys, pi_poly,
            pk.table_ext if num_tables else torch.zeros(
                (0, 1 << log_ext, LIMBS), dtype=torch.int32, device=dev),
            coset_scale, omega_scale, cinv_scale,
            alpha_pows, beta_m, gamma_m, beta_lk_m, kw_beta,
        )
        # split into degree-<n pieces (everything above md·n is zero for an
        # honest witness)
        num_pieces = max(_perm_ident_degree(num_wires), 4)
        pieces = t_coeffs[: num_pieces * n].reshape(num_pieces, n, LIMBS)
        piece_comms = _commit_batch(pk.srs, pieces, kern)
    for c in piece_comms:
        t.write_point(c)

    x = t.challenge()

    # --- round 4: evaluations ----------------------------------------------
    with ph.phase("round4_evals"):
        def pad_to(polys, l):
            z = torch.zeros((polys.shape[0], l - polys.shape[1], LIMBS), dtype=torch.int32, device=dev)
            return torch.cat([polys, z], dim=1)

        stack_x = [wire_polys, pad_to(pk.fixed_polys, l_pad), pad_to(pk.sigma_polys, l_pad)]
        if num_tables:
            stack_x += [pad_to(pk.table_polys, l_pad), m_polys]
        stack_x += [a_polys, z_poly[None]]
        if num_tables:
            stack_x += [h_polys]
        stack_x += [pad_to(pieces, l_pad)]
        polys_x = torch.cat(stack_x, dim=0)
        xw = x * omega % R
        polys_w = torch.cat([z_poly[None]] + ([h_polys] if num_tables else []), dim=0)
        ev_x = _batch_eval_graph(polys_x, vecfield.pow_series(FR, x, polys_x.shape[1], dev))
        ev_w = _batch_eval_graph(polys_w, vecfield.pow_series(FR, xw, polys_w.shape[1], dev))
        evals_x = vecfield.to_ints(FR, ev_x, mont=True)
        evals_w = vecfield.to_ints(FR, ev_w, mont=True)

    for e in evals_x + evals_w:
        t.write_scalar(e)

    v = t.challenge()
    t.challenge()  # u: absorbed by the verifier's fold, unused by the prover

    # --- round 5: GWC openings ----------------------------------------------
    with ph.phase("round5_open"):
        f_x = _fold_graph(polys_x, vecfield.pow_series(FR, v, polys_x.shape[0], dev))
        f_w = _fold_graph(polys_w, vecfield.pow_series(FR, v, polys_w.shape[0], dev))
        (val_x, pi_x), (val_w, pi_w) = _open_many(pk, [(f_x, x), (f_w, xw)], kern)
        for val, evs, tag in ((val_x, evals_x, "x"), (val_w, evals_w, "omega·x")):
            want = 0
            vpow = 1
            for e in evs:
                want = (want + vpow * e) % R
                vpow = vpow * v % R
            assert val == want, f"fold/eval mismatch at {tag}"

    t.write_point(pi_x)
    t.write_point(pi_w)
    return t.proof_bytes()


def _limbs_to_int(row) -> int:
    return int.from_bytes(np.asarray(row, np.int32).view("<u4").tobytes(), "little")


def _absorb_vk(t, vk: VerifyingKey, pubs) -> None:
    for c in vk.fixed_commitments + vk.sigma_commitments + vk.table_commitments:
        t.common_point(c)
    t.common_scalar(vk.n)
    for p in pubs:
        t.common_scalar(p)


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------


def verify(vk: VerifyingKey, proof: bytes, public_inputs: list[int], device="cuda") -> bool:
    """Check a proof; the fold MSM runs on ``device``, the rest on the host."""
    torch.empty(0, device=device)  # a device that cannot run raises here, not as a rejection
    try:
        return _verify_inner(vk, proof, public_inputs, device)
    except (AssertionError, IndexError, ValueError):
        # adversarial proof bytes surface as these three (transcript
        # bounds/range/off-curve checks); anything else is a bug and raises
        return False


def _verify_inner(vk: VerifyingKey, proof: bytes, public_inputs: list[int], device) -> bool:
    n, k = vk.n, vk.k
    num_wires = vk.num_wires
    num_tables = len(vk.lookup_bits)
    omega = _omega(k)

    pubs = [p % R for p in public_inputs]
    assert len(pubs) == len(vk.pub_rows)

    t = TranscriptReader(proof)
    _absorb_vk(t._t, vk, pubs)

    chunks = _perm_chunks(num_wires)
    num_chunks = len(chunks)
    wire_comms = [t.read_point() for _ in range(num_wires)]
    m_comms = [t.read_point() for _ in range(num_tables)]
    beta = t.challenge()
    gamma = t.challenge()
    beta_lk = t.challenge()
    a_comms = [t.read_point() for _ in range(num_chunks - 1)]
    z_comm = t.read_point()
    h_comms = [t.read_point() for _ in range(num_tables)]
    alpha = t.challenge()
    num_pieces = max(_perm_ident_degree(num_wires), 4)
    piece_comms = [t.read_point() for _ in range(num_pieces)]
    x = t.challenge()

    # evaluation order must mirror the prover
    count_x = (num_wires + 8 + num_wires + num_tables + num_tables
               + (num_chunks - 1) + 1 + num_tables + num_pieces)
    evals_x = [t.read_scalar() for _ in range(count_x)]
    evals_w = [t.read_scalar() for _ in range(1 + num_tables)]

    v = t.challenge()
    u = t.challenge()
    pi_x = t.read_point()
    pi_w = t.read_point()
    assert t.finished()

    pos = 0
    wire_e = evals_x[pos : pos + num_wires]; pos += num_wires
    fixed_e = evals_x[pos : pos + 8]; pos += 8
    sigma_e = evals_x[pos : pos + num_wires]; pos += num_wires
    table_e = evals_x[pos : pos + num_tables]; pos += num_tables
    m_e = evals_x[pos : pos + num_tables]; pos += num_tables
    a_e = evals_x[pos : pos + num_chunks - 1]; pos += num_chunks - 1
    z_e = evals_x[pos]; pos += 1
    h_e = evals_x[pos : pos + num_tables]; pos += num_tables
    piece_e = evals_x[pos : pos + num_pieces]; pos += num_pieces
    zw_e = evals_w[0]
    hw_e = evals_w[1:]

    # --- GWC batched opening: start the fold MSM on the device first ------
    comms_x = (
        wire_comms + vk.fixed_commitments + vk.sigma_commitments
        + vk.table_commitments + m_comms + a_comms + [z_comm] + h_comms + piece_comms
    )
    comms_w = [z_comm] + h_comms

    vpow_x, vpow_w = [], []
    v1 = v2 = 0
    vp = 1
    for e in evals_x:
        vpow_x.append(vp)
        v1 = (v1 + vp * e) % R
        vp = vp * v % R
    vp = 1
    for e in evals_w:
        vpow_w.append(vp)
        v2 = (v2 + vp * e) % R
        vp = vp * v % R

    xw_pt = x * omega % R
    # e(pi_x + u pi_w, [tau]_2) == e(E1 + x pi_x + u(E2 + xw pi_w), [1]_2);
    # the whole right-hand fold is one MSM
    pts = comms_x + comms_w + [curve.G1_GEN, pi_x, pi_w]
    scs = (
        vpow_x
        + [u * vp % R for vp in vpow_w]
        + [(-(v1 + u * v2)) % R, x, u * xw_pt % R]
    )
    finish_rhs = msm.run_msm_async(scs, pts, device)

    # --- the folded identity at x ---------------------------------------
    xn = pow(x, n, R)
    van_x = (xn - 1) % R
    assert van_x != 0
    n_inv = pow(n, -1, R)

    def lagrange(i):
        wi = pow(omega, i, R)
        return wi * van_x % R * pow((x - wi) % R, -1, R) % R * n_inv % R

    l0_x = lagrange(0)
    pi_x_val = 0
    for row, p in zip(vk.pub_rows, pubs):
        pi_x_val = (pi_x_val - p * lagrange(row)) % R

    gate = fixed_e[7]
    for c in range(5):
        gate = (gate + fixed_e[c] * wire_e[c]) % R
    gate = (gate + fixed_e[5] * wire_e[0] % R * wire_e[1]) % R
    gate = (gate + fixed_e[6] * wire_e[2] % R * wire_e[3]) % R
    gate = (gate + pi_x_val) % R

    i_z1 = l0_x * ((z_e - 1) % R) % R

    k_cosets = _coset_ids(num_wires, k)
    apow = alpha
    acc = (gate + apow * i_z1) % R

    w = 0
    prev_a = None
    for j, csize in enumerate(chunks):
        pnum = 1
        pden = 1
        for _ in range(csize):
            pnum = pnum * ((wire_e[w] + beta * k_cosets[w] % R * x + gamma) % R) % R
            pden = pden * ((wire_e[w] + beta * sigma_e[w] + gamma) % R) % R
            w += 1
        apow = apow * alpha % R
        if j < num_chunks - 1:
            rhs = pnum if prev_a is None else prev_a * pnum % R
            acc = (acc + apow * (a_e[j] * pden - rhs)) % R
            prev_a = a_e[j]
        else:
            zn = z_e * pnum % R
            if prev_a is not None:
                zn = zn * prev_a % R
            acc = (acc + apow * (zn - zw_e * pden)) % R
    for tt in range(num_tables):
        a_b = (wire_e[5 + tt] + beta_lk) % R
        t_b = (table_e[tt] + beta_lk) % R
        i_h = ((hw_e[tt] - h_e[tt]) % R * a_b % R * t_b - (t_b - m_e[tt] * a_b)) % R
        apow = apow * alpha % R
        acc = (acc + apow * i_h) % R
        i_h0 = l0_x * h_e[tt] % R
        apow = apow * alpha % R
        acc = (acc + apow * i_h0) % R

    t_at_x = 0
    xp = 1
    for e in piece_e:
        t_at_x = (t_at_x + xp * e) % R
        xp = xp * xn % R
    assert acc == van_x * t_at_x % R, "folded identity fails at x"

    # --- pairing: the LHS Miller loop overlaps the in-flight device MSM ---
    lhs_g1 = curve.g1_add(pi_x, curve.g1_mul(pi_w, u))
    f = curve.FQ12_ONE
    if lhs_g1 is not None:
        f = curve.miller_loop_lines(lhs_g1, curve._g2_lines(vk.srs_g2_tau))
    rhs_g1 = finish_rhs()
    if rhs_g1 is not None:
        f = curve.fq12_mul(
            f,
            curve.miller_loop_lines(curve.g1_neg(rhs_g1), curve._g2_lines(vk.srs_g2_gen)),
        )
    return curve.final_exponentiation(f) == curve.FQ12_ONE

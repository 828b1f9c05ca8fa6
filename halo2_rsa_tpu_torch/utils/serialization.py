"""Persistence for the expensive proving artifacts.

Counterpart of ``halo2_rsa_tpu/utils/serialization.py``, in the same file
format, so that each package loads the other's keys bit for bit: a plain npz
(numpy) container + ints as little-endian byte blobs — no pickling of code.
The port writes it uncompressed (``np.savez``; zlib took over 99 % of a
compressed save), and ``np.load`` reads either kind.
Limb arrays are stored in the reference layout, (..., 16) uint32 16-bit
limbs (``vecfield.limbs_to_ref`` on save, ``convert.limbs`` on load); the
file names (``srs_k{k}_t{tau}.npz``, ``{fingerprint}_k{k}_pk.npz``) and the
circuit fingerprint are the reference's too.

The SRS is the expensive multi-second precomputation and keygen the next, so
both are first-class on-disk artifacts (halo2-rsa regenerates ParamsKZG and
the keys per process, ``benches/bench.rs:228-239``). Loaders put tensors on
``device`` ("cuda" unless the caller asks for the CPU); ``load_pk`` puts them
on its SRS's device, as ``plonk.keygen`` does.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .. import convert
from ..fields import vecfield
from ..prover import curve, g1_vec, kzg, plonk


def _int_to_bytes(x: int) -> bytes:
    return x.to_bytes(48, "little")


def _int_from_bytes(b) -> int:
    return int.from_bytes(bytes(b), "little")


def _srs_arrays(srs: kzg.SRS) -> dict:
    """The SRS's npz arrays, on the host."""
    g1 = [vecfield.limbs_to_ref(c) for c in srs.g1_powers]
    g2t = np.frombuffer(
        b"".join(_int_to_bytes(v) for pair in srs.g2_tau for v in pair), np.uint8
    )
    g2g = np.frombuffer(
        b"".join(_int_to_bytes(v) for pair in srs.g2_gen for v in pair), np.uint8
    )
    return dict(n=srs.n, g1x=g1[0], g1y=g1[1], g1z=g1[2], g2_tau=g2t, g2_gen=g2g)


def save_srs(srs: kzg.SRS, path: str) -> None:
    np.savez(path, **_srs_arrays(srs))


def load_srs(path: str, device="cuda") -> kzg.SRS:
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path)

    def g2_from(b):
        vals = [_int_from_bytes(b[i * 48 : (i + 1) * 48]) for i in range(4)]
        return ((vals[0], vals[1]), (vals[2], vals[3]))

    # normalize to affine (Z == 1) on load: older files carry projective
    # powers; commit MSMs rely on z_one (msm_many docstring)
    return kzg.SRS(
        n=int(z["n"]),
        g1_powers=g1_vec.points_to_affine(
            tuple(convert.limbs(z[c], device) for c in ("g1x", "g1y", "g1z"))
        ),
        g2_gen=g2_from(bytes(z["g2_gen"])),
        g2_tau=g2_from(bytes(z["g2_tau"])),
    )


def _vk_doc(vk) -> dict:
    """VerifyingKey -> JSON-able dict (points as decimal strings)."""

    def pt(p):
        return None if p is None else [str(p[0]), str(p[1])]

    def g2pt(p):
        return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])]]

    return {
        "k": vk.k,
        "n": vk.n,
        "num_wires": vk.num_wires,
        "lookup_bits": list(vk.lookup_bits),
        "fixed_commitments": [pt(c) for c in vk.fixed_commitments],
        "sigma_commitments": [pt(c) for c in vk.sigma_commitments],
        "table_commitments": [pt(c) for c in vk.table_commitments],
        "pub_rows": list(vk.pub_rows),
        "g2_gen": g2pt(vk.srs_g2_gen),
        "g2_tau": g2pt(vk.srs_g2_tau),
    }


def _vk_from_doc(doc: dict) -> plonk.VerifyingKey:
    def pt(c):
        return None if c is None else (int(c[0]), int(c[1]))

    def g2pt(c):
        return ((int(c[0][0]), int(c[0][1])), (int(c[1][0]), int(c[1][1])))

    return plonk.VerifyingKey(
        k=doc["k"],
        n=doc["n"],
        num_wires=doc["num_wires"],
        lookup_bits=tuple(doc["lookup_bits"]),
        fixed_commitments=[pt(c) for c in doc["fixed_commitments"]],
        sigma_commitments=[pt(c) for c in doc["sigma_commitments"]],
        table_commitments=[pt(c) for c in doc["table_commitments"]],
        pub_rows=doc["pub_rows"],
        srs_g2_gen=g2pt(doc["g2_gen"]),
        srs_g2_tau=g2pt(doc["g2_tau"]),
    )


def save_vk(vk, path: str) -> None:
    """VerifyingKey -> JSON (points as decimal strings)."""
    with open(path, "w") as f:
        json.dump(_vk_doc(vk), f)


def _pk_arrays(pk) -> dict:
    """The ProvingKey's npz arrays, on the host (its JSON meta as bytes)."""
    arrays = {
        "wire_source": np.asarray(pk.wire_source),
        "id_vals": vecfield.limbs_to_ref(pk.id_vals),
        "sigma_vals": vecfield.limbs_to_ref(pk.sigma_vals),
        "fixed_polys": vecfield.limbs_to_ref(pk.fixed_polys),
        "sigma_polys": vecfield.limbs_to_ref(pk.sigma_polys),
    }
    if pk.table_vals is not None:
        arrays["table_vals"] = vecfield.limbs_to_ref(pk.table_vals)
        arrays["table_polys"] = vecfield.limbs_to_ref(pk.table_polys)
    meta = {
        "k": pk.vk.k,
        "log_ext": pk.log_ext,
        "k_cosets": [str(c) for c in pk.k_cosets],
        "g1_tail": [[str(p[0]), str(p[1])] if p is not None else None for p in pk.g1_tail],
        "vk": _vk_doc(pk.vk),
    }
    return dict(meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)


def save_pk(pk, path: str) -> None:
    """ProvingKey -> npz. The SRS is NOT embedded (it is its own artifact,
    shared across circuits — pass it to :func:`load_pk`).

    The extended-coset arrays (fixed_ext/sigma_ext/...) are NOT persisted;
    :func:`load_pk` recomputes them from the coefficient polys."""
    np.savez(path, **_pk_arrays(pk))


def load_pk(path: str, srs: kzg.SRS) -> plonk.ProvingKey:
    """ProvingKey from :func:`save_pk`'s npz, on ``srs``'s device; the
    extended-coset arrays and the tail comb are rebuilt there
    (``plonk.build_ext_arrays``, ``plonk.tail_comb``)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    dev = srs.g1_powers[0].device
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    has_tables = "table_vals" in z.files
    vk = _vk_from_doc(meta["vk"])
    log_ext = int(meta["log_ext"])
    fixed_polys = convert.limbs(z["fixed_polys"], dev)
    sigma_polys = convert.limbs(z["sigma_polys"], dev)
    table_polys = convert.limbs(z["table_polys"], dev) if has_tables else None
    fixed_ext, sigma_ext, table_ext, l0_ext, x_ext, van_inv = plonk.build_ext_arrays(
        fixed_polys, sigma_polys, table_polys, vk.k, log_ext
    )
    pk = plonk.ProvingKey(
        vk=vk,
        srs=srs,
        wire_source=z["wire_source"],
        k_cosets=[int(c) for c in meta["k_cosets"]],
        log_ext=log_ext,
        id_vals=convert.limbs(z["id_vals"], dev),
        sigma_vals=convert.limbs(z["sigma_vals"], dev),
        table_vals=convert.limbs(z["table_vals"], dev) if has_tables else None,
        fixed_polys=fixed_polys,
        sigma_polys=sigma_polys,
        table_polys=table_polys,
        fixed_ext=fixed_ext,
        sigma_ext=sigma_ext,
        table_ext=table_ext,
        l0_ext=l0_ext,
        x_ext=x_ext,
        van_inv=van_inv,
        g1_tail=[
            (int(p[0]), int(p[1])) if p is not None else None
            for p in meta["g1_tail"]
        ],
    )
    plonk.tail_comb(pk)
    return pk


def load_vk(path: str) -> plonk.VerifyingKey:
    with open(path) as f:
        return _vk_from_doc(json.load(f))


# ---------------------------------------------------------------------------
# keygen-once / load-thereafter
# ---------------------------------------------------------------------------


def circuit_fingerprint(compiled) -> str:
    """Content hash of a compiled circuit's *structure* (gate wiring,
    coefficients, lookups, instance cells) — the key for on-disk pk/vk
    reuse. Any trace change invalidates the artifacts. The coefficient
    table is hashed in the reference layout, so both packages compute the
    same fingerprint for the same circuit."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(compiled.gate_idx).tobytes())
    h.update(np.ascontiguousarray(compiled.gate_coef_id).tobytes())
    h.update(np.ascontiguousarray(vecfield.limbs_to_ref(compiled.coef_table)).tobytes())
    for bits, idx in compiled.lookup_groups:
        h.update(bytes([bits]))
        h.update(np.ascontiguousarray(idx).tobytes())
    h.update(np.asarray(compiled.instance_idx, np.int64).tobytes())
    return h.hexdigest()[:16]


def load_or_keygen(compiled, k: int, keys_dir: str, tau: int = 777, device="cuda"):
    """Load (srs, pk, vk) for this circuit from ``keys_dir``, or generate
    and persist them: keygen paid once, not once per process. Returns (srs,
    pk, vk, loaded: bool)."""
    os.makedirs(keys_dir, exist_ok=True)
    fp = circuit_fingerprint(compiled)
    base = os.path.join(keys_dir, f"{fp}_k{k}")
    # the SRS depends only on (k, tau) — share it across circuits (both
    # k=17 SHA configs load ONE powers-of-tau artifact, like any two
    # halo2 circuits sharing a ParamsKZG file)
    srs_path = os.path.join(keys_dir, f"srs_k{k}_t{tau}.npz")
    pk_path = base + "_pk.npz"
    if os.path.exists(srs_path) and os.path.exists(pk_path):
        srs = load_srs(srs_path, device)
        pk = load_pk(pk_path, srs)
        return srs, pk, pk.vk, True
    n_srs = (1 << k) + plonk.BLIND
    if os.path.exists(srs_path):
        srs = load_srs(srs_path, device)
    else:
        srs = kzg.setup(n_srs, tau=tau, device=device)
        # atomic writes: a run cut off mid-save must not leave a corrupt
        # artifact that every later run would try to load
        save_srs(srs, srs_path[: -len(".npz")] + "_tmp")
        os.replace(srs_path[: -len(".npz")] + "_tmp.npz", srs_path)
    pk, vk = plonk.keygen(compiled, srs, k=k)
    save_pk(pk, base + "_pk_tmp")
    os.replace(base + "_pk_tmp.npz", pk_path)
    return srs, pk, vk, False


# ---------------------------------------------------------------------------
# snarkjs .ptau ingestion (production trusted-setup artifacts)
# ---------------------------------------------------------------------------
#
# Production deployments load a ceremony's powers of tau instead of a toy
# setup. The snarkjs "powers of tau" container:
#   magic "ptau" | u32 version | u32 nSections |
#   { u32 sectionId | u64 sectionSize | payload } ...
#   section 1 (header): u32 n8 | n8-byte prime q (LE) | u32 power | u32 cpow
#   section 2 (tauG1):  2*2^power-1 points, each 2*n8 bytes — x,y Montgomery
#                        (R = 2^(8*n8) mod q), little-endian
#   section 3 (tauG2):  2^power points, each 4*n8 bytes — x.c0,x.c1,y.c0,y.c1

_PTAU_MAGIC = b"ptau"


def _ptau_sections(data: bytes) -> dict:
    assert data[:4] == _PTAU_MAGIC, "not a .ptau file"
    n_sections = int.from_bytes(data[8:12], "little")
    pos = 12
    sections = {}
    for _ in range(n_sections):
        sid = int.from_bytes(data[pos : pos + 4], "little")
        size = int.from_bytes(data[pos + 4 : pos + 12], "little")
        sections[sid] = (pos + 12, size)
        pos += 12 + size
    return sections


def load_srs_ptau(path: str, n: int, device="cuda") -> kzg.SRS:
    """Build an SRS from the first ``n`` tau-G1 powers of a snarkjs .ptau
    ceremony file (bn128). Curve membership of every loaded point is
    checked; Montgomery coordinates are converted to standard form."""
    with open(path, "rb") as f:
        data = f.read()
    sections = _ptau_sections(data)
    off, _ = sections[1]
    n8 = int.from_bytes(data[off : off + 4], "little")
    q = int.from_bytes(data[off + 4 : off + 4 + n8], "little")
    assert q == curve.Q, ".ptau prime is not BN254 Fq"
    power = int.from_bytes(data[off + 4 + n8 : off + 8 + n8], "little")
    assert n <= (1 << power) * 2 - 1, f".ptau power {power} too small for n={n}"
    r_inv = pow(1 << (8 * n8), -1, q)

    def read_fq(pos: int) -> int:
        return int.from_bytes(data[pos : pos + n8], "little") * r_inv % q

    g1_off, g1_size = sections[2]
    assert g1_size >= n * 2 * n8, ".ptau tauG1 section too small"
    pts = []
    for i in range(n):
        p = g1_off + i * 2 * n8
        pt = (read_fq(p), read_fq(p + n8))
        assert curve.g1_is_on_curve(pt), f"tauG1[{i}] not on curve"
        pts.append(pt)

    g2_off, g2_size = sections[3]
    assert g2_size >= 2 * 4 * n8, ".ptau tauG2 section too small"

    def read_g2(pos: int):
        pt = (
            (read_fq(pos), read_fq(pos + n8)),
            (read_fq(pos + 2 * n8), read_fq(pos + 3 * n8)),
        )
        assert curve.g2_is_on_curve(pt), "tauG2 point not on curve"
        return pt

    g2_gen = read_g2(g2_off)
    g2_tau = read_g2(g2_off + 4 * n8)
    assert g2_gen == curve.G2_GEN, ".ptau tauG2[0] is not the G2 generator"
    return kzg.SRS(
        n=n,
        g1_powers=g1_vec.points_to_device(pts, device=device),
        g2_gen=g2_gen,
        g2_tau=g2_tau,
    )


def save_srs_ptau(srs: kzg.SRS, path: str, power: int) -> None:
    """Write an SRS in snarkjs .ptau layout (testing/interop; sections 1-3).

    ``power`` must satisfy 2^power >= srs.n (section 2 is padded with the
    generator repeated — readers only consume the first n points they need).
    """
    n8 = 32
    q = curve.Q
    r = 1 << (8 * n8)

    def fq(x: int) -> bytes:
        return (x * r % q).to_bytes(n8, "little")

    g1_pts = srs.g1_affine()
    count1 = (1 << power) * 2 - 1
    assert len(g1_pts) <= count1
    body1 = b"".join(fq(p[0]) + fq(p[1]) for p in g1_pts)
    body1 += (fq(curve.G1_GEN[0]) + fq(curve.G1_GEN[1])) * (count1 - len(g1_pts))

    def g2b(p) -> bytes:
        return fq(p[0][0]) + fq(p[0][1]) + fq(p[1][0]) + fq(p[1][1])

    count2 = 1 << power
    body3 = g2b(srs.g2_gen) + g2b(srs.g2_tau)
    body3 += g2b(srs.g2_gen) * (count2 - 2)

    head = n8.to_bytes(4, "little") + q.to_bytes(n8, "little")
    head += power.to_bytes(4, "little") + power.to_bytes(4, "little")

    with open(path, "wb") as f:
        f.write(_PTAU_MAGIC + (1).to_bytes(4, "little") + (3).to_bytes(4, "little"))
        for sid, body in ((1, head), (2, body1), (3, body3)):
            f.write(sid.to_bytes(4, "little") + len(body).to_bytes(8, "little"))
            f.write(body)

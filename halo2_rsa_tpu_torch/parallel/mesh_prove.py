"""Multi-rank kernel provider for the PLONK prover.

Counterpart of ``halo2_rsa_tpu/parallel/mesh_prove.py``. :class:`MeshKernels`
implements the prover's kernel-provider interface (``plonk.LocalKernels``:
``intt_batch``, ``msm_many``, ``round3_t``) over the ranks of one mesh axis,
and plugs into ``plonk.prove(..., kern=MeshKernels(mesh))``.

Every rank runs the same ``prove`` with the same ``rng`` and proving key
(SPMD). Each method receives whole tensors, the same on every rank, as
``LocalKernels`` does, and returns the whole result on every rank; inside,
each rank does 1/D of the work and data moves only through the collectives
of :mod:`.comm`:

* **column iNTTs** — the four-step transform of :mod:`.sharded_ntt` (one
  all-to-all, then one all-gather of the result);
* **commitment / opening MSMs** — each rank runs the bucket pipeline over
  its 1/D of the points; the window sums of every poly chunk are
  all-gathered once per call and combined by a log2(D) tree of K3 adds
  (``sharded_msm._tree_reduce_dev_axis``);
* **quotient (round 3)** — the forward four-step on the extended coset,
  the identity ``plonk._quotient_ident_ext`` on the rows each rank holds
  after it (the proving key's extended-coset rows at those indices are
  taken once per key), the rows moved to the inverse's column blocks
  (nothing moves when log2 of the extended size is even), the inverse
  four-step, the coset-inverse scale on the held rows, one all-gather.

Proof bytes equal the single-device proof's: the field is exact and the
transcript sees the same values. Shapes too small to shard run the local
kernels, as in the JAX package (a 2^k NTT needs k >= 2·ceil(log2 D), an MSM
at least 2·D points); ``fallbacks`` counts them.
"""

from __future__ import annotations

import torch

from ..fields import vecfield
from ..fields.cuda_mont import LIMBS
from ..fields.field import BN254_FR
from ..fields.vecfield import mont_mul as _vmul
from ..prover import curve, g1_vec
from ..prover import msm as msm_mod
from ..prover import ntt as ntt_mod
from ..prover import plonk
from .sharded_msm import gather_window_sums
from .sharded_ntt import (
    _four_step_block,
    column_block,
    gather_natural,
    held_indices,
    held_to_columns,
    intt_sharded,
)

FR = vecfield.consts(BN254_FR)


class MeshKernels:
    """Sharded kernel provider for ``plonk.prove(..., kern=...)``, over the
    ranks of ``mesh``'s ``axis``."""

    def __init__(self, mesh, axis: str = "rows"):
        assert axis in mesh.shape, f"mesh has no '{axis}' axis"
        self.mesh = mesh
        self.axis = axis
        self.d = mesh.shape[axis]
        self.r = mesh.coords[axis]
        self._log_d = max(0, (self.d - 1).bit_length())
        self._rows = None  # (pk, {name: its extended-coset rows this rank holds})
        self.fallbacks = {"intt_batch": 0, "msm_many": 0, "round3_t": 0}

    # -- NTT ---------------------------------------------------------------

    def _can_shard_ntt(self, log_n: int) -> bool:
        return log_n >= 2 * max(1, self._log_d)

    def intt_batch(self, vals, k: int):
        if not self._can_shard_ntt(k):
            self.fallbacks["intt_batch"] += 1
            return ntt_mod.intt_batch(vals, k)
        return intt_sharded(vals, k, self.mesh, self.axis)

    # -- MSM ---------------------------------------------------------------

    def _shard(self, scalars, points, n: int, nloc: int, z_one: bool):
        """This rank's nloc scalars (P, nloc, 8) and points: views of the
        caller's tensors (the SRS shard is not copied), padded past n with
        zero scalars on the generator (``z_one``) or the identity."""
        lo, hi = self.r * nloc, (self.r + 1) * nloc
        sc = scalars[:, lo:min(hi, n)]
        pts = tuple(c[lo:min(hi, n)] for c in points)
        pad = hi - max(lo, n)
        if pad > 0:
            dev = scalars.device
            sc = torch.cat([sc, torch.zeros((sc.shape[0], pad, LIMBS), dtype=torch.int32,
                                            device=dev)], dim=1)
            if z_one:
                gen = g1_vec.points_to_device([curve.G1_GEN], device=dev)
                padp = tuple(c.expand(pad, LIMBS) for c in gen)
            else:
                padp = g1_vec.identity((pad,), device=dev)
            pts = tuple(torch.cat([c, ic], dim=0) for c, ic in zip(pts, padp))
        return sc, pts

    def msm_many(self, scalars, points, z_one: bool = False):
        p, n = scalars.shape[:2]
        d = self.d
        if n < 2 * d:  # trivial sizes: not worth a collective
            self.fallbacks["msm_many"] += 1
            return msm_mod.msm_many(scalars, points, z_one)
        npad = -(-n // d) * d
        # the rank's shard plays the single-device point-axis segment: window
        # width of the whole size, capped at the segment class
        wb = msm_mod._window_bits_for(min(npad, msm_mod._SEG))
        nloc = npad // d
        pc = max(1, msm_mod._pick_pchunk(min(nloc, msm_mod._SEG)) // 2)
        sc, pts = self._shard(scalars, points, n, nloc, z_one)
        chunks = []
        i = 0
        for size in msm_mod._chunk_plan(p, pc):
            chunks.append(msm_mod._msm_chunk_sums(sc[i : i + size], pts, wb, z_one))
            i += size
        local = tuple(torch.cat([ch[c] for ch in chunks], dim=0) for c in range(3))
        return msm_mod._window_combine(gather_window_sums(self.mesh, self.axis, local), wb)

    # -- round 3 (quotient) ------------------------------------------------

    def _pk_rows(self, pk) -> dict:
        """The proving key's extended-coset arrays at the indices this rank
        holds after a four-step, taken once per key."""
        if self._rows is None or self._rows[0] is not pk:
            idx = torch.from_numpy(held_indices(pk.log_ext, self.d, self.r)).to(pk.device)
            rows = dict(idx=idx, fixed_ext=pk.fixed_ext[:, idx], sigma_ext=pk.sigma_ext[:, idx],
                        l0_ext=pk.l0_ext[idx], x_ext=pk.x_ext[idx], van_inv=pk.van_inv[idx])
            if pk.table_ext is not None:
                rows["table_ext"] = pk.table_ext[:, idx]
            self._rows = (pk, rows)
        return self._rows[1]

    def round3_t(self, pk, num_tables: int, wire_polys, m_polys, a_polys,
                 z_poly, h_polys, pi_poly, table_ext, coset_scale,
                 omega_scale, cinv_scale, alpha_pows, beta_m, gamma_m,
                 beta_lk_m, kw_beta):
        log_ext = pk.log_ext
        if not self._can_shard_ntt(log_ext):
            self.fallbacks["round3_t"] += 1
            return plonk.LocalKernels.round3_t(
                plonk._LOCAL_KERNELS, pk, num_tables, wire_polys, m_polys,
                a_polys, z_poly, h_polys, pi_poly, table_ext, coset_scale,
                omega_scale, cinv_scale, alpha_pows, beta_m, gamma_m,
                beta_lk_m, kw_beta,
            )
        mesh, axis = self.mesh, self.axis
        rows = self._pk_rows(pk)
        big = _stack_scale_pad(num_tables, log_ext, wire_polys, m_polys, a_polys, z_poly,
                               h_polys, pi_poly, omega_scale, coset_scale)
        ext = _four_step_block(column_block(big, log_ext, mesh, axis), log_ext, False, mesh, axis)
        del big
        tab = rows["table_ext"] if table_ext is pk.table_ext else table_ext[:, rows["idx"]]
        t_held = plonk._quotient_ident_ext(
            pk.vk.num_wires, num_tables, ext.reshape(ext.shape[0], -1, LIMBS),
            rows["fixed_ext"], rows["sigma_ext"], tab, rows["l0_ext"], rows["x_ext"],
            rows["van_inv"], alpha_pows, beta_m, gamma_m, beta_lk_m, kw_beta,
        )
        del ext
        cols = held_to_columns(t_held[None], log_ext, mesh, axis)
        coeffs = _four_step_block(cols, log_ext, True, mesh, axis)  # (1, A/D, B, 8)
        scaled = _vmul(FR, coeffs.reshape(-1, LIMBS), cinv_scale[rows["idx"]])
        return gather_natural(scaled.reshape(coeffs.shape), log_ext, mesh, axis)[0]


def _stack_scale_pad(num_tables: int, log_ext: int, wire_polys, m_polys, a_polys, z_poly,
                     h_polys, pi_poly, omega_scale, coset_scale):
    """Round 3's poly stack, coset-scaled and zero-padded to the extended
    domain (the pre-NTT half of ``plonk._coset_eval_graph``)."""
    big = plonk._round3_stack(num_tables, wire_polys, m_polys, a_polys, z_poly, h_polys,
                              pi_poly, omega_scale)
    p, l, _ = big.shape
    scaled = _vmul(FR, big, coset_scale[None])
    return torch.cat(
        [scaled, torch.zeros((p, (1 << log_ext) - l, LIMBS), dtype=torch.int32, device=big.device)],
        dim=1,
    )

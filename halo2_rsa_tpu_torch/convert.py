"""Carry state across from the JAX package.

The reference holds field elements as ``(..., 16)`` uint32 numpy/JAX arrays
of 16-bit limbs; the port as ``(..., 8)`` int32 tensors of 32-bit limbs. Both
are the same canonical Montgomery values, so these functions only re-pack
limbs. They take numpy arrays and plain objects with the reference's
attribute names (duck-typed): call ``np.asarray`` on JAX arrays first, or
pass the reference objects, whose arrays ``np.asarray`` accepts.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import vecfield
from .prover import kzg, plonk


def limbs(arr16, device="cuda") -> torch.Tensor:
    """Reference (..., 16) uint32 limb array -> port (..., 8) int32 tensor."""
    return torch.from_numpy(vecfield.limbs_from_ref(np.asarray(arr16))).to(device)


def points(coords16, device="cuda") -> tuple:
    """Reference projective coordinate tuple -> port coordinate tuple."""
    return tuple(limbs(c, device) for c in coords16)


def srs(ref_srs, device="cuda") -> kzg.SRS:
    """Reference ``kzg.SRS`` (n, g1_powers, g2_gen, g2_tau) -> port SRS."""
    return kzg.SRS(
        n=int(ref_srs.n),
        g1_powers=points(ref_srs.g1_powers, device),
        g2_gen=tuple(ref_srs.g2_gen),
        g2_tau=tuple(ref_srs.g2_tau),
    )


def verifying_key(ref_vk) -> plonk.VerifyingKey:
    """Reference ``VerifyingKey`` -> port (host data only)."""
    return plonk.VerifyingKey(
        k=int(ref_vk.k),
        n=int(ref_vk.n),
        num_wires=int(ref_vk.num_wires),
        lookup_bits=tuple(int(b) for b in ref_vk.lookup_bits),
        fixed_commitments=list(ref_vk.fixed_commitments),
        sigma_commitments=list(ref_vk.sigma_commitments),
        table_commitments=list(ref_vk.table_commitments),
        pub_rows=[int(r) for r in ref_vk.pub_rows],
        srs_g2_gen=tuple(ref_vk.srs_g2_gen),
        srs_g2_tau=tuple(ref_vk.srs_g2_tau),
        g1_gen=tuple(ref_vk.g1_gen),
    )


def _opt(arr16, device):
    return None if arr16 is None else limbs(arr16, device)


def proving_key(ref_pk, device="cuda") -> plonk.ProvingKey:
    """Reference ``ProvingKey`` -> port, field by field (plonk.py:91-120)."""
    return plonk.ProvingKey(
        vk=verifying_key(ref_pk.vk),
        srs=srs(ref_pk.srs, device),
        wire_source=np.asarray(ref_pk.wire_source, dtype=np.int32),
        k_cosets=[int(x) for x in ref_pk.k_cosets],
        log_ext=int(ref_pk.log_ext),
        id_vals=limbs(ref_pk.id_vals, device),
        sigma_vals=limbs(ref_pk.sigma_vals, device),
        table_vals=_opt(ref_pk.table_vals, device),
        fixed_polys=limbs(ref_pk.fixed_polys, device),
        sigma_polys=limbs(ref_pk.sigma_polys, device),
        table_polys=_opt(ref_pk.table_polys, device),
        fixed_ext=limbs(ref_pk.fixed_ext, device),
        sigma_ext=limbs(ref_pk.sigma_ext, device),
        table_ext=_opt(ref_pk.table_ext, device),
        l0_ext=limbs(ref_pk.l0_ext, device),
        x_ext=limbs(ref_pk.x_ext, device),
        van_inv=limbs(ref_pk.van_inv, device),
        g1_tail=list(ref_pk.g1_tail),
    )

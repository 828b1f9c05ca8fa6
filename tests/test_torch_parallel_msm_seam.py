"""``MeshKernels.msm_many`` across the point-axis segment seam, on 2 gloo
ranks on the CPU, against the JAX package's (``__graft_entry__.py``'s
section 4b).

``msm._SEG`` is scaled to 2^10 in both packages, so that the mesh MSM's
segment rules (window width capped at the segment class, per-rank poly
chunk halved) run as they do at the production 2^15 class: 2 polys of
2^11 scalars over 64 distinct points tiled 32 times, with ``z_one``. Every
rank's projective result must equal the JAX package's, and in affine form
the host group law on the 64 base points with the tiled scalars summed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from halo2_rsa_tpu.parallel.mesh_prove import MeshKernels as JMeshKernels
from halo2_rsa_tpu.prover import g1_vec as jg1
from halo2_rsa_tpu.prover import msm as jmsm
from halo2_rsa_tpu_torch.fields import BN254_FR
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.parallel import launch, ranks
from halo2_rsa_tpu_torch.prover import curve
from halo2_rsa_tpu_torch.prover import g1_vec as tg1
from halo2_rsa_tpu_torch.prover import msm as tmsm

torch.set_num_threads(1)
D = 2
SEG = 1 << 10
N_BIG = 1 << 11
N_BASE = 64


def _inputs():
    """(P, N_BIG, 8) standard-form scalar limbs (each < 2^252), the base
    points."""
    rng = np.random.default_rng(4)
    sc = rng.integers(0, 1 << 32, (2, N_BIG, 8), dtype=np.uint64).astype(np.uint32)
    sc[..., 7] &= 0x0FFFFFFF
    return sc.view(np.int32), [curve.g1_mul(curve.G1_GEN, i + 1) for i in range(N_BASE)]


@pytest.fixture(scope="module")
def port():
    sc, base = _inputs()
    pts = np.stack([c.numpy() for c in tg1.points_to_device(base, device="cpu")])
    case = ("seam", "many", sc, np.tile(pts, (1, N_BIG // N_BASE, 1)), True, SEG)
    res = launch.spawn(ranks.msm_cases, D, "gloo", device="cpu", timeout=300, args=([case],),
                       threads=1)
    return [r["seam"] for r in res]


def test_seam_equals_jax_in_projective_coordinates(port, monkeypatch):
    sc, base = _inputs()
    monkeypatch.setattr(jmsm, "_SEG", SEG)
    mesh = Mesh(np.array(jax.devices()[:D]).reshape(D), ("rows",))
    pts = tuple(jnp.tile(c, (N_BIG // N_BASE, 1)) for c in jg1.points_to_device(base))
    res = JMeshKernels(mesh).msm_many(jnp.asarray(tvf.limbs_to_ref(sc)), pts, z_one=True)
    want = np.stack([np.asarray(c) for c in res])
    for rank, (coords, _) in enumerate(port):
        assert np.array_equal(tvf.limbs_to_ref(coords), want), rank


def test_seam_equals_host_group_law(port):
    sc, base = _inputs()
    ints = [tvf.to_ints(tvf.consts(BN254_FR), sc[p], mont=False) for p in range(2)]
    want = [tmsm.msm_host([sum(s[j::N_BASE]) % curve.R for j in range(N_BASE)], base)
            for s in ints]
    for rank, (coords, fallbacks) in enumerate(port):
        assert tg1.points_from_device(tuple(torch.from_numpy(c) for c in coords)) == want, rank
        assert fallbacks == {"intt_batch": 0, "msm_many": 0, "round3_t": 0}

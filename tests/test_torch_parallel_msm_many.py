"""The PyTorch port's ``MeshKernels.msm_many`` on 2 gloo ranks on the CPU,
against the JAX package's and the host group law.

With ``z_one`` and P = 3 polys, at an aligned n and at an n that is not a
multiple of D (padded with the generator), every rank's result must equal
the JAX package's ``MeshKernels.msm_many`` in projective coordinates (the
same window sums, tree pairs and Horner order) and ``msm.msm_host`` in
affine form, with no local fallback taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from halo2_rsa_tpu.fields import BN254_FR as J_BN254_FR
from halo2_rsa_tpu.fields import vecfield as jvf
from halo2_rsa_tpu.parallel.mesh_prove import MeshKernels as JMeshKernels
from halo2_rsa_tpu.prover import g1_vec as jg1
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.parallel import launch, ranks
from halo2_rsa_tpu_torch.prover import curve
from halo2_rsa_tpu_torch.prover import g1_vec as tg1
from halo2_rsa_tpu_torch.prover import msm as tmsm
from halo2_rsa_tpu_torch.prover import ntt as tntt

torch.set_num_threads(1)
D = 2
P = 3
CASES = {"aligned": 64, "padded": 63}


def _inputs(name):
    """(scalar ints per poly, affine points) of a case, from its seed."""
    n = CASES[name]
    rng = np.random.default_rng(list(name.encode()))
    pts = [curve.g1_mul(curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, n)]
    words = rng.integers(0, 1 << 32, (P * n, 8), dtype=np.uint64)
    sc = [int.from_bytes(w.astype("<u4").tobytes(), "little") % curve.R for w in words]
    return [sc[i * n : (i + 1) * n] for i in range(P)], pts


@pytest.fixture(scope="module")
def port():
    cases = []
    for name in CASES:
        sc, pts = _inputs(name)
        limbs = np.stack([tvf.from_ints_np(tntt.FR, s, mont=False) for s in sc])
        points = np.stack([c.numpy() for c in tg1.points_to_device(pts, device="cpu")])
        cases.append((name, "many", limbs, points, True, None))
    res = launch.spawn(ranks.msm_cases, D, "gloo", device="cpu", timeout=300, args=(cases,),
                       threads=1)
    return {name: [r[name] for r in res] for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_equals_host_group_law(port, name):
    sc, pts = _inputs(name)
    want = [tmsm.msm_host(s, pts) for s in sc]
    for rank, (coords, _) in enumerate(port[name]):
        assert tg1.points_from_device(tuple(torch.from_numpy(c) for c in coords)) == want, rank


@pytest.mark.parametrize("name", list(CASES))
def test_equals_jax_in_projective_coordinates(port, name):
    sc, pts = _inputs(name)
    fr = jvf.consts(J_BN254_FR)
    mesh = Mesh(np.array(jax.devices()[:D]).reshape(D), ("rows",))
    res = JMeshKernels(mesh).msm_many(
        jnp.stack([jvf.from_ints(fr, s, mont=False) for s in sc]), jg1.points_to_device(pts),
        z_one=True)
    want = np.stack([np.asarray(c) for c in res])
    for rank, (coords, _) in enumerate(port[name]):
        assert np.array_equal(tvf.limbs_to_ref(coords), want), rank


@pytest.mark.parametrize("name", list(CASES))
def test_takes_the_sharded_path(port, name):
    for coords, fallbacks in port[name]:
        assert coords.shape == (3, P, 8)
        assert fallbacks == {"intt_batch": 0, "msm_many": 0, "round3_t": 0}

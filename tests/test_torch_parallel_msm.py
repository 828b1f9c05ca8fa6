"""The PyTorch port's multi-rank MSM (``parallel.sharded_msm``) on gloo
ranks on the CPU, against the JAX package's and the host group law.

``make_sharded_msm`` on 2·D points and on an unaligned n (identity
padding; at D = 4 and n = 9 the last rank holds padding only) must equal
``msm.msm_host`` in affine form, and at D = 2 the JAX package's
``make_sharded_msm`` in projective coordinates. Below 2·D points
``MeshKernels.msm_many`` takes the local MSM and counts the fallback
(the sharded cases are ``test_torch_parallel_msm_many.py``'s).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from halo2_rsa_tpu.fields import BN254_FR as J_BN254_FR
from halo2_rsa_tpu.fields import vecfield as jvf
from halo2_rsa_tpu.parallel import make_sharded_msm as jmake_sharded_msm
from halo2_rsa_tpu.prover import g1_vec as jg1
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.parallel import launch, ranks
from halo2_rsa_tpu_torch.prover import curve
from halo2_rsa_tpu_torch.prover import g1_vec as tg1
from halo2_rsa_tpu_torch.prover import msm as tmsm
from halo2_rsa_tpu_torch.prover import ntt as tntt

torch.set_num_threads(1)
R = curve.R

# name -> (D, kind, P (None: one MSM), n)
CASES = {
    "sharded-d2-aligned": (2, "sharded", None, 4),
    "sharded-d2-unaligned": (2, "sharded", None, 3),
    "sharded-d4-aligned": (4, "sharded", None, 8),
    "sharded-d4-unaligned": (4, "sharded", None, 9),
    "many-d2-below-2d": (2, "many", 3, 3),
}


def _inputs(name):
    """(scalar ints per poly, affine points) of a case, from its seed."""
    d, kind, p, n = CASES[name]
    rng = np.random.default_rng(list(name.encode()))
    pts = [curve.g1_mul(curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, n)]
    words = rng.integers(0, 1 << 32, ((p or 1) * n, 8), dtype=np.uint64)
    sc = [int.from_bytes(w.astype("<u4").tobytes(), "little") % R for w in words]
    return [sc[i * n : (i + 1) * n] for i in range(p or 1)], pts


def _port_args(name):
    d, kind, p, n = CASES[name]
    sc, pts = _inputs(name)
    limbs = np.stack([tvf.from_ints_np(tntt.FR, s, mont=False) for s in sc])
    points = np.stack([c.numpy() for c in tg1.points_to_device(pts, device="cpu")])
    return (name, kind, limbs[0] if p is None else limbs, points, True, None)


@pytest.fixture(scope="module")
def port():
    out = {}
    for d in (2, 4):
        cases = [_port_args(name) for name, c in CASES.items() if c[0] == d]
        res = launch.spawn(ranks.msm_cases, d, "gloo", device="cpu", timeout=300, args=(cases,),
                           threads=1)
        for name, *_ in cases:
            out[name] = [r[name] for r in res]
    return out


def _affine(coords) -> list:
    """(3, ..., 8) port coordinates -> host affine points."""
    return tg1.points_from_device(tuple(torch.from_numpy(c) for c in coords))


def _host(name) -> list:
    sc, pts = _inputs(name)
    return [tmsm.msm_host(s, pts) for s in sc]


def _jax(name):
    """The JAX package's result of a case, (3, 16) limbs."""
    d, kind, p, n = CASES[name]
    sc, pts = _inputs(name)
    mesh = Mesh(np.array(jax.devices()[:d]).reshape(d), ("rows",))
    limbs = jvf.from_ints(jvf.consts(J_BN254_FR), sc[0], mont=False)
    res = _jax_sharded_fn(mesh)(limbs, jg1.points_to_device(pts))
    return np.stack([np.asarray(c) for c in res])


_JAX_FNS = {}


def _jax_sharded_fn(mesh):
    """One JAX sharded MSM per mesh: the aligned and unaligned cases pad to
    the same shape and reuse its compiled graph."""
    key = mesh.shape["rows"]
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jmake_sharded_msm(mesh)
    return _JAX_FNS[key]


@pytest.mark.parametrize("name", [n for n in CASES if n != "many-d2-below-2d"])
def test_equals_host_group_law(port, name):
    want = _host(name)
    for rank, got in enumerate(port[name]):
        assert _affine(got[:, None]) == want, rank


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[:2] == (2, "sharded")])
def test_equals_jax_in_projective_coordinates(port, name):
    want = _jax(name)
    for rank, got in enumerate(port[name]):
        assert np.array_equal(tvf.limbs_to_ref(got), want), rank


def test_below_two_points_per_rank_runs_the_local_msm(port):
    name = "many-d2-below-2d"
    sc, pts = _inputs(name)
    limbs = torch.from_numpy(np.stack([tvf.from_ints_np(tntt.FR, s, mont=False) for s in sc]))
    want = tmsm.msm_many(limbs, tg1.points_to_device(pts, device="cpu"), z_one=True)
    for rank, (coords, fallbacks) in enumerate(port[name]):
        assert np.array_equal(coords, np.stack([c.numpy() for c in want])), rank
        assert fallbacks == {"intt_batch": 0, "msm_many": 1, "round3_t": 0}


"""The PyTorch port's four-step sharded NTT (``parallel.sharded_ntt``) on
gloo ranks on the CPU, against the JAX package's.

Inputs are seeded Montgomery limbs, single (N, 8) and batched (3, N, 8).
On D = 2 and 4 ranks (the JAX side on the conftest's virtual mesh,
restricted to its first D devices), at log2 N = 6 and 8, every rank's
``ntt_sharded`` / ``intt_sharded`` must equal the JAX package's
``ntt_sharded`` / ``intt_sharded`` on the same D bit for bit, and the
port's single-device ``ntt`` / ``intt``. The round trip must give the input
back on the rows axis of a (2, 2) mesh, and through round 3's path
between two transforms (``held_to_columns``), also at log2 N = 7, where
rows change rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from halo2_rsa_tpu.parallel import intt_sharded as jintt_sharded
from halo2_rsa_tpu.parallel import ntt_sharded as jntt_sharded
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.parallel import launch, ranks
from halo2_rsa_tpu_torch.prover import ntt as tntt

torch.set_num_threads(1)
DS = (2, 4)
CASES = [(d, log_n, batched) for d in DS for log_n in (6, 8) for batched in (False, True)]
ODD = [(d, 7, batched) for d in DS for batched in (False, True)]


def _name(d, log_n, batched):
    return f"d{d}-n{log_n}-{'batched' if batched else 'single'}"


def _values(d, log_n, batched):
    rng = np.random.default_rng([d, log_n, batched])
    n = 1 << log_n
    words = rng.integers(0, 1 << 32, ((3 if batched else 1) * n, 8), dtype=np.uint64)
    vals = [int.from_bytes(w.astype("<u4").tobytes(), "little") for w in words]
    x = tvf.from_ints_np(tntt.FR, vals, mont=True)
    return x.reshape(3, n, 8) if batched else x


@pytest.fixture(scope="module")
def port():
    """{case name: each rank's (ntt, intt, intt(ntt), held round trip)}."""
    out = {}
    for d in DS:
        cases = [(_name(*c), c[1], _values(*c), (d,), ("rows",), "rows")
                 for c in CASES + ODD if c[0] == d]
        if d == 4:
            cases += [(f"2x2-n{log_n}", log_n, _values(4, log_n, True), (2, 2), ("data", "rows"),
                       "rows") for log_n in (6, 7, 8)]
        res = launch.spawn(ranks.ntt_cases, d, "gloo", device="cpu", timeout=240, args=(cases,),
                           threads=1)
        for name, *_ in cases:
            out[name] = [r[name] for r in res]
    return out


@pytest.mark.parametrize("d,log_n,batched", CASES, ids=[_name(*c) for c in CASES])
def test_sharded_ntt_equals_jax_sharded(port, d, log_n, batched):
    mesh = Mesh(np.array(jax.devices()[:d]).reshape(d), ("rows",))
    x = jnp.asarray(tvf.limbs_to_ref(_values(d, log_n, batched)))
    want_f = np.asarray(jntt_sharded(x, log_n, mesh))
    want_i = np.asarray(jintt_sharded(x, log_n, mesh))
    for rank, (fwd, inv, _, _) in enumerate(port[_name(d, log_n, batched)]):
        assert np.array_equal(tvf.limbs_to_ref(fwd), want_f), rank
        assert np.array_equal(tvf.limbs_to_ref(inv), want_i), rank


@pytest.mark.parametrize("d,log_n,batched", CASES + ODD, ids=[_name(*c) for c in CASES + ODD])
def test_sharded_ntt_equals_single_device(port, d, log_n, batched):
    x = torch.from_numpy(_values(d, log_n, batched))
    fwd_1 = tntt.ntt_batch if batched else tntt.ntt
    inv_1 = tntt.intt_batch if batched else tntt.intt
    want_f, want_i = fwd_1(x, log_n).numpy(), inv_1(x, log_n).numpy()
    for rank, (fwd, inv, rt, back) in enumerate(port[_name(d, log_n, batched)]):
        assert np.array_equal(fwd, want_f) and np.array_equal(inv, want_i), rank
        assert np.array_equal(rt, x.numpy()) and np.array_equal(back, x.numpy()), rank


@pytest.mark.parametrize("log_n", (6, 7, 8))
def test_round_trip_on_rows_axis_of_2x2_mesh(port, log_n):
    x = _values(4, log_n, True)
    want = tntt.ntt_batch(torch.from_numpy(x), log_n).numpy()
    for rank, (fwd, _, rt, back) in enumerate(port[f"2x2-n{log_n}"]):
        assert np.array_equal(fwd, want), rank
        assert np.array_equal(rt, x) and np.array_equal(back, x), rank


def test_split_refuses_a_size_too_small_for_the_ranks():
    from halo2_rsa_tpu_torch.parallel import sharded_ntt

    assert sharded_ntt._split(4, 4) == (2, 2)
    with pytest.raises(AssertionError, match="too small"):
        sharded_ntt._split(3, 4)

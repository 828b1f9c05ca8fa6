"""The PyTorch port's sharded constraint checkers (``ShardedChecker``,
``WireShardedChecker``) on gloo ranks on the CPU, against the JAX
package's ``ShardedChecker`` and the port's single-device checker.

The circuits are ``__graft_entry__.py``'s section 1: 128-bit
``pow_mod_fixed_exp`` (e = 65537) instances, four of one trace shape, built
by both packages' carried gadgets. Batches: all valid; one instance with a
flipped witness bit (gate violations); one with a lookup cell out of range.
On (data, rows) meshes (2, 1), (1, 2) and (2, 2), both port checkers must
return on every rank an ``np.ndarray`` of shape (B,) equal to JAX's
``ShardedChecker`` on the same mesh shape and to ``checker.check`` per
instance.
"""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from halo2_rsa_tpu.bigint import BigIntChip as JBigIntChip
from halo2_rsa_tpu.circuit import Builder as JBuilder
from halo2_rsa_tpu.circuit import checker as jchecker
from halo2_rsa_tpu.fields import BN254_FR as J_BN254_FR
from halo2_rsa_tpu.parallel import ShardedChecker as JShardedChecker
from halo2_rsa_tpu_torch.bigint import BigIntChip
from halo2_rsa_tpu_torch.circuit import Builder, checker
from halo2_rsa_tpu_torch.fields import BN254_FR
from halo2_rsa_tpu_torch.fields import vecfield as tvf
from halo2_rsa_tpu_torch.parallel import launch, ranks

torch.set_num_threads(1)
BITS = 128
SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
KINDS = ("sharded", "wire")
BATCHES = ("valid", "gate", "lookup")


def _build(seed, builder_cls, chip_cls, field):
    """__graft_entry__.py's dryrun circuit: x^65537 mod n, 128 bits."""
    r = random.Random(seed)
    n_v = 0
    while n_v.bit_length() != BITS:
        n_v = r.getrandbits(BITS)
    x_v = r.getrandbits(BITS) % n_v
    b = builder_cls(field)
    chip = chip_cls(b, 64, BITS)
    x = chip.assign_integer(x_v)
    n = chip.assign_integer(n_v)
    chip.assert_in_field(x, n)
    powed = chip.pow_mod_fixed_exp(x, 65537, n)
    chip.assert_equal_fresh(powed, chip.assign_integer(pow(x_v, 65537, n_v)))
    return b


@pytest.fixture(scope="module")
def circuits():
    """(port compiled, JAX compiled, {batch name: (4, W, 8) witnesses})."""
    tbs = [_build(s, Builder, BigIntChip, BN254_FR) for s in range(4)]
    jbs = [_build(s, JBuilder, JBigIntChip, J_BN254_FR) for s in range(4)]
    assert [b.values for b in tbs] == [b.values for b in jbs]
    compiled = checker.compile_circuit(tbs[0])
    w = np.stack([checker.witness_limbs(b) for b in tbs])
    gate = w.copy()
    gate[2, 50, 0] ^= 1
    lookup = w.copy().view(np.uint32)
    bits0, idx = compiled.lookup_groups[0]
    lookup[3, int(idx[0]), bits0 // 32] += np.uint32(1 << (bits0 % 32))
    batches = dict(valid=w, gate=gate, lookup=lookup.view(np.int32))
    return compiled, jchecker.compile_circuit(jbs[0]), batches


@pytest.fixture(scope="module")
def port(circuits):
    compiled, _, batches = circuits
    out = {}
    for world, shapes in SHAPES.items():
        res = launch.spawn(ranks.checker_cases, world, "gloo", device="cpu", timeout=300,
                           args=(compiled, shapes, [batches[b] for b in BATCHES]), threads=1)
        for key in res[0]:
            out[key] = [r[key] for r in res]
    return out


CASES = [(shape, kind, batch) for shapes in SHAPES.values() for shape in shapes
         for kind in KINDS for batch in BATCHES]


def _jax_counts(jcompiled, shape, w):
    devs = np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    sc = JShardedChecker(jcompiled, Mesh(devs, ("data", "rows")))
    return np.asarray(sc.check(sc.shard_witness(tvf.limbs_to_ref(w))))


@pytest.mark.parametrize("shape,kind,batch", CASES,
                         ids=[f"{s[0]}x{s[1]}-{k}-{b}" for s, k, b in CASES])
def test_counts_equal_jax_and_single_device(circuits, port, shape, kind, batch):
    compiled, jcompiled, batches = circuits
    w = batches[batch]
    want = _jax_counts(jcompiled, shape, w)
    local = [checker.check(compiled, w[i], device="cpu") for i in range(len(w))]
    assert want.tolist() == [c["gate_violations"] + c["lookup_violations"] for c in local]
    for rank, per_batch in enumerate(port[shape, kind]):
        got = per_batch[BATCHES.index(batch)]
        assert isinstance(got, np.ndarray) and got.shape == (4,), rank
        assert np.array_equal(got, want), (rank, got, want)
    if batch == "valid":
        assert not want.any()
    else:
        assert want.tolist()[:2] == [0, 0] and want[2 if batch == "gate" else 3] > 0


def test_batch_must_split_over_the_data_axis(circuits):
    compiled, _, batches = circuits
    with pytest.raises(RuntimeError, match="does not split over 2 data ranks"):
        launch.spawn(ranks.checker_cases, 2, "gloo", device="cpu", timeout=120,
                     args=(compiled, [(2, 1)], [batches["valid"][:3]]), threads=1)

"""The multi-rank transport of the PyTorch port (``parallel.comm`` and
``parallel.launch``) on gloo ranks on the CPU.

Every collective — all-gather, the tiled all-to-all, the all-to-all with a
row count per peer, the all-reduce sum — over the one axis of a 1-D mesh
and both axes of a (2, world/2) mesh, on 2 and 4 ranks, must equal the same
operation done here on every rank's inputs (``ranks.collective_inputs``);
the counters must count each call and the bytes received from the other
ranks. ``spawn`` must raise within its deadline when a rank raises or
hangs, and refuse what it cannot run before starting anything.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from halo2_rsa_tpu_torch.parallel import comm, launch, ranks

torch.set_num_threads(1)
SEED = 11
WORLDS = (2, 4)
MESHES = {"1d": ((0,), ("rows",)), "2d": ((2, 0), ("data", "rows"))}
KINDS = ("gather", "a2a", "a2av", "reduce")


def _shape(name, world):
    shape, names = MESHES[name]
    return tuple(s or world // (2 if name == "2d" else 1) for s in shape), names


@pytest.fixture(scope="module")
def runs():
    return {world: launch.spawn(ranks.collectives, world, "gloo", device="cpu", timeout=120,
                                args=(SEED,), threads=1) for world in WORLDS}


def _expected(world, name, axis, rank):
    shape, names = _shape(name, world)
    ax = names.index(axis)
    coords = np.unravel_index(rank, shape)
    d, pos = shape[ax], int(coords[ax])
    xs = [ranks.collective_inputs(SEED, list(MESHES).index(name), d, p) for p in range(d)]
    a2av = []
    for x in xs:
        start = sum(x["send"][:pos])
        a2av.append(x["a2av"][start : start + x["send"][pos]])
    return dict(gather=np.stack([x["gather"] for x in xs]),
                a2a=np.stack([x["a2a"][pos] for x in xs]),
                a2av=np.concatenate(a2av),
                reduce=sum(x["reduce"] for x in xs))


CASES = [(world, name, axis, kind) for world in WORLDS for name in MESHES
         for axis in MESHES[name][1] for kind in KINDS]


@pytest.mark.parametrize("world,name,axis,kind", CASES)
def test_collective_equals_local_op(runs, world, name, axis, kind):
    for rank, out in enumerate(runs[world]):
        got = out[name, axis][kind]
        want = _expected(world, name, axis, rank)[kind]
        assert got.dtype == want.dtype and np.array_equal(got, want), (rank, got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_counters_count_calls_and_bytes_received(runs, world):
    """Per rank: one call of each kind per (mesh, axis); bytes are what the
    other ranks of the group sent this rank; nothing staged on the CPU."""
    for rank, out in enumerate(runs[world]):
        want = {kind: {"calls": 0, "bytes": 0, "staged_bytes": 0} for kind in comm.KINDS}
        for name in MESHES:
            shape, names = _shape(name, world)
            for axis in names:
                d = shape[names.index(axis)]
                e = _expected(world, name, axis, rank)
                want["all_gather"]["bytes"] += e["gather"].nbytes - e["gather"][0].nbytes
                want["all_to_all"]["bytes"] += e["a2a"].nbytes - e["a2a"][0].nbytes
                pos = int(np.unravel_index(rank, shape)[names.index(axis)])
                own = ranks.collective_inputs(SEED, list(MESHES).index(name), d, pos)
                want["all_to_all"]["bytes"] += (e["a2av"].shape[0] - own["send"][pos]) * 32
                want["all_reduce"]["bytes"] += (d - 1) * e["reduce"].itemsize * 5
                want["all_gather"]["calls"] += 1
                want["all_to_all"]["calls"] += 2
                want["all_reduce"]["calls"] += 1
        assert out["counts"] == want


def test_rank_that_raises_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        launch.spawn(ranks.stall, 2, "gloo", device="cpu", timeout=90, args=(1, "raise"), threads=1)
    assert time.monotonic() - t0 < 90


def test_rank_that_hangs_fails_within_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 12"):
        launch.spawn(ranks.stall, 2, "gloo", device="cpu", timeout=12, args=(0, "hang"), threads=1)
    assert time.monotonic() - t0 < 12 + 10


@pytest.mark.parametrize("backend,device,world", [
    ("mpi", "cpu", 2),  # not a backend the port runs
    ("nccl", "cpu", 1),  # NCCL exchanges CUDA tensors only
    ("nccl", "cuda:0", 1),  # more ranks than GPUs (none here): never two on one GPU
])
def test_spawn_refuses_before_starting(backend, device, world):
    with pytest.raises(ValueError):
        launch.spawn(ranks.stall, world, backend, device=device, timeout=5, args=(-1, "raise"))


def test_default_mesh_in_one_rank(tmp_path):
    """make_mesh's default shape and groups in a world of one (the gloo
    group of this process, torn down after)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        mesh = comm.make_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "rows": 1} and mesh.coords == {"data": 0, "rows": 0}
        assert mesh.backend == "gloo" and mesh.device == torch.device("cpu")
        x = torch.arange(16, dtype=torch.int32).reshape(2, 8)
        assert torch.equal(comm.all_gather(mesh, "rows", x), x[None])
        assert torch.equal(comm.all_to_all(mesh, "data", x[None]), x[None])
        assert torch.equal(comm.all_reduce_sum(mesh, "rows", x), x)
        with pytest.raises(ValueError):
            comm.make_mesh((2,), ("rows",), device="cpu")
    finally:
        dist.destroy_process_group()

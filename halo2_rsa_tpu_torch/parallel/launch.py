"""Start the ranks of one multi-rank run, and wait for them with a deadline.

:func:`spawn` runs ``fn(rank, world, device, *args)`` in ``world`` fresh
processes (``torch.multiprocessing``'s ``spawn`` start method), each with
the default process group initialised through a ``file://`` store in a
fresh temporary directory (no TCP port is fixed, so concurrent runs cannot
collide). ``fn`` must be importable by name: the rank bodies live in
:mod:`.ranks`, so a rank imports the port and nothing else. A rank that
raises, dies, or outlives the deadline makes :func:`spawn` kill every rank
and raise; otherwise it returns each rank's result, in rank order.

Devices: ``device="cuda"`` gives rank r ``cuda:(r % device_count)``;
``device="cpu"`` runs every rank on the host. The backend is an argument:
``"nccl"`` needs one GPU per rank (two ranks on one GPU raise before
anything starts), ``"gloo"`` runs anywhere and stages CUDA tensors through
host memory (:mod:`.comm`).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from . import comm

BACKENDS = ("nccl", "gloo")


def _rank_main(fn, rank, world, backend, device, store, timeout, args, threads, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = comm.rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="file://" + store, world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, None, fn(rank, world, str(dev), *args)))
    except BaseException:  # reported to the parent, which raises it
        # before the group goes down: the peers' errors follow from this one
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _failures(world: int, rank: int, err: str, results) -> str:
    """The first failure and every other rank's reported within a second
    after it (a failing rank makes its peers fail too; the root cause is
    among the first)."""
    msgs = [f"rank {rank} of {world} failed:\n{err}"]
    end = time.monotonic() + 1.0
    while time.monotonic() < end:
        try:
            r, e, _ = results.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if e is not None:
            msgs.append(f"rank {r} of {world} failed:\n{e}")
    return "\n".join(msgs)


def spawn(fn, world: int, backend: str, device="cuda", timeout: float = 600.0, args=(),
          threads: int | None = None) -> list:
    """``[fn(r, world, device_r, *args) for r in range(world)]``, each in a
    rank of its own; raises if any rank fails or the whole takes more than
    ``timeout`` seconds (also each collective's timeout). ``threads``: torch
    intra-op threads per rank (None leaves torch's default)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if str(device) == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("NCCL runs ranks on CUDA devices")
        if world > torch.cuda.device_count():
            raise ValueError(f"NCCL needs one GPU per rank: {world} ranks, "
                             f"{torch.cuda.device_count()} GPUs (use gloo to share a GPU)")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="h2r_ranks_")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, backend, device, os.path.join(tmp, "store"), timeout, tuple(args),
            threads, results))
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    got: dict = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in range(world) if r not in got]
                raise TimeoutError(f"ranks {missing} of {world} did not finish within {timeout} s")
            try:
                rank, err, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks exited without a result (rank, exit code): {dead}")
                continue
            if err is not None:
                raise RuntimeError(_failures(world, rank, err, results))
            got[rank] = out
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)

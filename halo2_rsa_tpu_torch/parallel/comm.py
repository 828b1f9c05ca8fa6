"""The mesh and its collectives over ``torch.distributed``.

The JAX package has no counterpart: there one process drives every device
and ``shard_map``/GSPMD move the data. Here every rank is a process of its
own (:mod:`.launch` starts them), and every move between ranks is one of
the calls below, made by every rank of the group at the same point of its
program:

* :func:`all_gather` — each rank's tensor, stacked in axis order;
* :func:`all_to_all` — the tiled exchange: slice ``j`` of the leading axis
  goes to the ``j``-th rank, and slice ``s`` of the result came from the
  ``s``-th;
* :func:`all_to_all_v` — the same with a row count per peer;
* :func:`all_reduce_sum` — the elementwise sum over the group.

The backend is the one the process group was started with, ``"nccl"`` or
``"gloo"``; nothing here picks it. Under NCCL a CUDA tensor goes to the
collective as it is, and a host tensor raises. Gloo exchanges host tensors,
so a CUDA tensor is copied to the host, exchanged and copied back, and
those copies are counted apart (``staged_bytes``). :data:`COLLECTIVES`
counts, per kind, the calls, the bytes this rank receives from the other
ranks of the group, and the staged bytes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

KINDS = ("all_gather", "all_to_all", "all_reduce")
COLLECTIVES = {kind: {"calls": 0, "bytes": 0, "staged_bytes": 0} for kind in KINDS}


def reset_counts() -> None:
    for counts in COLLECTIVES.values():
        for key in counts:
            counts[key] = 0


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``"cuda"`` is ``cuda:(rank % device_count)``;
    anything else is taken as it is. A device that cannot run raises."""
    if str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = torch.device(device)
    torch.empty(0, device=dev)
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """A named grid over the ranks of the default process group, row-major
    (the last axis varies fastest, as ``np.reshape`` lays out JAX's
    devices). ``groups[axis]`` is the process group of this rank's slice
    along ``axis``: the ranks whose other coordinates equal this rank's, in
    axis order."""

    shape: dict  # axis name -> size, in axis order
    coords: dict  # axis name -> this rank's index
    groups: dict  # axis name -> ProcessGroup
    backend: str
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def make_mesh(shape=None, axis_names=("data", "rows"), device="cuda") -> Mesh:
    """A mesh over all ranks; by default (data, rows) with data = 2 when
    the world size is even and above 1. Every rank must call it, in the same
    order as every other ``make_mesh``: it creates one process group per
    slice of each axis (``dist.new_group`` is collective)."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    if shape is None:
        d = 2 if world % 2 == 0 and world > 1 else 1
        shape = (d, world // d)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh {shape} over axes {axis_names} does not hold {world} ranks")
    dev = rank_device(device, rank)
    grid = np.arange(world).reshape(shape)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, shape))))
    groups = {}
    for ax, name in enumerate(axis_names):
        for ranks in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]).tolist():
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    return Mesh(dict(zip(axis_names, shape)), coords, groups, dist.get_backend(), dev)


def _outbound(mesh: Mesh, x: torch.Tensor) -> tuple:
    """(the tensor handed to the backend, bytes staged through the host)."""
    x = x.contiguous()
    if mesh.backend == "gloo" and x.is_cuda:
        return x.cpu(), x.nbytes
    if mesh.backend == "nccl" and not x.is_cuda:
        raise ValueError("NCCL exchanges CUDA tensors: this one is on the host")
    return x, 0


def _inbound(out: torch.Tensor, device, staged: int) -> tuple:
    if staged:
        return out.to(device), staged + out.nbytes
    return out, 0


def _count(kind: str, nbytes: int, staged: int) -> None:
    c = COLLECTIVES[kind]
    c["calls"] += 1
    c["bytes"] += int(nbytes)
    c["staged_bytes"] += int(staged)


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """(D, *x.shape): every rank's ``x`` along ``axis``, in axis order."""
    d = mesh.shape[axis]
    xt, staged = _outbound(mesh, x)
    out = torch.empty((d,) + tuple(xt.shape), dtype=xt.dtype, device=xt.device)
    dist.all_gather(list(out.unbind(0)), xt, group=mesh.groups[axis])
    out, staged = _inbound(out, x.device, staged)
    _count("all_gather", (d - 1) * x.nbytes, staged)
    return out


def all_to_all(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """x (D, ...) -> (D, ...): slice j goes to the j-th rank along
    ``axis``; slice s of the result is the s-th rank's slice for this rank."""
    d = mesh.shape[axis]
    if x.shape[0] != d:
        raise ValueError(f"all_to_all over {d} ranks needs a leading axis of {d}: {tuple(x.shape)}")
    xt, staged = _outbound(mesh, x)
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=mesh.groups[axis])
    out, staged = _inbound(out, x.device, staged)
    _count("all_to_all", x.nbytes - x.nbytes // d, staged)
    return out


def all_to_all_v(mesh: Mesh, axis: str, x: torch.Tensor, send: list, recv: list) -> torch.Tensor:
    """Rows of x (sum(send), ...) -> (sum(recv), ...): the next ``send[j]``
    rows go to the j-th rank along ``axis``, and the result holds the
    ``recv[s]`` rows of the s-th rank, in axis order."""
    if x.shape[0] != sum(send):
        raise ValueError(f"all_to_all_v sends {sum(send)} rows, the tensor has {x.shape[0]}")
    xt, staged = _outbound(mesh, x)
    out = torch.empty((sum(recv),) + tuple(xt.shape[1:]), dtype=xt.dtype, device=xt.device)
    dist.all_to_all_single(out, xt, list(recv), list(send), group=mesh.groups[axis])
    out, staged = _inbound(out, x.device, staged)
    row = out[0].nbytes if out.shape[0] else 0
    _count("all_to_all", (sum(recv) - recv[mesh.coords[axis]]) * row, staged)
    return out


def all_reduce_sum(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` along ``axis``."""
    d = mesh.shape[axis]
    xt, staged = _outbound(mesh, x)
    if xt is x:  # the collective sums in place; the caller's tensor stays
        xt = x.clone()
    dist.all_reduce(xt, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    out, staged = _inbound(xt, x.device, staged)
    _count("all_reduce", (d - 1) * x.nbytes, staged)
    return out

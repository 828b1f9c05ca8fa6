"""Multi-rank proving and checking over ``torch.distributed``.

Counterpart of ``halo2_rsa_tpu/parallel``. The JAX package is one process
that drives every device through ``shard_map``/GSPMD; here the execution
model is SPMD over ranks:

* one process per rank (:func:`spawn`, with a deadline); every rank runs
  the same program — the same ``plonk.prove`` with the same ``rng`` and the
  same proving key — on its own device (``cuda:(rank % device_count)``, or
  the CPU when the caller asks);
* a :class:`~.comm.Mesh` (:func:`make_mesh`) names the ranks' axes and
  holds one process group per axis slice;
* every method of :class:`MeshKernels` and every sharded function takes
  whole tensors, the same on every rank, and returns the whole result on
  every rank; inside, each rank does 1/D of the work and data moves only
  through the explicit collectives of :mod:`.comm` (all-gather,
  all-to-all, all-reduce), counted in ``comm.COLLECTIVES``;
* the backend is the caller's choice, never probed: NCCL with one GPU per
  rank, or gloo, which stages CUDA tensors through host memory (and so
  lets several ranks share one GPU).

Proof bytes equal the single-device proof's on every rank. No kernel lives
here: each rank runs K1–K4 through the single-device modules.
"""

from .comm import COLLECTIVES, Mesh, make_mesh
from .launch import spawn
from .mesh_prove import MeshKernels
from .sharded_checker import ShardedChecker, WireShardedChecker
from .sharded_msm import make_sharded_msm
from .sharded_ntt import intt_sharded, ntt_sharded

__all__ = [
    "COLLECTIVES", "Mesh", "MeshKernels", "ShardedChecker", "WireShardedChecker",
    "intt_sharded", "make_mesh", "make_sharded_msm", "ntt_sharded", "spawn",
]

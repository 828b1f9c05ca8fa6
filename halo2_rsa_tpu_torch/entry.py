"""Entry points of the port (counterpart of ``__graft_entry__.py``).

* :func:`entry` — a single-device forward step on the flagship workload:
  the vectorized constraint check (MockProver analog) of a full RSA-1024
  PKCS#1 v1.5 + SHA-256 (64 B message) verification circuit; ``fn(*args)``
  returns the number of violated constraints (0).
* :func:`dryrun_multichip` — the JAX package's five distributed
  capability sections on ``n`` ranks (:mod:`.parallel`): (1) sharded batched
  constraint check, (2) wire-routed check, (3) four-step NTT, (4) sharded
  MSM — a small exact case and a batched one across the scaled segment
  seam — and (5) the sharded kernels inside ``plonk.prove``, byte-identical
  to the single-device proof, then (2b) the wire-routed check of the
  flagship circuit with a one-block message. Rank 0 prints each section's
  wall time to stderr; a section whose cost estimate does not fit in the
  remaining budget (``DRYRUN_BUDGET_S``) is skipped with a printed notice
  and listed in the returned report.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import random

import torch

from .circuit import checker
from .fields import vecfield
from .pipelines import Pkcs1v15Circuit, sign_fixture


def build_flagship(bits: int = 1024, msg_len: int = 64, seed: int = 7) -> tuple:
    """The flagship circuit over a ``msg_len``-byte message and a key, both
    from ``random.Random(seed)``: (compiled circuit, (W, 8) witness limbs)."""
    rng = random.Random(seed)
    msg = bytes(rng.randrange(256) for _ in range(msg_len))
    n, sig = sign_fixture(bits, msg, rng=rng)
    circ = Pkcs1v15Circuit.build(bits, n, sig, msg=msg)
    return circ.compile(), checker.witness_limbs(circ.builder)


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(w_std)`` is the flagship's
    violation count over a (W, 8) standard-form witness on ``device``."""
    dev = torch.device(device)
    torch.empty(0, device=dev)  # a device that cannot run raises before the build
    compiled, w = build_flagship()
    fc = compiled.fc
    idx = lambda a: torch.from_numpy(a.astype("int64")).to(dev)  # noqa: E731
    gate_idx = idx(compiled.gate_idx)
    coef = torch.from_numpy(compiled.coef_table).to(dev)[idx(compiled.gate_coef_id)]
    lookup_groups = [(bits, idx(cells)) for bits, cells in compiled.lookup_groups]

    def forward(w_std):
        ok = checker.eval_gates(fc, gate_idx, coef, vecfield.to_mont(fc, w_std))
        viol = (~ok).sum()
        for bits, cells in lookup_groups:
            viol = viol + (~checker.eval_lookup(w_std[cells], bits)).sum()
        return viol

    return forward, (torch.from_numpy(w).to(dev),)


# the dry run's time budget: a section whose cold-cost estimate does not fit
# in what is left is skipped with a printed notice
DRYRUN_BUDGET_S = 520.0


def dryrun_multichip(n_devices: int, backend: str, device="cuda") -> dict:
    """The five sections on ``n_devices`` ranks over ``backend`` ("nccl":
    one GPU per rank; "gloo": ranks may share a GPU, collectives staged
    through host memory). Returns rank 0's report: {"sections": {name:
    seconds}, "skipped": [names]}; every rank must have skipped the same
    sections. Raises if any rank fails or the run outlives the budget by
    more than 180 s."""
    from .parallel import launch, ranks

    reports = launch.spawn(ranks.dryrun, n_devices, backend, device=device,
                           timeout=DRYRUN_BUDGET_S + 180.0, args=(DRYRUN_BUDGET_S,))
    if any(r["skipped"] != reports[0]["skipped"] for r in reports):
        raise AssertionError(f"the ranks skipped different sections: {reports}")
    return reports[0]

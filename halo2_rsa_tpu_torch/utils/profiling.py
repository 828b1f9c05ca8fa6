"""Phase timers.

Counterpart of ``halo2_rsa_tpu/utils/profiling.py``. CUDA launches are
asynchronous, so a host clock alone would time the enqueue: once the
process has initialised CUDA, :class:`Phases` calls
``torch.cuda.synchronize`` at every phase edge, and each phase's time
includes the device work it launched.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


class Phases:
    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.meta: dict[str, dict] = {}

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        if meta:
            self.meta.setdefault(name, {}).update(meta)

    def rate(self, name: str, items: int) -> float:
        """items/s for a phase."""
        t = self.times.get(name, 0.0)
        return items / t if t > 0 else float("inf")

    def report(self) -> dict:
        return {
            "phases_s": {k: round(v, 4) for k, v in self.times.items()},
            "counts": self.counts,
            "meta": self.meta,
        }

    def dump(self) -> str:
        return json.dumps(self.report())


def chain_ms(step, x, iters: int) -> float:
    """Mean ms of ``step`` over a chain ``x = step(x)`` of ``iters`` calls,
    after one call that warms up (and builds); ``x`` is a tensor or a tuple
    of tensors on one device. On the card the chain is timed with CUDA
    events; on the CPU with the host clock."""
    x = step(x)
    lead = x if isinstance(x, torch.Tensor) else x[0]
    if not lead.is_cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            x = step(x)
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(lead.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x = step(x)
    end.record()
    torch.cuda.synchronize(lead.device)
    return start.elapsed_time(end) / iters

"""Spans, counters and phase timers.

Counterpart of ``halo2_rsa_tpu/utils/profiling.py``, grown into the port's
one tracer.

**Spans.** ``with span(name, **counts):`` marks a step of the program (an
NTT, an MSM, a copy to the host, a replay group). Tracing is off by
default: ``span`` then tests one module flag and returns one shared null
context. It reads no clock, records nothing and never syncs.
``with tracing() as trace:`` turns it on for its block. Each span then
records its name, its start and end (``time.perf_counter_ns``), its parent,
its request and its integer counts into ``trace.spans``, and opens
``torch.profiler.record_function("h2r/" + name)``, so that under
``torch.profiler`` every span lands in the same timeline as the kernels and
copies it launched, on the profiler's clock. Spans never sync: a CUDA launch
returns before its work ends, so a span's host end is when the host left the
step, and the end of its device work is read from the profiler's trace (the
last device operation launched inside it).

``with request(i):`` names the request of the spans opened inside it;
elsewhere a span's request is the index of its root span. ``count(**n)``
adds counts to the innermost open span.

**Phases.** :class:`Phases` times the prover's rounds with a device sync at
each edge, so each phase's time includes the device work it launched; each
phase is also a span of the same name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

_TRACE = None  # the Trace being recorded; None while tracing is off
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int | None  # None while the span is open
    parent: int | None  # index of the parent span in Trace.spans
    request: int
    counts: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Trace:
    """The spans recorded by one :func:`tracing` block, in the order they
    opened (a parent before its children)."""

    def __init__(self):
        self.spans: list[Span] = []
        self._open: list[int] = []  # indices of the open spans, innermost last
        self._request = None

    @contextlib.contextmanager
    def _span(self, name: str, counts: dict):
        idx = len(self.spans)
        parent = self._open[-1] if self._open else None
        if self._request is not None:
            req = self._request
        else:
            req = self.spans[parent].request if parent is not None else idx
        rec = Span(name, 0, None, parent, req, dict(counts))
        self.spans.append(rec)
        self._open.append(idx)
        with torch.profiler.record_function("h2r/" + name):
            rec.start_ns = time.perf_counter_ns()
            try:
                yield
            finally:
                rec.end_ns = time.perf_counter_ns()
                self._open.pop()

    def totals(self) -> dict:
        """{name: {"spans": instances, "seconds": host seconds, <count>: sum}}
        over the finished spans."""
        out: dict = {}
        for s in self.spans:
            if s.end_ns is None:
                continue
            t = out.setdefault(s.name, {"spans": 0, "seconds": 0.0})
            t["spans"] += 1
            t["seconds"] += s.seconds
            for k, v in s.counts.items():
                t[k] = t.get(k, 0) + v
        return out


def span(name: str, **counts):
    """A context that marks one step of the program (see the module's
    docstring); the shared null context while tracing is off."""
    if _TRACE is None:
        return _NULL
    return _TRACE._span(name, counts)


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span (nothing while off)."""
    if _TRACE is not None and _TRACE._open:
        c = _TRACE.spans[_TRACE._open[-1]].counts
        for k, v in counts.items():
            c[k] = c.get(k, 0) + v


@contextlib.contextmanager
def request(req: int):
    """Spans opened inside belong to request ``req``."""
    t = _TRACE
    if t is None:
        yield
        return
    prev, t._request = t._request, req
    try:
        yield
    finally:
        t._request = prev


@contextlib.contextmanager
def tracing():
    """Record every span opened in the block; yields the :class:`Trace`."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("tracing is already on")
    _TRACE = Trace()
    try:
        yield _TRACE
    finally:
        _TRACE = None


class Phases:
    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str, **counts):
        """Seconds of the block, synchronised at both edges, into
        ``times[name]``; the block is also a span with ``counts``."""
        self._sync()
        t0 = time.perf_counter()
        with span(name, **counts):
            yield
            self._sync()
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            "phases_s": {k: round(v, 4) for k, v in self.times.items()},
            "counts": self.counts,
        }


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

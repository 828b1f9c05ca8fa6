"""The program's own spans in a traced run, on the profiler's clock.

With the port's tracer on (``halo2_rsa_tpu_torch.utils.profiling``), every
program span is a ``torch.profiler`` range named ``h2r/<span>`` beside the
benchmark's ``bench/<span>`` ranges, in the same timeline as the device
operations. From those events:

* **A span instance's time** runs from its host start to the later of its host
  end and the end of the last device operation launched inside it or its
  children (a device operation is matched to its launch on the host by the
  profiler's correlation id). No sync is needed.
* **Each idle gap** of the device goes to the innermost range, program or
  benchmark, open on the host at the gap's midpoint; a gap under none keeps
  the label ``request, no inner span``.

Events are plain tuples on the profiler's clock, in ns: ranges ``(start, end,
name)`` with the ``h2r/`` or ``bench/`` prefix; launches ``{correlation id:
host time of the launch call}``; device operations ``(start, end, name,
correlation id)``.

:class:`ProgramProfile` is ``trace.Profile`` with the tracer on over the traced
requests (``run_spans.py`` installs it); its per-layer readers are
``metrics/tails_s.py``, ``ntt_s.py``, ``replay_copy_ms.py`` and
``replay_groups_per_batch.py``.
"""

from __future__ import annotations

import bisect
import contextlib

from . import trace

NO_SPAN = "request, no inner span"
ROUNDS = ("witness", "round1_commit", "round2_commit", "round3_quotient", "round4_evals",
          "round5_open")
PREFIXES = ("h2r/", "bench/")


def label(name: str) -> str:
    """A range's span name without its prefix."""
    for p in PREFIXES:
        if name.startswith(p):
            return name[len(p):]
    return name


def nest(ranges) -> list:
    """The parent index of each range; ``ranges`` sorted by (start, -end),
    properly nested (one host thread opens them all)."""
    parents, open_ = [], []
    for s, e, _ in ranges:
        while open_ and ranges[open_[-1]][1] < e:
            open_.pop()
        parents.append(open_[-1] if open_ else None)
        open_.append(len(parents) - 1)
    return parents


def ordered(ranges) -> list:
    return sorted(ranges, key=lambda r: (r[0], -r[1]))


def innermost(ranges, parents, starts, t):
    """Index of the innermost range open at ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0 and ranges[i][1] < t:
        i = parents[i]
    return i if i is not None and i >= 0 else None


def device_ends(ranges, launches, ops) -> list:
    """For each range, the later of its host end and the end of the last
    device operation launched inside it."""
    launched = sorted((launches[c], e) for _, e, _, c in ops if c in launches)
    times = [t for t, _ in launched]
    out = []
    for s, e, _ in ranges:
        i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
        out.append(max([e] + [launched[k][1] for k in range(i, j)]))
    return out


def idle_by_span(gaps, ranges) -> dict:
    """Seconds of the idle gaps ``(start, end)`` by the innermost range open at
    each gap's midpoint (``NO_SPAN`` where none is)."""
    ranges = ordered(ranges)
    parents, starts = nest(ranges), [r[0] for r in ranges]
    out: dict = {}
    for a, b in gaps:
        i = innermost(ranges, parents, starts, (a + b) / 2)
        key = label(ranges[i][2]) if i is not None else NO_SPAN
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    return out


def round_share(gaps, ranges) -> float | None:
    """Of the idle seconds inside a prover round, the share whose innermost
    open range is the round itself (no step inside it open)."""
    ranges = ordered(ranges)
    parents, starts = nest(ranges), [r[0] for r in ranges]
    inside = bare = 0.0
    for a, b in gaps:
        i = innermost(ranges, parents, starts, (a + b) / 2)
        j = i
        while j is not None and label(ranges[j][2]) not in ROUNDS:
            j = parents[j]
        if j is None:
            continue
        inside += b - a
        bare += (b - a) if label(ranges[i][2]) in ROUNDS else 0.0
    return bare / inside if inside else None


def union_s(intervals) -> float:
    return sum(e - s for s, e in trace._union(intervals)) / 1e9


def by_span(ranges, ops, launches) -> dict:
    """Per span name: the device operations launched with it the innermost
    open range, as kernel launches and other operations (copies, fills)."""
    ranges = ordered(ranges)
    parents, starts = nest(ranges), [r[0] for r in ranges]
    out: dict = {}
    for _, _, name, corr in ops:
        t = launches.get(corr)
        if t is None:
            continue
        i = innermost(ranges, parents, starts, t)
        row = out.setdefault(label(ranges[i][2]) if i is not None else NO_SPAN,
                             {"launches": 0, "copies": 0})
        row["launches" if trace.is_kernel(name) else "copies"] += 1
    return out


def events(prof, device: bool) -> tuple:
    """(ranges, launches, device ops) of a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges, launches, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if name.startswith(PREFIXES):
            # the profiler mirrors each range onto the device's timeline as an
            # annotation: a range, never device work
            if e.device_type() != cuda:
                ranges.append((start, end, name))
        elif e.device_type() == cuda:
            if device:
                ops.append((start, end, name, e.correlation_id()))
        elif name.startswith("cu"):  # a CUDA API call (cudaLaunchKernel, cudaMemcpyAsync, ...)
            launches[e.correlation_id()] = start
    return ranges, launches, ops


class ProgramProfile(trace.Profile):
    """``trace.Profile`` with the program's tracer on over the traced requests,
    each request named by its index; its device operations leave out the
    ``h2r/`` annotations, and its idle gaps go to the innermost range."""

    def __init__(self, run):
        super().__init__(run)
        self.trace = None
        self.ranges: list = []
        self.program: dict | None = None
        self._tracing = None
        self._next = 0

    def start(self) -> None:
        from halo2_rsa_tpu_torch.utils import profiling

        super().start()
        self._tracing = profiling.tracing()
        self.trace = self._tracing.__enter__()

    @contextlib.contextmanager
    def request(self):
        from halo2_rsa_tpu_torch.utils import profiling

        with super().request(), profiling.request(self._next):
            yield
        self._next += 1

    def stop(self, requests: int) -> None:
        run = self.run
        run.sync()
        self._tracing.__exit__(None, None, None)
        if self.rec is not None:
            self.rec.active = False
            self.calls = dict(self.rec.calls)
        self.prof.__exit__(None, None, None)
        self.active = False
        self.requests = requests
        ranges, launches, ops = events(self.prof, run.device != "cpu")
        self.prof = None
        reqs = [r for r in ranges if r[2] == "bench/request"]
        self.ranges = ordered(r for r in ranges if r[2] != "bench/request")
        self.gaps = []
        if reqs:
            lo, hi = min(r[0] for r in reqs), max(r[1] for r in reqs)
            self.window_s = (hi - lo) / 1e9
            self.dev = [(max(s, lo), min(e, hi), n) for s, e, n, _ in ops if e > lo and s < hi]
            busy = trace._union((s, e) for s, e, _ in self.dev)
            self.busy_s = sum(e - s for s, e in busy) / 1e9
            self.gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + busy, busy + [[hi, hi]])
                         if b[0] > a[1]]
            self.spans = [(s, e, n[len("bench/"):]) for s, e, n in self.ranges
                          if n.startswith("bench/")]
        for fam, pat in trace.KERNELS.items():
            self.kernel_s[fam] = sum(e - s for s, e, n in self.dev if pat.search(n)) / 1e9
        self.launches = sum(1 for _, _, n in self.dev if trace.is_kernel(n))
        ends = device_ends(self.ranges, launches, ops)
        self.extended = [(s, end, n) for (s, _, n), end in zip(self.ranges, ends)]
        matched = sum(1 for op in ops if op[3] in launches)
        self.program = {
            "idle_s": idle_by_span(self.gaps, self.ranges),
            "round_idle_share": round_share(self.gaps, self.ranges),
            "by_span": by_span(self.ranges, ops, launches),
            "span_s": {n: self.span_s(n) for n in sorted({label(r[2]) for r in self.ranges
                                                          if r[2].startswith("h2r/")})},
            "counts": self.trace.totals(),
            "ops_matched": [matched, len(ops)],
        }

    def span_s(self, *names) -> float | None:
        """Seconds, device-extended, during which an instance of one of the
        program spans ``names`` was open or its device work ran (their
        union); None without an instance."""
        want = {"h2r/" + n for n in names}
        found = [(s, e) for s, e, n in self.extended if n in want]
        return union_s(found) if found else None

    def breakdown(self) -> dict:
        out = super().breakdown()
        out["idle_gaps"] = trace._top(self.program["idle_s"])
        out["program"] = self.program
        return out


def per_request(run, value):
    """``value(profile)`` per traced request, where the run's profile is a
    :class:`ProgramProfile`; None elsewhere."""
    prof = run.profile
    if not isinstance(prof, ProgramProfile) or not prof.requests or prof.program is None:
        return None
    v = value(prof)
    return None if v is None else v / prof.requests

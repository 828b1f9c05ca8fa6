"""The traced requests of a ``--trace 1`` run: ``torch.profiler`` over the
first ``trace_requests`` requests of the window (the traffic mix's number),
reduced to what the per-layer metrics read.

* ``busy_s``: the union of the intervals in which an operation (kernel, copy,
  fill) ran on the card, within the traced window; ``window_s``: from the
  start of the first traced request to the end of the last.
* ``kernel_s[family]``: device seconds of the hand-written kernels (``k1``:
  K1, K1-pow, K1-prefix; ``g1``: K2, K3, K3-scan, K3-splice, K4), beside the
  calls ``harness.recorder`` counted by shape over the same requests.
* ``breakdown``: the device operations that took most time, and the idle
  gaps summed by the benchmark span that was open on the host.
"""

from __future__ import annotations

import contextlib
import re

from .recorder import FAMILY, Recorder

KERNELS = {
    "k1": re.compile(r"\bh2r_mont_(mul|pow|scan_reduce|scan_rows|scan_tiles)_kernel\b"),
    "g1": re.compile(r"\bh2r_g1_(add|scan_mixed|scan_rows|bucket_splice|double)_kernel\b"),
}
_RECORDER = None


def recorder() -> Recorder:
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = Recorder()
    return _RECORDER


def _events(prof) -> tuple:
    """(device ops [(start_ns, end_ns, name)], bench spans [(start, end, name)])."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        if name.startswith("bench/"):
            # the profiler mirrors each span onto the device's timeline as an
            # annotation: a span, never device work
            if e.device_type() != cuda:
                spans.append((start, start + dur, name[len("bench/"):]))
        elif e.device_type() == cuda:
            dev.append((start, start + dur, name))
    return dev, spans


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Profile:
    def __init__(self, run):
        self.run = run
        self.rec = recorder() if run.device != "cpu" else None
        self.prof = None
        self.active = False
        self.requests = 0
        self.busy_s = self.window_s = None
        self.kernel_s: dict = {}
        self.calls: dict = {}
        self.launches = 0
        self.dev: list = []
        self.spans: list = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.run.device != "cpu"
                                          else [])
        self.run.sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.rec is not None:
            self.rec.calls.clear()
            self.rec.active = True
        self.active = True

    @contextlib.contextmanager
    def request(self):
        import torch

        if not self.active:
            yield
            return
        with torch.profiler.record_function("bench/request"):
            yield
            self.run.sync()

    def stop(self, requests: int) -> None:
        self.run.sync()
        if self.rec is not None:
            self.rec.active = False
            self.calls = dict(self.rec.calls)
        self.prof.__exit__(None, None, None)
        self.active = False
        self.requests = requests
        dev, spans = _events(self.prof) if self.run.device != "cpu" else ([], [])
        reqs = [s for s in spans if s[2] == "request"]
        if reqs:
            lo, hi = min(s[0] for s in reqs), max(s[1] for s in reqs)
            self.window_s = (hi - lo) / 1e9
            self.dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
            busy = _union((s, e) for s, e, _ in self.dev)
            self.busy_s = sum(e - s for s, e in busy) / 1e9
            self.gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + busy, busy + [[hi, hi]])
                         if b[0] > a[1]]
            self.spans = [s for s in spans if s[2] != "request"]
        else:
            self.gaps = []
        for fam, pat in KERNELS.items():
            self.kernel_s[fam] = sum(e - s for s, e, n in self.dev if pat.search(n)) / 1e9
        self.launches = sum(1 for _, _, n in self.dev if is_kernel(n))
        self.prof = None

    def family_calls(self, family: str) -> dict:
        return {k: v for k, v in self.calls.items() if FAMILY[k[0]] == family}

    def breakdown(self) -> dict:
        by_op: dict = {}
        for s, e, n in self.dev:
            key = n.split("(")[0].replace("void ", "")[:120]
            by_op[key] = by_op.get(key, 0) + (e - s) / 1e9
        by_span: dict = {}
        for a, b in self.gaps:
            mid = (a + b) / 2
            inner = [s for s in self.spans if s[0] <= mid <= s[1]]
            label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                     else "request, no inner span")
            by_span[label] = by_span.get(label, 0) + (b - a) / 1e9
        return {"device_ops": _top(by_op), "idle_gaps": _top(by_span)}


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

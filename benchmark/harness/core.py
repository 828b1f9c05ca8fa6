"""One run of one cell: set-up, a closed loop of one client for the window,
the outputs checked against the plain reference, one result line.

Nothing here names a cell, a configuration, a traffic mix or a metric. A cell
of ``BENCHMARK.json`` names its configuration (``configs/<name>.json``) and
its traffic mix (``traffic/<name>.json``); the mix names the call it drives
(``calls/<call>.py``); every metric is a reader ``metrics/<name>.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import random
import sys
import time

from . import guard

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: str = HERE):
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(base, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` that ``cell`` reports: those listing it, and
    those with no ``workloads`` key."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """What a run knows: its cell, configuration and mix, the window's
    requests, the spans the call recorded, and (traced) what the profiler
    saw. Calls keep their own state in ``state``."""

    def __init__(self, root, cell, cfg, traffic, seed, seconds, trace, fault=None,
                 device="cuda"):
        self.root, self.cell, self.cfg, self.traffic = root, cell, cfg, traffic
        self.seed, self.seconds, self.trace, self.fault = seed, seconds, trace, fault
        self.device = device
        self.state: dict = {}
        self.spans: dict = {}
        self.requests: list = []  # (start, end, units) on the host clock
        self.answers: list = []
        self.elapsed = None
        self.setup_s = None
        self.apart_s = 0.0  # set-up seconds of the reference's own work
        self.profile = None  # harness.trace.Profile of the traced requests

    def rng(self, *salt) -> random.Random:
        """A random.Random drawn from the seed and ``salt``."""
        return random.Random(":".join(str(x) for x in (self.seed,) + salt))

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def apart(self):
        """Set-up work of the reference (the answers it expects), timed apart
        and left out of ``setup_s``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.apart_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def span(self, name: str):
        """Seconds of the block into ``spans[name]``. Traced, the device is
        synchronised at both edges, so the span holds the work it launched,
        and the block is named in the profiler's trace."""
        if not self.trace:
            t0 = time.perf_counter()
            yield
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)
            return
        import torch

        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench/" + name):
            yield
            self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault in the timed path's answers (a control; never in a "
                         "measured run)")
    return ap.parse_args(argv)


def window(run: Run, call) -> None:
    """The closed loop: one client sends the next request when the last one
    returns. The window closes at the end of the first request that ends
    after ``seconds``; ``elapsed`` runs to that end."""
    from . import trace

    traced = int(run.traffic.get("trace_requests", 1)) if run.trace else 0
    prof = trace.Profile(run) if traced else None
    t_open = time.perf_counter()
    i = 0
    while True:
        if prof is not None and i == 0:
            prof.start()
        t0 = time.perf_counter()
        with prof.request() if prof is not None else contextlib.nullcontext():
            ans = call.request(run, i)
        t1 = time.perf_counter()
        if prof is not None and i + 1 == traced:
            prof.stop(requests=traced)
        run.requests.append((t0, t1, call.units(run, ans)))
        run.answers.append(ans)
        i += 1
        if t1 - t_open >= run.seconds and (prof is None or not prof.active):
            break
    run.elapsed = run.requests[-1][1] - t_open
    run.profile = prof


def execute(run: Run, t_start: float) -> dict:
    """Set-up, window and judgement of one run; the result's fields."""
    call = load_module("calls", run.traffic["call"], run.root)
    call.prepare(run)
    run.sync()
    # What set-up left is frozen out of the collector's reach, so a full
    # collection in the window walks only what the window allocates.
    gc.collect()
    gc.freeze()
    run.setup_s = time.perf_counter() - t_start - run.apart_s
    log(f"set-up {run.setup_s:.3f} s (the reference's {run.apart_s:.3f} s apart); "
        f"window of {run.seconds} s opens")
    window(run, call)
    write_latencies(run)
    log(f"window closed: {len(run.requests)} requests in {run.elapsed:.3f} s")
    peak = None
    if run.device != "cpu":
        import torch

        peak = int(torch.cuda.max_memory_allocated())
    call.release(run)
    t0 = time.perf_counter()
    compared = call.judge(run)
    log(f"reference judged the answers in {time.perf_counter() - t0:.3f} s")
    return dict(peak=peak, compared=compared, failed=call.failed(run))


def write_latencies(run: Run) -> None:
    """Each request's start and end, in seconds from the first start, to
    ``build/bench_runs/<cell>.<seed>.<trace>.json`` in the checkout."""
    out = os.path.join(os.path.dirname(run.root), "build", "bench_runs")
    os.makedirs(out, exist_ok=True)
    t = run.requests[0][0]
    path = os.path.join(out, f"{run.cell['name']}.{run.seed}.{int(run.trace)}.json")
    with open(path, "w") as f:
        json.dump([[t0 - t, t1 - t] for t0, t1, _ in run.requests], f)


def metric_values(run: Run, specs: list) -> dict:
    out = {}
    for spec in specs:
        value = load_module("metrics", spec["name"], run.root).read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def main(argv, t_start: float, root: str = HERE, device: str = "cuda") -> int:
    """Run the cell; 0 and one result line on stdout, else non-zero and none.
    ``device="cpu"`` skips the look for a card (tests only)."""
    args = parse(argv)
    checkout = os.path.dirname(root)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(checkout, "build", "bench_cache", sub)
    bench = load_json(os.path.join(checkout, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload named {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(checkout, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "traffic", cell["traffic"] + ".json"))

    import torch

    torch.set_num_threads(1)
    if device != "cpu":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}")
            return 3
        torch.cuda.reset_peak_memory_stats()
    if checkout not in sys.path:
        sys.path.insert(0, checkout)

    run = Run(root, cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), args.fault,
              device)
    res = execute(run, t_start)

    section = "per_layer" if args.trace else "end_to_end"
    metrics = metric_values(run, cell_metrics(bench, args.workload, section))
    bad = guard.forbidden_modules()
    if bad:
        log(f"modules of the JAX side are loaded: {bad}")
        return 4
    leaks = guard.reference_imports(os.path.join(root, "refimpl"))
    if leaks:
        log(f"the reference imports the program or the JAX side: {leaks}")
        return 4

    correct = all(c["value"] <= c["limit"] for c in res["compared"].values())
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": res["peak"]}
    out = {"correct": correct, "attempted": len(run.requests), "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if args.trace and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
        out["breakdown"] = run.profile.breakdown()
    out["compared"] = res["compared"]
    for name, c in res["compared"].items():
        log(f"compared {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0

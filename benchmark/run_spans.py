#!/usr/bin/env python3
"""Run one cell like ``run.py``, with the program's own tracer on.

    python3 benchmark/run_spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        [--program-tracing 0|1]

``--trace 1``: the traced requests run under ``profiling.tracing()`` beside
``torch.profiler`` (``harness.spans.ProgramProfile``). The result line then
holds the per-layer metrics of ``BENCHMARK.json`` and ``METRICS`` below, the
idle gaps by the innermost program or benchmark span, and under
``breakdown.program`` the idle seconds and the device operations launched by
span, each span's device-extended seconds, the program's span totals (bytes
copied among their counts) and the share of the rounds' idle time that no
step inside a round holds.

``--trace 0 --program-tracing 1``: the whole window runs with the tracer on
(no profiler), for the tracer's cost on the end-to-end metrics.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import core, spans, trace  # noqa: E402

# Per-layer metrics read from the program's spans, in BENCHMARK.json's form.
METRICS = [
    {"name": "tails_s", "unit": "s", "better": "lower", "source": "program_span",
     "layer": "commitments", "moves": "prove_s"},
    {"name": "ntt_s", "unit": "s", "better": "lower", "source": "program_span",
     "layer": "NTT", "moves": "prove_s"},
    {"name": "replay_copy_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "witness replay", "moves": "witnesses_per_s"},
    {"name": "replay_groups_per_batch", "unit": "groups", "better": "lower",
     "source": "program_span", "layer": "witness replay", "moves": "witnesses_per_s"},
]


def main(argv, root: str = HERE, device: str = "cuda") -> int:
    program = "0"
    if "--program-tracing" in argv:
        i = argv.index("--program-tracing")
        program = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if program == "1" and core.parse(argv).trace:
        core.log("--program-tracing 1 goes with --trace 0: a traced run has the tracer on")
        return 2
    saved = trace.Profile, core.cell_metrics, core.window
    cell_metrics, window = core.cell_metrics, core.window

    def with_program(bench, cell, section):
        return cell_metrics(bench, cell, section) + (METRICS if section == "per_layer" else [])

    def traced_window(run, call):
        from halo2_rsa_tpu_torch.utils import profiling

        with profiling.tracing() as t:
            window(run, call)
        core.log(f"program tracing on over the window: {len(t.spans)} spans")

    trace.Profile = spans.ProgramProfile
    core.cell_metrics = with_program
    if program == "1":
        core.window = traced_window
    try:
        return core.main(argv, T_START, root=root, device=device)
    finally:
        trace.Profile, core.cell_metrics, core.window = saved


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

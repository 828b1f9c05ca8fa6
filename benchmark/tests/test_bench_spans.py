"""Program spans on the profiler's clock (``harness/spans.py``): synthetic
event lists, then traced CPU runs of the tiny cells through ``run_spans.py``
with the program's tracer on."""

from __future__ import annotations

import os
import sys

import pytest
from conftest import BENCH
from test_bench_runs import small_prover  # noqa: F401  (a fixture)

from harness import spans


def op(start, end, corr, name="kern"):
    return (start, end, name, corr)


def test_a_span_ends_with_the_device_work_launched_inside_it():
    ranges = [(0, 100, "bench/round1_commit"), (10, 40, "h2r/ntt"), (50, 60, "h2r/msm")]
    launches = {1: 15, 2: 30, 3: 55, 4: 70}
    ops = [op(20, 35, 1), op(35, 180, 2), op(180, 200, 3), op(200, 210, 4)]
    # ntt launched 1 and 2: its host end 40, its last op's end 180; msm's op
    # 3 ends at 200; the round holds every launch, the last (4) ends at 210
    assert spans.device_ends(ranges, launches, ops) == [210, 180, 200]
    # an op whose launch was not seen extends nothing
    assert spans.device_ends([(10, 40, "h2r/ntt")], {}, ops) == [40]


def test_an_idle_gap_goes_to_the_innermost_open_span():
    ranges = [(0, 1000, "bench/round1_commit"), (0, 1000, "h2r/round1_commit"),
              (100, 400, "h2r/msm"), (150, 200, "h2r/msm.combine"),
              (500, 600, "h2r/commit.tails"), (1200, 1300, "bench/synth")]
    gaps = [(160, 180), (300, 320), (520, 560), (700, 740), (1100, 1150), (1210, 1220)]
    idle = spans.idle_by_span(gaps, ranges)
    assert idle == pytest.approx({"msm.combine": 20e-9, "msm": 20e-9, "commit.tails": 40e-9,
                                  "round1_commit": 40e-9, spans.NO_SPAN: 50e-9,
                                  "synth": 10e-9})
    # of the 120 ns idle inside the round, 40 fall on the round with no step open
    assert spans.round_share(gaps, ranges) == pytest.approx(40 / 120)


def test_a_gap_under_no_span_keeps_its_label():
    assert spans.idle_by_span([(5, 9)], []) == {spans.NO_SPAN: pytest.approx(4e-9)}
    assert spans.round_share([(5, 9)], [(20, 30, "h2r/ntt")]) is None


def test_launches_and_copies_by_span():
    ranges = [(0, 100, "h2r/round5_open"), (10, 20, "h2r/to_host"), (30, 40, "h2r/h2d")]
    launches = {1: 5, 2: 12, 3: 33, 4: 200}
    ops = [op(6, 8, 1), op(13, 19, 2, "Memcpy DtoH (Device -> Pageable)"),
           op(34, 36, 3, "Memcpy HtoD (Pageable -> Device)"), op(201, 202, 4)]
    assert spans.by_span(ranges, ops, launches) == {
        "round5_open": {"launches": 1, "copies": 0}, "to_host": {"launches": 0, "copies": 1},
        "h2d": {"launches": 0, "copies": 1}, spans.NO_SPAN: {"launches": 1, "copies": 0}}


def _run_spans(root, *args):
    import io
    import json
    from contextlib import redirect_stderr, redirect_stdout

    sys.path.insert(0, BENCH)
    import run_spans

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run_spans.main(list(args), root=os.path.join(root, "benchmark"), device="cpu")
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1])


def test_traced_witness_cell_reads_the_program_spans(checkout):
    from harness import core, trace

    before = trace.Profile, core.cell_metrics, core.window
    out = _run_spans(checkout, "--workload", "rsa512.witness", "--seed", str(2 ** 31 + 7),
                     "--seconds", "1", "--trace", "1")
    assert (trace.Profile, core.cell_metrics, core.window) == before
    assert out["correct"] is True
    prog = out["breakdown"]["program"]
    groups = prog["counts"]["replay.run"]["groups"]
    assert out["metrics"]["replay_groups_per_batch"]["value"] == groups > 0
    assert prog["counts"]["replay.run"]["spans"] == 1
    assert out["metrics"]["replay_copy_ms"]["value"] > 0
    assert "tails_s" not in out["metrics"] and "ntt_s" not in out["metrics"]
    # on the CPU the whole traced window is one idle gap, held by one span
    assert len(out["breakdown"]["idle_gaps"]) == 1


def test_traced_prove_cell_reads_tails_and_ntt(checkout, small_prover):  # noqa: F811
    import json

    cfg = os.path.join(checkout, "benchmark", "configs", "rsa512.json")
    with open(cfg) as f:
        saved = f.read()
    with open(cfg, "w") as f:
        json.dump(dict(json.loads(saved), k=5), f)
    try:
        out = _run_spans(checkout, "--workload", "rsa512.prove", "--seed", "5", "--seconds",
                         "1", "--trace", "1")
    finally:
        with open(cfg, "w") as f:
            f.write(saved)
    assert out["correct"] is True
    for name in ("tails_s", "ntt_s", "round2_commit_s", "round5_open_s"):
        assert out["metrics"][name]["value"] > 0, name
    counts = out["breakdown"]["program"]["counts"]
    assert counts["prove"]["spans"] == 1 and counts["commit.tails"]["products"] > 0


def test_program_tracing_over_an_untraced_window(checkout):
    from halo2_rsa_tpu_torch.utils import profiling

    out = _run_spans(checkout, "--workload", "rsa512.witness", "--seed", "3", "--seconds", "1",
                     "--trace", "0", "--program-tracing", "1")
    assert out["correct"] is True and "witnesses_per_s" in out["metrics"]
    assert profiling._TRACE is None

"""The harness is driven by data: a configuration, a traffic mix and a metric
are added as new files and entries, and no file that was there changes. The
window closes at the end of the request in flight."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

from conftest import TINY, result

from harness import core


def digests(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(root):
        for fn in files:
            if "__pycache__" not in base:
                path = os.path.join(base, fn)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_config_mix_and_metric_are_files_only(checkout, tmp_path):
    root = str(tmp_path / "co")
    shutil.copytree(checkout, root)
    before = digests(os.path.join(root, "benchmark"))
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "rsa512_again.json"), "w") as f:
        json.dump(TINY, f)
    with open(os.path.join(b, "traffic", "check_three.json"), "w") as f:
        json.dump({"call": "check", "keys": 1, "witnesses": 3, "corrupted": 1,
                   "trace_requests": 1}, f)
    with open(os.path.join(b, "metrics", "checks_done.py"), "w") as f:
        f.write('"""Checks in the window."""\n\n\ndef read(run):\n    return len(run.requests)\n')
    bench["configs"].append({"name": "rsa512_again", "source": "test", "reduced": [],
                             "file": "benchmark/configs/rsa512_again.json", "why": "test"})
    bench["workloads"].append({"name": "rsa512_again.check_three", "config": "rsa512_again",
                               "traffic": "check_three", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "checks_done", "unit": "checks", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["rsa512_again.check_three"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    out = result(root, "--workload", "rsa512_again.check_three", "--seed", "3", "--seconds",
                 "0.5", "--trace", "0")
    assert out["correct"] is True
    assert out["metrics"]["checks_done"] == {"value": out["attempted"], "unit": "checks"}
    assert "check_p95_ms" not in out["metrics"]  # the metric lists only its own cells
    after = digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


class _Calls:
    """Requests of fixed lengths on the host clock."""

    def __init__(self, lengths):
        self.lengths = lengths

    def request(self, run, i):
        time.sleep(self.lengths[i % len(self.lengths)])
        return i

    def units(self, run, answer):
        return 2


def test_window_closes_after_the_request_in_flight():
    run = core.Run("", {}, {}, {}, 1, 0.5, False, device="cpu")
    core.window(run, _Calls([0.2, 0.35]))
    # ends at ~0.2, 0.55: the second request ends past 0.5 s and closes it
    assert len(run.requests) == 2
    assert run.elapsed >= 0.5
    first, last = run.requests[0][0], run.requests[-1][1]
    assert 0 <= run.elapsed - (last - first) < 0.01  # the window runs to the last end
    assert run.answers == [0, 1]


def test_rate_divides_by_the_whole_window():
    run = core.Run("", {}, {}, {}, 1, 0.3, False, device="cpu")
    core.window(run, _Calls([0.25]))
    rate = core.load_module("metrics", "witnesses_per_s").read(run)
    assert rate == sum(u for *_, u in run.requests) / run.elapsed
    assert run.elapsed >= 0.3 and len(run.requests) == 2


_SLEEPY = '''"""A call whose set-up spends 0.4 s on the reference's side."""

import time


def prepare(run):
    with run.apart():
        time.sleep(0.4)


def request(run, i):
    time.sleep(0.05)
    return i


def units(run, answer):
    return 1


def release(run):
    pass


def judge(run):
    return {}


def failed(run):
    return 0
'''


def test_reference_set_up_is_left_out_of_setup_s(tmp_path):
    root = tmp_path / "benchmark"
    (root / "calls").mkdir(parents=True)
    (root / "calls" / "sleepy.py").write_text(_SLEEPY)
    run = core.Run(str(root), {"name": "x.sleepy"}, {}, {"call": "sleepy"}, 4, 0.2, False,
                   device="cpu")
    t_start = time.perf_counter()
    core.execute(run, t_start)
    assert 0.4 <= run.apart_s < 0.5
    assert run.setup_s < 0.1
    # each request's start and end, from the first start, beside the checkout
    with open(tmp_path / "build" / "bench_runs" / "x.sleepy.4.0.json") as f:
        spans = json.load(f)
    assert len(spans) == len(run.requests) and spans[0][0] == 0
    assert all(0 <= a < b for a, b in spans)

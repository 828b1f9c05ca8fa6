"""Fixtures of the benchmark's CPU tests: a temporary checkout holding a copy
of ``benchmark/`` and of ``BENCHMARK.json``, with a tiny configuration
(RSA-512 over a pre-hashed digest, k=14) and small traffic mixes added as new
files and entries, and a way to run one cell of it on the CPU."""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"bits": 512, "e": 65537, "msg_bytes": 32, "sha_in_circuit": False, "gates": 8606,
        "witness_cells": 15010, "k": 14, "tau": 777}
TINY_MIXES = {
    "prove_tiny": {"call": "prove", "keys": 2, "pool": 4, "trace_requests": 1},
    "witness_tiny": {"call": "witness", "keys": 2, "batch": 4, "batches": 2, "trace_requests": 1},
    "check_tiny": {"call": "check", "keys": 2, "witnesses": 4, "corrupted": 2,
                   "trace_requests": 2},
}
SEED = 2 ** 31 + 12345  # seeds may exceed 32 signed bits


# The metrics of a check cell, which the tiny check cell reports.
CHECK_METRICS = {
    "end_to_end": [{"name": "check_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock"}],
    "per_layer": [
        {"name": "check_device_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "constraint checker", "moves": "check_p95_ms"},
        {"name": "k1_roofline.check", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "kernels", "moves": "check_p95_ms"},
        {"name": "idle_pct.check", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "check_p95_ms"},
    ],
}


def add_cell(root: str, bench: dict, name: str, config: str, traffic: str,
             like: str | None = None) -> None:
    """A cell entry; it reports every metric that the cell ``like`` reports."""
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> str:
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "rsa512", "source": "test", "file":
                             "benchmark/configs/rsa512.json", "reduced": [], "why": "test"})
    with open(os.path.join(root, "benchmark", "configs", "rsa512.json"), "w") as f:
        json.dump(TINY, f)
    for mix, params in TINY_MIXES.items():
        with open(os.path.join(root, "benchmark", "traffic", mix + ".json"), "w") as f:
            json.dump(params, f)
    add_cell(root, bench, "rsa512.prove", "rsa512", "prove_tiny", "rsa1024.prove")
    add_cell(root, bench, "rsa512.witness", "rsa512", "witness_tiny", "rsa1024.witness")
    for section, metrics in CHECK_METRICS.items():
        bench[section] += [dict(m, workloads=["rsa512.check"]) for m in metrics]
    add_cell(root, bench, "rsa512.check", "rsa512", "check_tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_cell(root: str, *args: str) -> tuple:
    """(exit code, stdout lines, stderr) of one run on the CPU."""
    import torch

    from harness import core

    torch.set_num_threads(1)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = core.main(list(args), time.perf_counter(), root=os.path.join(root, "benchmark"),
                       device="cpu")
    return rc, out.getvalue().splitlines(), err.getvalue()


def result(root: str, *args: str) -> dict:
    rc, lines, err = run_cell(root, *args)
    assert rc == 0, err
    return json.loads(lines[-1])

"""Whole runs of the harness on the CPU at a tiny size: the last line's keys,
and each fault the cells can have planted under the timed path, which the
reference has to catch."""

from __future__ import annotations

import pytest

from conftest import SEED, result, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def test_last_line_keys(checkout):
    out = result(checkout, "--workload", "rsa512.check", "--seed", str(SEED), "--seconds", "1",
                 "--trace", "0")
    assert list(out) == KEYS  # ``compared`` comes last
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "check_p95_ms"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert out["compared"] == {"counts_wrong": {"value": 0, "limit": 0}}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_line_has_device_window(checkout):
    out = result(checkout, "--workload", "rsa512.check", "--seed", "7", "--seconds", "1",
                 "--trace", "1")
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "compared"


def test_unknown_cell_prints_nothing(checkout):
    rc, lines, _ = run_cell(checkout, "--workload", "nope", "--seed", "1", "--seconds", "1")
    assert rc != 0 and lines == []


@pytest.mark.parametrize("cell,fault", [
    ("rsa512.check", "alter"), ("rsa512.check", "stale"),
    ("rsa512.witness", "alter"), ("rsa512.witness", "half"), ("rsa512.witness", "stale"),
])
def test_fault_is_caught(checkout, cell, fault):
    # a window long enough for two requests of the cell on a CPU
    seconds = {"rsa512.check": "2", "rsa512.witness": "15"}[cell]
    out = result(checkout, "--workload", cell, "--seed", str(SEED + 1), "--seconds", seconds,
                 "--trace", "0", "--fault", fault)
    assert out["attempted"] >= 2
    assert out["correct"] is False
    assert out["failed"] >= 1


def _small_statement(classes, req):
    """A stand-in for the RSA circuit that keygen and proving on the CPU can
    hold: out = (x y + x) y + x y, public, with x and y from the request."""
    x, y = req["n"] % 1000 + 2, req["sig"] % 1000 + 3
    b = classes["Builder"](classes["field"])
    mg = classes["MainGate"](b)
    a, c = mg.assign_value(x), mg.assign_value(y)
    m = mg.mul(a, c)
    b.expose_public(mg.mul_add(mg.add(m, a), c, m))
    return b, [(x * y + x) * y + x * y]


@pytest.fixture()
def small_prover(monkeypatch):
    """The prove call's circuits replaced by the stand-in, at k=5."""
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.circuit.builder import Builder as PBuilder
    from halo2_rsa_tpu_torch.circuit.main_gate import MainGate as PMainGate
    from halo2_rsa_tpu_torch.fields.field import BN254_FR as PFR

    from harness import circuits
    from refimpl.synth.circuit import Builder, MainGate
    from refimpl.synth.fields import BN254_FR

    class Circ:
        def __init__(self, req):
            self.builder, self.public_inputs = _small_statement(
                dict(Builder=PBuilder, MainGate=PMainGate, field=PFR), req)

        def compile(self):
            return checker.compile_circuit(self.builder)

    ref = dict(Builder=Builder, MainGate=MainGate, field=BN254_FR)
    monkeypatch.setattr(circuits, "program_circuit", lambda cfg, req: Circ(req))
    monkeypatch.setattr(circuits, "reference_circuit", lambda cfg, req: _small_statement(ref, req))
    monkeypatch.setattr(circuits, "public_inputs", lambda cfg, req: _small_statement(ref, req)[1])
    monkeypatch.setattr(circuits, "check_size", lambda cfg, builder: None)


@pytest.mark.parametrize("fault", [None, "alter", "stale"])
def test_prove_cell(checkout, small_prover, fault):
    """A sound run proves correct; a bit flipped in a proof where it is made,
    or a step that hands back its last proof, does not."""
    import json
    import os

    cfg = os.path.join(checkout, "benchmark", "configs", "rsa512.json")
    with open(cfg) as f:
        saved = f.read()
    with open(cfg, "w") as f:
        json.dump(dict(json.loads(saved), k=5), f)
    try:
        # a window long enough for two proofs on a CPU
        args = ["--workload", "rsa512.prove", "--seed", "5", "--seconds", "30", "--trace", "0"]
        out = result(checkout, *args + (["--fault", fault] if fault else []))
    finally:
        with open(cfg, "w") as f:
            f.write(saved)
    assert out["attempted"] >= 2
    assert out["correct"] is (fault is None)
    assert out["failed"] == (0 if fault is None else out["failed"]) and (
        fault is None or out["failed"] >= 1)

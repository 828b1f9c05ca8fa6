"""The dynamic-length prove call on the CPU at a tiny size: RSA-512 with
SHA-256 in its dynamic mode up to 64 B, written into a copy of the tests'
checkout beside the other tiny configurations; its stand-in circuits are
proved at k=5, as ``test_bench_runs.test_prove_cell`` proves its own."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from conftest import SEED, add_cell, run_cell
from test_bench_runs import _small_statement

TINY_VARLEN = {"bits": 512, "e": 65537, "max_msg_bytes": 64, "sha_in_circuit": True,
               "sha_dynamic": True, "gates": 0, "witness_cells": 0, "k": 5, "tau": 777}
TINY_MIX = {"call": "prove_varlen", "keys": 2, "pool": 4, "trace_requests": 1,
            "len_min": 0, "len_max": 64}


@pytest.fixture(scope="module")
def varlen_checkout(checkout, tmp_path_factory) -> str:
    """A copy of the checkout with the configuration ``rsa512_varlen`` and the
    cell ``rsa512_varlen.prove``, which reports what ``zkemail_hdr1024.prove``
    reports."""
    root = str(tmp_path_factory.mktemp("varlen")) + "/checkout"
    shutil.copytree(checkout, root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "rsa512_varlen", "source": "test", "file":
                             "benchmark/configs/rsa512_varlen.json", "reduced": [],
                             "why": "test"})
    with open(os.path.join(root, "benchmark", "configs", "rsa512_varlen.json"), "w") as f:
        json.dump(TINY_VARLEN, f)
    with open(os.path.join(root, "benchmark", "traffic", "prove_varlen_tiny.json"), "w") as f:
        json.dump(TINY_MIX, f)
    add_cell(root, bench, "rsa512_varlen.prove", "rsa512_varlen", "prove_varlen_tiny",
             "zkemail_hdr1024.prove")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture()
def small_varlen_prover(monkeypatch):
    """The dynamic-length prove call's circuits replaced by the stand-in at
    k=5, its second input offset by the message's length: one shape for
    every length, a witness and a public input that depend on it."""
    from halo2_rsa_tpu_torch import pipelines
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.circuit.builder import Builder as PBuilder
    from halo2_rsa_tpu_torch.circuit.main_gate import MainGate as PMainGate
    from halo2_rsa_tpu_torch.fields.field import BN254_FR as PFR

    from harness import circuits
    from refimpl.synth import pipeline_dynamic
    from refimpl.synth.circuit import Builder, MainGate
    from refimpl.synth.fields import BN254_FR

    prog = dict(Builder=PBuilder, MainGate=PMainGate, field=PFR)
    ref = dict(Builder=Builder, MainGate=MainGate, field=BN254_FR)

    def statement(classes, n, sig, msg):
        return _small_statement(classes, dict(n=n, sig=sig + len(msg)))

    class Circ:
        def __init__(self, n, sig, msg):
            self.builder, self.public_inputs = statement(prog, n, sig, msg)

        def compile(self):
            return checker.compile_circuit(self.builder)

    def build(cls, bits, n, sig, msg=None, max_len=None, **kw):
        assert max_len == 64 and len(msg) <= max_len
        return Circ(n, sig, msg)

    def without_witness(cls, bits, msg_len=None, max_len=None, **kw):
        assert max_len == 64
        return Circ(1, 0, b"")

    def ref_build(bits, n, sig, msg, max_len):
        assert max_len == 64
        return statement(ref, n, sig, msg)

    monkeypatch.setattr(pipelines.Pkcs1v15Circuit, "build", classmethod(build))
    monkeypatch.setattr(pipelines.Pkcs1v15Circuit, "without_witness",
                        classmethod(without_witness))
    monkeypatch.setattr(pipeline_dynamic, "build", ref_build)
    monkeypatch.setattr(circuits, "public_inputs",
                        lambda cfg, req: statement(ref, req["n"], req["sig"], req["msg"])[1])
    monkeypatch.setattr(circuits, "check_size", lambda cfg, builder: None)


@pytest.mark.parametrize("fault", [None, "alter", "stale"])
def test_prove_varlen_cell(varlen_checkout, small_varlen_prover, fault):
    """Requests of varied lengths proved under the one key of the dynamic
    circuit: a sound run proves correct, an altered or stale proof does not;
    the reference stays clear of the program."""
    from harness import guard

    # a window long enough for two proofs on a CPU
    args = ["--workload", "rsa512_varlen.prove", "--seed", str(SEED + 2), "--seconds", "30",
            "--trace", "0"]
    rc, lines, err = run_cell(varlen_checkout, *args + (["--fault", fault] if fault else []))
    assert rc == 0, err
    out = json.loads(lines[-1])
    lengths = [int(x) for x in err.split("message lengths proved:")[1].split("\n")[0].split()]
    assert out["attempted"] == len(lengths) >= 2 and len(set(lengths)) >= 2
    assert all(0 <= x <= 64 for x in lengths)
    assert out["correct"] is (fault is None)
    assert out["failed"] == 0 if fault is None else out["failed"] >= 1
    assert guard.reference_imports(os.path.join(varlen_checkout, "benchmark", "refimpl")) == []


def test_sha_dynamic_span_and_reader(varlen_checkout):
    """Traced, the call's span ``sha_dynamic`` wraps the chip's dynamic mode
    and ``sha_dynamic_ms.prove`` reads it per proof; release puts the chip's
    method back."""
    from halo2_rsa_tpu_torch.circuit.builder import Builder
    from halo2_rsa_tpu_torch.fields.field import BN254_FR
    from halo2_rsa_tpu_torch.sha256.chip import Sha256Chip

    from harness import core

    root = os.path.join(varlen_checkout, "benchmark")
    call = core.load_module("calls", "prove_varlen", root)
    run = core.Run(root, {"name": "x"}, {}, {}, 1, 1.0, True, device="cpu")
    run.state["prove"] = core.load_module("calls", "prove", root)
    real = Sha256Chip.digest_dynamic
    call._span_sha(run)
    try:
        assert Sha256Chip.digest_dynamic is not real
        Sha256Chip(Builder(BN254_FR)).digest_dynamic(b"abc", 4)
    finally:
        call.release(run)
    assert Sha256Chip.digest_dynamic is real
    assert len(run.spans["sha_dynamic"]) == 1
    run.requests = [(0.0, 1.0, 1), (1.0, 2.0, 1)]
    got = core.load_module("metrics", "sha_dynamic_ms.prove", root).read(run)
    assert got == pytest.approx(run.spans["sha_dynamic"][0] * 1e3 / 2)


def test_prove_varlen_needs_a_dynamic_configuration(varlen_checkout):
    """The configuration selects the mode: without ``sha_dynamic`` the call
    refuses before it makes a request or a key."""
    from harness import core

    root = os.path.join(varlen_checkout, "benchmark")
    call = core.load_module("calls", "prove_varlen", root)
    cfg = {k: v for k, v in TINY_VARLEN.items() if k != "sha_dynamic"}
    run = core.Run(root, {"name": "x"}, cfg, {}, 1, 1.0, False, device="cpu")
    with pytest.raises(ValueError, match="sha_dynamic"):
        call.prepare(run)
    assert run.state == {}

"""The port's tracer (``utils/profiling``) on the CPU.

Off (the default), ``span`` is the shared null context: no clock is read, no
profiler range opened, nothing recorded. On, the k=5 golden proof records
its rounds and the steps inside them with their parents, requests and
counts (the key's tail comb is not built inside it; each MSM counts the
points K2 read through the bucket sort's permutation), a small batched
replay records one span per group, and a build with SHA-256 in its
dynamic-length mode records ``sha256.dynamic`` inside ``synth`` with its
blocks and the message's bytes; proof bytes
and replayed witnesses are the same with tracing on and off. Under
``torch.profiler`` the spans appear as ``h2r/`` ranges, each inside its
parent's.
"""

import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from halo2_rsa_tpu_torch import golden
from halo2_rsa_tpu_torch.bigint import BigIntChip
from halo2_rsa_tpu_torch.circuit import Builder, checker
from halo2_rsa_tpu_torch.fields import BN254_FR
from halo2_rsa_tpu_torch.prover import kzg, plonk
from halo2_rsa_tpu_torch.utils import profiling
from halo2_rsa_tpu_torch.witness import WitnessProgram

torch.set_num_threads(1)

ROUNDS = ("witness", "round1_commit", "round2_commit", "round3_quotient", "round4_evals",
          "round5_open")


@pytest.fixture(scope="module")
def golden_case():
    meta, want = golden.load("lookup_k5")
    b, pubs = golden.build_circuit("lookup_k5")
    srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device="cpu")
    pk, _ = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
    return dict(meta=meta, want=want, b=b, pubs=pubs, pk=pk)


def _prove(case, phases=None):
    return plonk.prove(case["pk"], case["b"].values, case["pubs"],
                       rng=random.Random(case["meta"]["seed"]), phases=phases)


@pytest.fixture(scope="module")
def traced(golden_case):
    with profiling.tracing() as trace, profiling.request(7):
        proof = _prove(golden_case, profiling.Phases())
    return proof, trace


@pytest.fixture(scope="module")
def replay():
    """A 256-bit ``mul_mod`` replayed for 3 instances: (program, instances)."""
    rng = random.Random(3)
    n_v = rng.getrandbits(256) | (1 << 255)

    def build(a_v, b_v):
        b = Builder(BN254_FR)
        chip = BigIntChip(b, 64, 256)
        res = chip.mul_mod(chip.assign_integer(a_v), chip.assign_integer(b_v),
                           chip.assign_integer(n_v))
        chip.assert_equal_fresh(res, chip.assign_integer((a_v * b_v) % n_v))
        return b

    builders = [build(rng.getrandbits(256) % n_v, rng.getrandbits(256) % n_v) for _ in range(3)]
    prog = WitnessProgram(builders[0])
    cells = builders[0].input_cells()
    return prog, [{c: bl.values[c] for c in cells} for bl in builders]


@pytest.fixture(scope="module")
def untraced(golden_case, replay):
    """The golden proof and a replay with tracing off, with every clock read
    and profiler range the tracer made: (proof, witnesses, calls)."""
    calls = []
    real_clock = profiling.time.perf_counter_ns
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling.time, "perf_counter_ns",
                   lambda: calls.append("clock") or real_clock())
        mp.setattr(profiling.torch.profiler, "record_function", lambda name: calls.append(name))
        assert profiling._TRACE is None
        with profiling.span("x", bytes=1), profiling.request(2):
            profiling.count(bytes=5)
        proof = _prove(golden_case)
        prog, insts = replay
        witnesses = prog.generate(insts, device="cpu")
    return proof, witnesses, calls


def test_span_off_is_the_shared_null_context_and_records_nothing(untraced):
    assert profiling.span("ntt", batch=3) is profiling.span("msm") is profiling._NULL
    assert untraced[2] == [] and profiling._TRACE is None


def test_tracing_does_not_nest():
    with profiling.tracing():
        with pytest.raises(RuntimeError):
            with profiling.tracing():
                pass
    assert profiling._TRACE is None


def test_golden_proof_bytes_equal_with_tracing_on_and_off(golden_case, traced, untraced):
    assert traced[0] == untraced[0] == golden_case["want"]


def test_golden_prove_spans_parents_requests_counts(golden_case, traced):
    _, trace = traced
    spans = trace.spans
    names = {s.name for s in spans}
    assert names == set(ROUNDS) | {
        "prove", "h2d", "ntt", "msm", "msm.combine", "to_host", "commit.tails",
        "round2.products", "round3.identities", "open.quotients"}
    assert all(s.end_ns >= s.start_ns for s in spans)
    assert all(s.request == 7 for s in spans)
    root = spans[0]
    assert root.name == "prove" and root.parent is None
    assert [spans[s.parent].name for s in spans if s.name in ROUNDS] == ["prove"] * 6

    def parents(name):
        return {spans[s.parent].name for s in spans if s.name == name}

    assert parents("h2d") == {"witness"}
    assert parents("ntt") == {"round1_commit", "round2_commit", "round3_quotient"}
    assert parents("msm") == {"round1_commit", "round2_commit", "round3_quotient",
                              "round5_open"}
    assert parents("msm.combine") == {"msm"}
    assert parents("commit.tails") == {"round1_commit", "round2_commit", "round5_open"}
    assert parents("to_host") == {"round1_commit", "round2_commit", "round3_quotient",
                                  "round4_evals", "round5_open", "open.quotients"}
    assert parents("round2.products") == {"round2_commit"}
    assert parents("round3.identities") == {"round3_quotient"}
    assert parents("open.quotients") == {"round5_open"}

    pk = golden_case["pk"]
    n, wires = pk.vk.n, pk.vk.num_wires
    tables = len(pk.vk.lookup_bits)
    w = len(golden_case["b"].values)
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert by["witness"][0].counts == {"cells": w}
    assert by["h2d"][0].counts == {"bytes": w * 32 + wires * n * 8}
    r1 = [s for s in by["ntt"] if spans[s.parent].name == "round1_commit"]
    assert [s.counts for s in r1] == [{"batch": wires + tables, "log_n": pk.vk.k}]
    r1_tails = [s for s in by["commit.tails"] if spans[s.parent].name == "round1_commit"]
    assert r1_tails[0].counts == {"products": plonk.BLIND * (wires + tables)}
    r5_tails = [s for s in by["commit.tails"] if spans[s.parent].name == "round5_open"]
    assert [s.counts for s in r5_tails] == [{"products": 2 * plonk.BLIND}]
    # the key's tail comb is built with the key, never inside a proof
    assert "commit.tails.table" not in names and golden_case["pk"].tail_table is not None
    assert all(s.counts["points"] >= n and s.counts["polys"] >= 1 for s in by["msm"])
    assert all(s.counts["bytes"] > 0 for s in by["to_host"])

    totals = trace.totals()
    assert totals["msm"]["spans"] == len(by["msm"]) == 4
    assert totals["ntt"]["batch"] == sum(s.counts["batch"] for s in by["ntt"])
    assert totals["prove"]["seconds"] == pytest.approx(root.seconds)


def test_msm_spans_count_the_points_k2_reads_through_the_permutation(traced):
    """Every commitment's MSM runs on affine bases: its span counts the
    points K2 read in place through the bucket sort's permutation, P x W x
    N over its pipelines (N padded to a power of two), and no gathered
    rows."""
    from halo2_rsa_tpu_torch.prover import msm

    _, trace = traced
    spans = [s for s in trace.spans if s.name == "msm"]
    assert spans
    for s in spans:
        npow = max(32, 1 << (s.counts["points"] - 1).bit_length())
        windows = 256 // msm._window_bits_for(min(npow, msm._SEG))
        assert s.counts.get("gathered_rows", 0) == 0
        assert s.counts["indexed_rows"] == s.counts["polys"] * windows * npow


def test_request_defaults_to_the_root_span(replay):
    prog, insts = replay
    with profiling.tracing() as trace:
        prog.generate(insts, device="cpu")
        with profiling.span("outer"):
            profiling.count(items=2)
            profiling.count(items=3)
        with profiling.request(4):
            prog.generate(insts, device="cpu")
    roots = [i for i, s in enumerate(trace.spans) if s.parent is None]
    assert [trace.spans[i].name for i in roots] == ["replay.generate", "outer",
                                                    "replay.generate"]
    for i, s in enumerate(trace.spans):
        root = max(r for r in roots if r <= i)
        assert s.request == (4 if root == roots[2] else root)
    assert trace.spans[roots[1]].counts == {"items": 5}


def test_replay_spans_and_witnesses(replay, untraced):
    prog, insts = replay
    off = untraced[1]
    with profiling.tracing() as trace:
        on = prog.generate(insts, device="cpu")
    np.testing.assert_array_equal(on, off)
    spans = trace.spans
    assert [s.name for s in spans[:3]] == ["replay.generate", "replay.host_inputs",
                                           "replay.copy_in"]
    gen, host, copy_in = spans[:3]
    assert gen.counts == {"instances": 3} and host.counts == {"instances": 3}
    assert host.parent == copy_in.parent == 0
    run = next(s for s in spans if s.name == "replay.run")
    assert run.counts == {"groups": len(prog.groups), "batch": 3}
    groups = [s for s in spans if s.parent == spans.index(run)]
    assert [s.name for s in groups] == ["replay." + g.kind for g in prog.groups]
    copy_out = spans[-1]
    assert copy_out.name == "replay.copy_out" and copy_out.parent == 0
    assert copy_out.counts == {"bytes": off.nbytes}
    assert copy_in.counts["bytes"] == 3 * (len(prog.input_idx) + len(prog._big_cells)) * 32


def test_spans_are_profiler_ranges_nested_as_their_parents(replay):
    prog, insts = replay
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing() as trace:
        prog.generate(insts, device="cpu")
    ranges = sorted((e.start_ns(), -e.duration_ns(), e.name()[len("h2r/"):])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("h2r/"))
    assert [r[2] for r in ranges] == [s.name for s in trace.spans]
    assert len(ranges) == len(prog.groups) + 5
    for s, (start, neg_dur, _) in zip(trace.spans, ranges):
        if s.parent is not None:
            p_start, p_neg_dur, _ = ranges[s.parent]
            assert p_start <= start and start - neg_dur <= p_start - p_neg_dur


@pytest.fixture(scope="module")
def dynamic_request():
    """An RSA-1024 signature over a 70 B message, for a dynamic build of
    ``max_len`` 100 (two SHA-256 blocks): (n, sig, msg)."""
    from halo2_rsa_tpu_torch.pipelines import sign_fixture

    msg = bytes(range(70))
    return sign_fixture(1024, msg, rng=random.Random(5)) + (msg,)


def test_dynamic_sha_span_nests_in_synth(dynamic_request):
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit

    n, sig, msg = dynamic_request
    with profiling.tracing() as trace:
        Pkcs1v15Circuit.build(1024, n, sig, msg=msg, max_len=100)
    spans = trace.spans
    assert [s.name for s in spans] == ["synth", "sha256.dynamic"]
    sha = spans[1]
    assert spans[sha.parent].name == "synth"
    assert sha.counts == {"blocks": (100 + 8) // 64 + 1, "bytes": 70}
    assert spans[0].start_ns <= sha.start_ns <= sha.end_ns <= spans[0].end_ns


def test_dynamic_build_records_nothing_with_tracing_off(dynamic_request):
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit

    n, sig, msg = dynamic_request
    calls = []
    real_clock = profiling.time.perf_counter_ns
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling.time, "perf_counter_ns",
                   lambda: calls.append("clock") or real_clock())
        mp.setattr(profiling.torch.profiler, "record_function", lambda name: calls.append(name))
        Pkcs1v15Circuit.build(1024, n, sig, msg=msg, max_len=100)
    assert calls == [] and profiling._TRACE is None

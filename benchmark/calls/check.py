"""One constraint check per request: ``circuit.checker.check(compiled, w)``
on one (W, 8) host witness, as a circuit developer's MockProver loop or a
service that validates a witness before it pays for a proof would call it.
The witness is copied to the card on every call.

The pool holds ``witnesses`` distinct witnesses from the frozen synthesis,
``corrupted`` of them (drawn from the seed) overwritten in 3 gate cells and
3 lookup cells by the frozen ``corrupt``; request i checks witness i mod
``witnesses``. Judged: every answer's gate and lookup violation counts against
the reference's counts of its witness. Compared: ``counts_wrong``, limit 0.

Traffic parameters: ``keys``, ``witnesses``, ``corrupted``, ``trace_requests``.
Faults (controls only): ``alter`` adds one gate violation to request 0's
answer; ``stale`` answers each request after the first with the one before.
"""

from __future__ import annotations

import numpy as np

from harness import circuits, fixtures, traffic


def prepare(run) -> None:
    from halo2_rsa_tpu_torch.circuit import checker

    count = run.traffic["witnesses"]
    reqs = traffic.requests(run, 0, count)
    circ = circuits.program_circuit(run.cfg, reqs[0])
    circuits.check_size(run.cfg, circ.builder)
    compiled = circ.compile()
    bad = set(run.rng("corrupt").sample(range(count), run.traffic["corrupted"]))
    values, pool = [], []
    for j, req in enumerate(reqs):
        ref, _ = circuits.reference_circuit(run.cfg, req)
        vals = ref.values
        if j in bad:
            vals = fixtures.corrupt(ref, np.random.default_rng([run.seed, j]))
        values.append(vals)
        pool.append(circuits.limbs(vals))
    run.state.update(compiled=compiled, pool=pool, values=values, structure_req=reqs[0])
    for w in pool[:2]:  # the cell's own shapes
        checker.check(compiled, w, device=run.device)
    if run.trace:
        real = checker._limbs

        def limbs(*args, **kw):
            with run.span("h2d_copy"):
                return real(*args, **kw)

        checker._limbs = limbs
        run.state["unpatch"] = lambda: setattr(checker, "_limbs", real)


def request(run, i: int) -> dict:
    from halo2_rsa_tpu_torch.circuit import checker

    pool = run.state["pool"]
    out = checker.check(run.state["compiled"], pool[i % len(pool)], device=run.device)
    if run.fault == "alter" and i == 0:
        out["gate_violations"] += 1
    elif run.fault == "stale" and i > 0:
        out = run.answers[-1]
    return out


def units(run, answer) -> int:
    return 1


def release(run) -> None:
    run.state.pop("unpatch", lambda: None)()
    run.state.pop("compiled", None)
    if run.device != "cpu":
        import torch

        torch.cuda.empty_cache()


def judge(run) -> dict:
    from refimpl import checks, plonk

    builder, _ = circuits.reference_circuit(run.cfg, run.state["structure_req"])
    st = plonk.Structure(builder)
    want = [checks.violations(st, vals) for vals in run.state["values"]]
    wrong = sum((ans["gate_violations"], ans["lookup_violations"]) != want[i % len(want)]
                for i, ans in enumerate(run.answers))
    run.state["failed"] = wrong
    return {"counts_wrong": {"value": wrong, "limit": 0}}


def failed(run) -> int:
    return run.state["failed"]

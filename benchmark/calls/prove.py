"""One proof per request: the program synthesises the request's circuit
(``Pkcs1v15Circuit.build``) and proves it (``prover.plonk.prove``) under the
keys of the configuration; the blinding rng is drawn from the seed and the
request's index.

Judged: every proof of the window, by the reference verifier against the
request's own public inputs, under a verifying key the reference works out
from the frozen circuit and tau. Compared: ``proofs_rejected``, limit 0.

Traffic parameters: ``keys`` (RSA keys that sign the requests), ``pool``
(distinct requests, more than a window completes), ``trace_requests``.
Faults (``--fault``, controls only): ``alter`` flips a bit of request 0's
proof; ``stale`` answers each request after the first with the proof before.
"""

from __future__ import annotations

import contextlib

from harness import circuits, traffic


def prepare(run) -> None:
    pool = run.traffic["pool"]
    run.state["pool"] = traffic.requests(run, 0, pool)
    warm = traffic.requests(run, pool, 1)[0]
    circ = circuits.program_circuit(run.cfg, warm)
    circuits.check_size(run.cfg, circ.builder)
    run.state["pk"] = circuits.keys(run, circ.compile())[1]
    _prove(run, circ, run.rng("blind", "warm"))  # the cell's own shapes, once
    if run.trace:
        _span_msm(run)


def _span_msm(run) -> None:
    from halo2_rsa_tpu_torch.prover import msm

    real = msm.msm_many

    def msm_many(*args, **kw):
        with run.span("msm"):
            return real(*args, **kw)

    msm.msm_many = msm_many
    run.state["unpatch"] = lambda: setattr(msm, "msm_many", real)


def _phases(run):
    import torch
    from halo2_rsa_tpu_torch.utils.profiling import Phases

    class Traced(Phases):
        @contextlib.contextmanager
        def phase(self, name, **meta):
            with torch.profiler.record_function("bench/" + name), super().phase(name, **meta):
                yield

    return Traced() if run.trace else Phases()


def _prove(run, circ, rng, ph=None) -> bytes:
    from halo2_rsa_tpu_torch.prover import plonk

    return plonk.prove(run.state["pk"], circ.builder.values, circ.public_inputs, rng=rng,
                       phases=ph)


def request(run, i: int) -> bytes:
    pool = run.state["pool"]
    with run.span("synth"):
        circ = circuits.program_circuit(run.cfg, pool[i % len(pool)])
    ph = _phases(run)
    proof = _prove(run, circ, run.rng("blind", i), ph)
    for name, s in ph.times.items():
        run.spans.setdefault(name, []).append(s)
    if run.fault == "alter" and i == 0:
        proof = bytes([proof[0] ^ 1]) + proof[1:]
    elif run.fault == "stale" and i > 0:
        proof = run.answers[-1]
    return proof


def units(run, answer) -> int:
    return 1


def release(run) -> None:
    run.state.pop("unpatch", lambda: None)()
    run.state.pop("pk", None)
    if run.device != "cpu":
        import torch

        torch.cuda.empty_cache()


def judge(run) -> dict:
    from refimpl import plonk

    pool = run.state["pool"]
    builder, _ = circuits.reference_circuit(run.cfg, pool[0])
    vk = plonk.verifying_key(plonk.Structure(builder), run.cfg["k"], run.cfg["tau"])
    rejected = 0
    for i, proof in enumerate(run.answers):
        req = pool[i % len(pool)]
        rejected += not plonk.verify(vk, proof, circuits.public_inputs(run.cfg, req),
                                     run.cfg["tau"])
    run.state["failed"] = rejected
    return {"proofs_rejected": {"value": rejected, "limit": 0}}


def failed(run) -> int:
    return run.state["failed"]

"""One proof per request, of a message whose length varies from request to
request, all under one proving key: the program synthesises the request's
circuit with SHA-256 in its dynamic-length mode
(``Pkcs1v15Circuit.build(..., max_len=...)``) and proves it
(``prover.plonk.prove``). The key comes from the witness-free circuit of the
configuration's ``max_msg_bytes`` (``Pkcs1v15Circuit.without_witness``),
which has the same trace as every request. The configuration must set
``sha_dynamic``: a fixed-length SHA-256 circuit differs from length to
length, so no one key could prove them.

Proving, spans, phases, faults and the rest are ``calls/prove.py``'s, loaded
from there. Traced, the benchmark's span ``sha_dynamic`` also wraps
``Sha256Chip.digest_dynamic``.

Judged: every proof of the window, by the reference verifier against the
request's own public inputs (n's limbs, the digest's bytes), under one
verifying key the reference works out from the frozen dynamic circuit of
request 0 and tau. Compared: ``proofs_rejected``, limit 0.

Traffic parameters: ``keys`` (RSA keys that sign the requests), ``pool``
(distinct requests, more than a window completes), ``len_min`` and
``len_max`` (each request's message length, drawn uniformly from the seed;
the warm-up request's is ``max_msg_bytes``), ``trace_requests``.
"""

from __future__ import annotations

from harness import circuits, core, fixtures, traffic


def _requests(run, start: int, count: int, length: int | None = None) -> list:
    """Requests ``start`` .. ``start + count - 1``; request i is signed by key
    i mod ``keys`` over a distinct message of ``length`` bytes, or of a length
    drawn from the seed in [``len_min``, ``len_max``]."""
    bits = run.cfg["bits"]
    ks = traffic.keys(run)
    out = []
    for i in range(start, start + count):
        n, d = ks[i % len(ks)]
        rng = run.rng("msg", i)
        size = length if length is not None else rng.randint(run.traffic["len_min"],
                                                              run.traffic["len_max"])
        msg = rng.randbytes(size)
        out.append(dict(bits=bits, n=n, sig=fixtures.sign(n, d, bits, msg), msg=msg,
                        key=i % len(ks)))
    return out


def _circuit(run, req: dict):
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit

    return Pkcs1v15Circuit.build(req["bits"], req["n"], req["sig"], msg=req["msg"],
                                 max_len=run.cfg["max_msg_bytes"])


def _span_sha(run) -> None:
    from halo2_rsa_tpu_torch.sha256.chip import Sha256Chip

    real = Sha256Chip.digest_dynamic

    def digest_dynamic(self, *args, **kw):
        with run.span("sha_dynamic"):
            return real(self, *args, **kw)

    Sha256Chip.digest_dynamic = digest_dynamic
    unpatch = run.state.pop("unpatch", lambda: None)

    def undo():
        Sha256Chip.digest_dynamic = real
        unpatch()

    run.state["unpatch"] = undo


def prepare(run) -> None:
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit

    if not run.cfg.get("sha_dynamic"):
        raise ValueError("prove_varlen proves every length under one key, which needs SHA-256 "
                         "in its dynamic-length mode: the configuration must set sha_dynamic")
    base = run.state["prove"] = core.load_module("calls", "prove", run.root)
    pool = run.traffic["pool"]
    run.state["pool"] = _requests(run, 0, pool)
    warm = _requests(run, pool, 1, run.cfg["max_msg_bytes"])[0]
    circ = _circuit(run, warm)
    circuits.check_size(run.cfg, circ.builder)
    shape = Pkcs1v15Circuit.without_witness(run.cfg["bits"], max_len=run.cfg["max_msg_bytes"])
    run.state["pk"] = circuits.keys(run, shape.compile())[1]
    base._prove(run, circ, run.rng("blind", "warm"))  # the cell's own shapes, once
    if run.trace:
        base._span_msm(run)
        _span_sha(run)


def request(run, i: int) -> bytes:
    base, pool = run.state["prove"], run.state["pool"]
    with run.span("synth"):
        circ = _circuit(run, pool[i % len(pool)])
    ph = base._phases(run)
    proof = base._prove(run, circ, run.rng("blind", i), ph)
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
    run.state["prove"].release(run)


def judge(run) -> dict:
    from refimpl import plonk
    from refimpl.synth import pipeline_dynamic

    pool = run.state["pool"]
    req = pool[0]
    builder, _ = pipeline_dynamic.build(req["bits"], req["n"], req["sig"], req["msg"],
                                        run.cfg["max_msg_bytes"])
    vk = plonk.verifying_key(plonk.Structure(builder), run.cfg["k"], run.cfg["tau"])
    rejected = 0
    for i, proof in enumerate(run.answers):
        req = pool[i % len(pool)]
        rejected += not plonk.verify(vk, proof, circuits.public_inputs(run.cfg, req),
                                     run.cfg["tau"])
    run.state["failed"] = rejected
    core.log("message lengths proved: "
             + " ".join(str(len(pool[i % len(pool)]["msg"])) for i in range(len(run.answers))))
    return {"proofs_rejected": {"value": rejected, "limit": 0}}


def failed(run) -> int:
    return run.state["failed"]

"""The traffic generator: the requests of a run, drawn from ``--seed`` and the
mix's parameters. Every seed gets the same sizes (the configuration's key
width and message length, the mix's pool); the seed picks the keys and the
messages.

A request is a dict: ``bits``, ``n``, ``sig``, ``msg`` (the message, whose
SHA-256 the circuit computes, or whose digest it is given), ``key`` (which of
the ``keys`` RSA keys signed it).
"""

from __future__ import annotations

from . import fixtures


def keys(run) -> list:
    """The mix's ``keys`` RSA keys (n, d) of the configuration's width."""
    if "keys" not in run.state:
        bits = run.cfg["bits"]
        run.state["keys"] = [fixtures.keypair(bits, run.rng("key", j))
                             for j in range(run.traffic["keys"])]
    return run.state["keys"]


def requests(run, start: int, count: int) -> list:
    """Requests ``start`` .. ``start + count - 1``; request i is signed by key
    i mod ``keys``, over a distinct message of the configuration's length."""
    bits = run.cfg["bits"]
    ks = keys(run)
    out = []
    for i in range(start, start + count):
        n, d = ks[i % len(ks)]
        msg = run.rng("msg", i).randbytes(run.cfg["msg_bytes"])
        out.append(dict(bits=bits, n=n, sig=fixtures.sign(n, d, bits, msg), msg=msg,
                        key=i % len(ks)))
    return out

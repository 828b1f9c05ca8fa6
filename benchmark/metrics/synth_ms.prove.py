"""Milliseconds of host synthesis (``Pkcs1v15Circuit.build``) per proof, from
the benchmark's span."""

from harness import readers


def read(run):
    return readers.per_request(run, "synth", 1e3)

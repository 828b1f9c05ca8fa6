"""Seconds of the prover's round 5 per proof, from ``plonk.prove``'s own phases."""

from harness import readers


def read(run):
    return readers.per_request(run, "round5_open")

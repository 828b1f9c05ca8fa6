"""Seconds in ``msm.msm_many`` per proof, from the benchmark's synchronised span around it."""

from harness import readers


def read(run):
    return readers.per_request(run, "msm")

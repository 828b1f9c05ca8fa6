"""Milliseconds of ``WitnessProgram.host_inputs`` (the host big ops) per batch."""

from harness import readers


def read(run):
    return readers.per_request(run, "replay_host", 1e3)

"""Milliseconds of ``WitnessProgram.run`` (the device program, synchronised) per batch."""

from harness import readers


def read(run):
    return readers.per_request(run, "replay_device", 1e3)

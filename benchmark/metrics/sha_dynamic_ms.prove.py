"""Milliseconds of the SHA-256 chip's dynamic-length mode
(``Sha256Chip.digest_dynamic``) per proof, from the benchmark's span around
it: the part of synthesis that hashes the message."""

from harness import readers


def read(run):
    return readers.per_request(run, "sha_dynamic", 1e3)

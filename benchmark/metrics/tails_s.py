"""Seconds per proof in the program's span ``commit.tails``: the blinding
tails added to the commitments on the host (``plonk._add_tails``). Read with
the program's tracer on (``harness.spans.ProgramProfile``), else left out."""

from harness import spans


def read(run):
    return spans.per_request(run, lambda prof: prof.span_s("commit.tails"))

"""Seconds per proof in which an NTT (the program's span ``ntt``) was being
launched or its device work ran, each instance extended to the end of the
last device operation launched inside it. Read with the program's tracer on
(``harness.spans.ProgramProfile``), else left out."""

from harness import spans


def read(run):
    return spans.per_request(run, lambda prof: prof.span_s("ntt"))

"""Milliseconds per batch of replay's copies (the program's spans
``replay.copy_in`` and ``replay.copy_out``), each extended to the end of its
device work. Read with the program's tracer on
(``harness.spans.ProgramProfile``), else left out."""

from harness import spans


def read(run):
    ms = spans.per_request(run, lambda prof: prof.span_s("replay.copy_in", "replay.copy_out"))
    return None if ms is None else ms * 1e3

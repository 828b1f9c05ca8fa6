"""Groups the device program runs per batch (the count ``groups`` on the
program's span ``replay.run``). Read with the program's tracer on
(``harness.spans.ProgramProfile``), else left out."""

from harness import spans


def read(run):
    return spans.per_request(
        run, lambda prof: prof.program["counts"].get("replay.run", {}).get("groups"))

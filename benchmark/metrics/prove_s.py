"""Window seconds over the proofs completed in it (synthesis included)."""


def read(run):
    return run.elapsed / len(run.requests) if run.requests else None

"""Milliseconds in which an operation ran on the card per traced check
(torch.profiler)."""


def read(run):
    prof = run.profile
    return None if prof is None or prof.busy_s is None else prof.busy_s / prof.requests * 1e3

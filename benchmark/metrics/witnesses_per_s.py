"""Witnesses returned over the window's seconds."""


def read(run):
    return sum(u for _, _, u in run.requests) / run.elapsed if run.requests else None

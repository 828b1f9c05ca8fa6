"""The 95th percentile of the latency of every check in the window, in ms."""

from harness import readers


def read(run):
    q = readers.latency_quantile(run, 0.95)
    return None if q is None else q * 1e3

"""Share of the K1 family's roofline (K1, K1-pow, K1-prefix) over the traced
requests: each call's bound from ``harness.work`` over the kernels' device
time."""

from harness import readers


def read(run):
    return readers.roofline_pct(run, "k1")

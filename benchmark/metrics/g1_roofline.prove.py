"""Share of the G1 kernels' roofline (K2, K3, K3-scan, K3-splice, K4) over the traced proofs."""

from harness import readers


def read(run):
    return readers.roofline_pct(run, "g1")

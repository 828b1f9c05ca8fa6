"""The PyTorch port's entry point (``halo2_rsa_tpu_torch.entry.entry``)
and its RSA-2048 example, on the CPU.

``entry(device="cpu")`` builds the flagship (RSA-1024 PKCS#1 v1.5 +
SHA-256 of a 64 B message, from ``random.Random(7)``) and returns the
checker's forward and its witness: 0 violations, and a flipped witness bit
is caught. The example's ``main`` (RSA-2048, SHA-256 of 128 B from
``random.Random(0)``) must synthesize and pass its constraint check.
"""

import numpy as np
import torch

from halo2_rsa_tpu_torch import entry
from halo2_rsa_tpu_torch.examples import rsa_example

torch.set_num_threads(1)


def test_entry_forward_has_no_violations_and_catches_a_flip():
    fn, (w,) = entry.entry(device="cpu")
    assert w.device.type == "cpu" and w.shape[1] == 8
    assert int(fn(w)) == 0
    bad = w.clone()
    bad[np.random.default_rng(0).integers(1, w.shape[0]), 0] ^= 1
    assert int(fn(bad)) > 0


def test_example_check_passes_on_the_cpu(capsys):
    rsa_example.main([], device="cpu")
    out = capsys.readouterr().out
    assert "'ok': True" in out and out.rstrip().endswith("OK")

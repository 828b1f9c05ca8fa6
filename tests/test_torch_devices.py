"""The port's entry points run on the card unless the caller asks for the
CPU: called without ``device`` on a host with no card, each raises instead
of returning CPU tensors (``plonk.verify`` too, rather than rejecting the
proof). With a card these calls would work, so the test skips there."""

import pytest
import torch

from halo2_rsa_tpu_torch import convert
from halo2_rsa_tpu_torch.fields import ALL_FIELDS, vecfield
from halo2_rsa_tpu_torch.prover import curve, g1_vec, kzg, msm, plonk


class _RefSRS:
    """The attributes of the JAX package's SRS that ``convert.srs`` reads."""

    def __init__(self):
        import numpy as np

        self.n = 1
        self.g1_powers = tuple(np.zeros((1, 16), np.uint32) for _ in range(3))
        self.g2_gen = curve.G2_GEN
        self.g2_tau = curve.G2_GEN


ENTRY_POINTS = {
    "kzg.setup": lambda: kzg.setup(4, tau=5),
    "kzg.fixed_base_mul_batch": lambda: kzg.fixed_base_mul_batch([1, 2]),
    "plonk.verify": lambda: plonk.verify(None, b"", []),
    "msm.run_msm": lambda: msm.run_msm([1, 2], [curve.G1_GEN, curve.G1_GEN]),
    "msm.run_msm_async": lambda: msm.run_msm_async([1, 2], [curve.G1_GEN, curve.G1_GEN]),
    "convert.srs": lambda: convert.srs(_RefSRS()),
    "convert.limbs": lambda: convert.limbs(_RefSRS().g1_powers[0]),
    "vecfield.from_ints": lambda: vecfield.from_ints(vecfield.consts(ALL_FIELDS[0]), [1, 2]),
    "vecfield.pow_series": lambda: vecfield.pow_series(vecfield.consts(ALL_FIELDS[0]), 3, 4),
    "g1_vec.identity": lambda: g1_vec.identity((2,)),
    "g1_vec.points_to_device": lambda: g1_vec.points_to_device([curve.G1_GEN, None]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_device_needs_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    # CPU-only torch raises AssertionError, CUDA torch without a card RuntimeError
    with pytest.raises((AssertionError, RuntimeError)):
        ENTRY_POINTS[name]()

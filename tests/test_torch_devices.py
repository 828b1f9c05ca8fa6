"""The port's entry points run on the card unless the caller asks for the
CPU: called without ``device`` on a host with no card, each raises instead
of returning CPU tensors (``plonk.verify`` too, rather than rejecting the
proof). With a card these calls would work, so the test skips there."""

import tempfile

import pytest
import torch
import torch.distributed as dist

from halo2_rsa_tpu_torch import convert, entry, golden
from halo2_rsa_tpu_torch.circuit import Builder, checker
from halo2_rsa_tpu_torch.examples import rsa_example
from halo2_rsa_tpu_torch.fields import ALL_FIELDS, vecfield
from halo2_rsa_tpu_torch.parallel import MeshKernels, launch, make_mesh, ranks
from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit
from halo2_rsa_tpu_torch.prover import curve, g1_vec, kzg, msm, plonk
from halo2_rsa_tpu_torch.utils import serialization
from halo2_rsa_tpu_torch.witness import WitnessProgram


class _RefSRS:
    """The attributes of the JAX package's SRS that ``convert.srs`` reads."""

    def __init__(self):
        import numpy as np

        self.n = 1
        self.g1_powers = tuple(np.zeros((1, 16), np.uint32) for _ in range(3))
        self.g2_gen = curve.G2_GEN
        self.g2_tau = curve.G2_GEN


def _arith():
    b, pubs = golden.build_circuit("arith_k5")
    return b, pubs, checker.compile_circuit(b), checker.witness_limbs(b)


def _load_or_keygen():
    with tempfile.TemporaryDirectory() as d:
        serialization.load_or_keygen(_arith()[2], 5, d)


def _replay():
    b = Builder(ALL_FIELDS[0])
    x = b.new_cell(0, ("in",))
    WitnessProgram(b).generate([{x.idx: 1}])


def _mesh_kernels():
    """MeshKernels over a default mesh, in a world of one (this process's
    gloo group, torn down after)."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", world_size=1, rank=0)
        try:
            MeshKernels(make_mesh())
        finally:
            dist.destroy_process_group()


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
    "checker.check": lambda: checker.check(*_arith()[2:]),
    "checker.run": lambda: checker.run(_arith()[0]),
    "checker.failing_gates": lambda: checker.failing_gates(*_arith()[2:]),
    "checker.explain": lambda: checker.explain(_arith()[0]),
    "Pkcs1v15Circuit.check": lambda: Pkcs1v15Circuit(*_arith()[:2], bits=0).check(),
    "serialization.load_or_keygen": _load_or_keygen,
    "WitnessProgram.generate": _replay,
    "parallel.MeshKernels": _mesh_kernels,
    "parallel.spawn": lambda: launch.spawn(ranks.stall, 1, "gloo", timeout=60, args=(-1, "raise")),
    "entry.entry": entry.entry,
    "entry.dryrun_multichip": lambda: entry.dryrun_multichip(2, "gloo"),
    "examples.rsa_example.main": lambda: rsa_example.main([]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_device_needs_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    # CPU-only torch raises AssertionError, CUDA torch without a card RuntimeError
    with pytest.raises((AssertionError, RuntimeError)):
        ENTRY_POINTS[name]()

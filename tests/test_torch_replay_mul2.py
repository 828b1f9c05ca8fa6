"""Batched witness replay of the ``mul2`` group — ``main_gate.mul2_add``,
out = a·b + c·d in one row — in the PyTorch port, on the CPU.

Only the SHA-256 chip emits ``mul2_add`` in the circuits of the repo
(``sha256/chip.py``'s maj), so its replay group ran in no other test. Two
circuits reach it:

* a ``MainGate`` circuit of chained ``mul2_add`` rows (a second level reads
  the first's output) over values at the field's and the limbs' edges:
  ``WitnessProgram.generate`` must equal synthesis and the JAX package's
  ``generate`` bit for bit;
* the SHA-256 chip over one block (an 8-byte message), three messages:
  the port's replay must equal synthesis and pass the checker. The JAX
  package's CPU replay of that circuit takes more than fifteen minutes, so
  its comparison is in the slow tier.
"""

import collections
import random

import numpy as np
import pytest
import torch

from halo2_rsa_tpu.circuit import Builder as JBuilder
from halo2_rsa_tpu.circuit import MainGate as JMainGate
from halo2_rsa_tpu.fields import BN254_FR as J_BN254_FR
from halo2_rsa_tpu.sha256 import Sha256Chip as JSha256Chip
from halo2_rsa_tpu.witness import WitnessProgram as JWitnessProgram
from halo2_rsa_tpu_torch.circuit import Builder, MainGate, checker
from halo2_rsa_tpu_torch.fields import BN254_FR, vecfield
from halo2_rsa_tpu_torch.sha256 import Sha256Chip
from halo2_rsa_tpu_torch.witness import WitnessProgram

torch.set_num_threads(1)

PORT = dict(Builder=Builder, MainGate=MainGate, Sha256Chip=Sha256Chip, field=BN254_FR)
JAX = dict(Builder=JBuilder, MainGate=JMainGate, Sha256Chip=JSha256Chip, field=J_BN254_FR)
P = BN254_FR.p
MUL2_VALUES = [
    (0, 0, 0, 0),
    (1, 2, 3, 4),
    (P - 1, P - 1, P - 2, 5),
    ((1 << 31) | 7, (1 << 63) | 1, (1 << 253) + 3, P - (1 << 32)),
    (random.Random(1).randrange(P), random.Random(2).randrange(P),
     random.Random(3).randrange(P), random.Random(4).randrange(P)),
]


def _mul2_circuit(pkg, vals):
    b = pkg["Builder"](pkg["field"])
    mg = pkg["MainGate"](b)
    x = [mg.assign_value(v) for v in vals]
    first = mg.mul2_add(*x)
    mg.mul2_add(first, x[0], x[3], first)
    return b


def _sha_block(pkg, seed):
    b = pkg["Builder"](pkg["field"])
    pkg["Sha256Chip"](b).digest(bytes(random.Random(seed).randrange(256) for _ in range(8)))
    return b


def _instances(template, builders):
    return [{i: b.values[i] for i in template.input_cells()} for b in builders]


def _kinds(template):
    return collections.Counter(g.kind for g in WitnessProgram(template).groups)


def test_mul2_rows_replay_to_synthesis_and_jax():
    tbs = [_mul2_circuit(PORT, v) for v in MUL2_VALUES]
    jbs = [_mul2_circuit(JAX, v) for v in MUL2_VALUES]
    assert _kinds(tbs[0])["mul2"] == 2
    got = WitnessProgram(tbs[0]).generate(_instances(tbs[0], tbs), device="cpu")
    for i, b in enumerate(tbs):
        assert np.array_equal(got[i], checker.witness_limbs(b)), MUL2_VALUES[i]
    want = np.asarray(JWitnessProgram(jbs[0]).generate(_instances(jbs[0], jbs)))
    assert np.array_equal(vecfield.limbs_to_ref(got), want)


@pytest.fixture(scope="module")
def sha():
    builders = [_sha_block(PORT, s) for s in range(3)]
    w = WitnessProgram(builders[0]).generate(_instances(builders[0], builders), device="cpu")
    return builders, w


def test_sha256_block_reaches_the_mul2_group(sha):
    builders, _ = sha
    assert _kinds(builders[0])["mul2"] == 64  # one maj row per bit per round


@pytest.mark.parametrize("inst", range(3))
def test_sha256_block_replay_equals_synthesis(sha, inst):
    builders, w = sha
    assert np.array_equal(w[inst], checker.witness_limbs(builders[inst]))
    assert checker.check(checker.compile_circuit(builders[0]), w[inst], device="cpu")["ok"]


@pytest.mark.slow
def test_sha256_block_replay_equals_jax(sha):
    _, w = sha
    jbs = [_sha_block(JAX, s) for s in range(3)]
    want = np.asarray(JWitnessProgram(jbs[0]).generate(_instances(jbs[0], jbs)))
    assert np.array_equal(vecfield.limbs_to_ref(w), want)

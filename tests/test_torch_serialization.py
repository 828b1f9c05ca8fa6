"""The PyTorch port's key artifacts against the JAX package's, on the CPU.

Both packages write one file format (npz in the reference's (..., 16)
uint32 limb layout, the vk as JSON, snarkjs ``.ptau``), under the same file
names and circuit fingerprints, so each loads the other's keys:

- the fingerprints agree for the same circuits, SHA-enabled ones included;
- the JAX package writes the SRS, pk and vk of the arith k=5 golden case;
  the port loads them into the same tensors ``convert`` makes from the JAX
  objects, and its prove from them gives the golden proof bytes;
- the port writes its own keys of the same case; the JAX package loads equal
  arrays, and finds them through its own ``load_or_keygen``;
- ``.ptau`` files written by either load in the other;
- ``load_or_keygen`` generates once, then loads the same keys.
"""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from halo2_rsa_tpu import pipelines as jpipe
from halo2_rsa_tpu.bigint import BigIntChip as JBigIntChip
from halo2_rsa_tpu.circuit import Builder as JBuilder
from halo2_rsa_tpu.circuit import MainGate as JMainGate
from halo2_rsa_tpu.circuit import RangeChip as JRangeChip
from halo2_rsa_tpu.circuit import checker as jchecker
from halo2_rsa_tpu.fields.field import BN254_FR as JBN254_FR
from halo2_rsa_tpu.prover import kzg as jkzg
from halo2_rsa_tpu.prover import plonk as jplonk
from halo2_rsa_tpu.utils import serialization as jser
from halo2_rsa_tpu_torch import convert, golden
from halo2_rsa_tpu_torch import pipelines as tpipe
from halo2_rsa_tpu_torch.circuit import checker
from halo2_rsa_tpu_torch.fields import vecfield
from halo2_rsa_tpu_torch.prover import kzg, plonk
from halo2_rsa_tpu_torch.utils import serialization as ser

torch.set_num_threads(1)

JAX_CLASSES = dict(Builder=JBuilder, MainGate=JMainGate, RangeChip=JRangeChip,
                   BigIntChip=JBigIntChip, field=JBN254_FR)
PK_TENSORS = ("id_vals", "sigma_vals", "table_vals", "fixed_polys", "sigma_polys",
              "table_polys", "fixed_ext", "sigma_ext", "table_ext", "l0_ext", "x_ext",
              "van_inv")


@pytest.mark.parametrize("name", list(golden.CASES) + ["rsa1024", "rsa1024_sha64"])
def test_fingerprints_match_reference(name):
    if name in golden.CASES:
        tc = checker.compile_circuit(golden.build_circuit(name)[0])
        jc = jchecker.compile_circuit(golden.build_circuit(name, JAX_CLASSES)[0])
    else:  # keygen's witness-free shapes
        msg_len = 64 if name.endswith("sha64") else None
        tc = tpipe.Pkcs1v15Circuit.without_witness(1024, msg_len).compile()
        jc = jpipe.Pkcs1v15Circuit.without_witness(1024, msg_len).compile()
    # every hashed array but the coefficient table has one dtype and layout
    for key in ("gate_idx", "gate_coef_id", "instance_idx"):
        assert getattr(tc, key).dtype == getattr(jc, key).dtype, key
    assert [(b, i.dtype) for b, i in tc.lookup_groups] == [(b, i.dtype) for b, i in jc.lookup_groups]
    assert ser.circuit_fingerprint(tc) == jser.circuit_fingerprint(jc)


def _assert_srs_equal(got: kzg.SRS, want: kzg.SRS):
    assert got.n == want.n and got.g2_gen == want.g2_gen and got.g2_tau == want.g2_tau
    for g, w in zip(got.g1_powers, want.g1_powers):
        assert torch.equal(g, w)


def _assert_pk_equal(got: plonk.ProvingKey, want: plonk.ProvingKey):
    assert dataclasses.asdict(got.vk) == dataclasses.asdict(want.vk)
    assert np.array_equal(got.wire_source, want.wire_source)
    assert got.k_cosets == want.k_cosets and got.log_ext == want.log_ext
    assert got.g1_tail == want.g1_tail
    for key in PK_TENSORS:
        g, w = getattr(got, key), getattr(want, key)
        assert (g is None and w is None) or torch.equal(g, w), key
    _assert_srs_equal(got.srs, want.srs)


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The arith k=5 golden case's SRS, pk and vk, made and written by the
    JAX package."""
    meta, want = golden.load("arith_k5")
    b, pubs = golden.build_circuit("arith_k5", JAX_CLASSES)
    srs = jkzg.setup(meta["srs_n"], tau=meta["tau"])
    pk, vk = jplonk.keygen(jchecker.compile_circuit(b), srs, k=meta["k"])
    d = tmp_path_factory.mktemp("jax_keys")
    jser.save_srs(srs, str(d / "srs"))
    jser.save_pk(pk, str(d / "pk"))
    jser.save_vk(vk, str(d / "vk.json"))
    return dict(dir=d, srs=srs, pk=pk, vk=vk, meta=meta, want=want)


@pytest.fixture(scope="module")
def port_loaded(jax_keys):
    d = jax_keys["dir"]
    srs = ser.load_srs(str(d / "srs"), device="cpu")
    return srs, ser.load_pk(str(d / "pk.npz"), srs), ser.load_vk(str(d / "vk.json"))


def test_port_loads_reference_keys(jax_keys, port_loaded):
    srs, pk, vk = port_loaded
    _assert_srs_equal(srs, convert.srs(jax_keys["srs"], device="cpu"))
    _assert_pk_equal(pk, convert.proving_key(jax_keys["pk"], device="cpu"))
    assert dataclasses.asdict(vk) == dataclasses.asdict(convert.verifying_key(jax_keys["vk"]))


def test_port_proves_golden_bytes_from_reference_keys(jax_keys, port_loaded):
    _, pk, vk = port_loaded
    b, pubs = golden.build_circuit("arith_k5")
    proof = plonk.prove(pk, b.values, pubs, rng=random.Random(jax_keys["meta"]["seed"]))
    assert proof == jax_keys["want"]
    assert plonk.verify(vk, proof, pubs, device="cpu")


@pytest.fixture(scope="module")
def port_keys(tmp_path_factory):
    """The same case's keys made and written by the port, under the file
    names ``load_or_keygen`` uses."""
    meta, _ = golden.load("arith_k5")
    b, _ = golden.build_circuit("arith_k5")
    compiled = checker.compile_circuit(b)
    srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device="cpu")
    pk, vk = plonk.keygen(compiled, srs, k=meta["k"])
    d = tmp_path_factory.mktemp("port_keys")
    base = str(d / f"{ser.circuit_fingerprint(compiled)}_k{meta['k']}")
    ser.save_srs(srs, str(d / f"srs_k{meta['k']}_t{meta['tau']}"))
    ser.save_pk(pk, base + "_pk")
    ser.save_vk(vk, base + "_vk.json")
    return dict(dir=d, base=base, srs=srs, pk=pk, vk=vk, meta=meta)


def test_reference_loads_port_keys(port_keys):
    d, base, meta = port_keys["dir"], port_keys["base"], port_keys["meta"]
    jsrs = jser.load_srs(str(d / f"srs_k{meta['k']}_t{meta['tau']}"))
    jpk = jser.load_pk(base + "_pk.npz", jsrs)
    for g, w in zip(jsrs.g1_powers, port_keys["srs"].g1_powers):
        assert np.array_equal(np.asarray(g), vecfield.limbs_to_ref(w))
    pk = port_keys["pk"]
    for key in PK_TENSORS:
        g, w = getattr(jpk, key), getattr(pk, key)
        assert (g is None and w is None) or np.array_equal(
            np.asarray(g), vecfield.limbs_to_ref(w)), key
    assert np.array_equal(np.asarray(jpk.wire_source), pk.wire_source)
    assert dataclasses.asdict(convert.verifying_key(jser.load_vk(base + "_vk.json"))) == \
        dataclasses.asdict(port_keys["vk"])
    # the JAX package's own load_or_keygen finds the port's files
    jb, _ = golden.build_circuit("arith_k5", JAX_CLASSES)
    *_, loaded = jser.load_or_keygen(jchecker.compile_circuit(jb), meta["k"], str(d),
                                     tau=meta["tau"])
    assert loaded


def test_port_keys_round_trip(port_keys):
    d, base = port_keys["dir"], port_keys["base"]
    srs = ser.load_srs(str(d / "srs_k{k}_t{tau}.npz".format(**port_keys["meta"])), device="cpu")
    _assert_pk_equal(ser.load_pk(base + "_pk", srs), port_keys["pk"])
    vk = ser.load_vk(base + "_vk.json")
    assert dataclasses.asdict(vk) == dataclasses.asdict(port_keys["vk"])


def test_ptau_both_ways(jax_keys, port_keys, tmp_path):
    jpath, tpath = str(tmp_path / "jax.ptau"), str(tmp_path / "port.ptau")
    jser.save_srs_ptau(jax_keys["srs"], jpath, power=7)
    ser.save_srs_ptau(port_keys["srs"], tpath, power=7)
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert fj.read() == ft.read()  # the same SRS (same tau) in one format
    n = jax_keys["meta"]["srs_n"]
    _assert_srs_equal(ser.load_srs_ptau(jpath, n, device="cpu"),
                      convert.srs(jax_keys["srs"], device="cpu"))
    jsrs = jser.load_srs_ptau(tpath, n)
    for g, w in zip(jsrs.g1_powers, port_keys["srs"].g1_powers):
        assert np.array_equal(np.asarray(g), vecfield.limbs_to_ref(w))
    assert (jsrs.g2_gen, jsrs.g2_tau) == (port_keys["srs"].g2_gen, port_keys["srs"].g2_tau)


def test_load_or_keygen_generates_then_loads(tmp_path):
    b, _ = golden.build_circuit("arith_k5")
    compiled = checker.compile_circuit(b)
    srs, pk, vk, loaded = ser.load_or_keygen(compiled, 5, str(tmp_path), tau=4242, device="cpu")
    assert not loaded
    srs2, pk2, vk2, loaded = ser.load_or_keygen(compiled, 5, str(tmp_path), tau=4242,
                                                device="cpu")
    assert loaded
    _assert_pk_equal(pk2, pk)
    _assert_srs_equal(srs2, srs)
    assert dataclasses.asdict(vk2) == dataclasses.asdict(vk)
    fp = ser.circuit_fingerprint(compiled)
    assert sorted(os.listdir(tmp_path)) == [f"{fp}_k5_pk.npz", "srs_k5_t4242.npz"]

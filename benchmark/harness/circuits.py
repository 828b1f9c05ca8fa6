"""A configuration's circuit for one request, synthesised by the program (the
system under test) or by the reference's frozen copy; its size checked
against the configuration file; its keys."""

from __future__ import annotations

import hashlib
import os

import numpy as np


def _digest(msg: bytes) -> int:
    return int.from_bytes(hashlib.sha256(msg).digest(), "big")


def program_circuit(cfg: dict, req: dict):
    """The program's ``Pkcs1v15Circuit`` of one request."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit

    if cfg["sha_in_circuit"]:
        return Pkcs1v15Circuit.build(req["bits"], req["n"], req["sig"], msg=req["msg"])
    return Pkcs1v15Circuit.build(req["bits"], req["n"], req["sig"], hashed_msg=_digest(req["msg"]))


def reference_circuit(cfg: dict, req: dict) -> tuple:
    """(builder, public inputs) of one request from the frozen synthesis."""
    from refimpl.synth import pipeline

    if cfg["sha_in_circuit"]:
        return pipeline.build(req["bits"], req["n"], req["sig"], msg=req["msg"])
    return pipeline.build(req["bits"], req["n"], req["sig"], hashed_msg=_digest(req["msg"]))


def public_inputs(cfg: dict, req: dict) -> list:
    from refimpl.synth import pipeline

    return pipeline.public_inputs(req["bits"], req["n"], req["msg"], cfg["sha_in_circuit"])


def k_of(gates: int, instances: int, cells: int) -> int:
    """The domain's log2: the rows of gates and public inputs, and a fifth of
    the witness cells (``scripts/time_torch_flagship.py``'s rule)."""
    return max(gates + instances, cells // 5 + 1).bit_length()


def check_size(cfg: dict, builder) -> None:
    """The configuration's gates, witness cells and k, as its file states them."""
    got = dict(gates=len(builder.gate_idx), witness_cells=len(builder.values),
               k=k_of(len(builder.gate_idx), len(builder.instance), len(builder.values)))
    want = {key: cfg[key] for key in got}
    if got != want:
        raise AssertionError(f"the circuit is {got}, the configuration states {want}")


def keys(run, compiled):
    """(srs, pk, vk, loaded) through the program's ``load_or_keygen``, saved
    under ``.keys/bench/<config>`` in the checkout: the first run of a cell
    makes and saves them, later runs load them."""
    from halo2_rsa_tpu_torch.utils import serialization

    checkout = os.path.dirname(run.root)
    keys_dir = os.path.join(checkout, ".keys", "bench", run.cell["config"])
    return serialization.load_or_keygen(compiled, run.cfg["k"], keys_dir, tau=run.cfg["tau"],
                                        device=run.device)


def limbs(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> (len, 8) int32, little-endian 32-bit limbs
    (the program's witness layout)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, 8).view(np.int32).copy()

"""The multi-rank path over NCCL with one GPU per rank, and its warm proves
beside the single device's.

On a host with at least four GPUs: ``entry.dryrun_multichip(4, "nccl")``;
the k=10 golden proof on 2 NCCL ranks (round 3 moves rows between the
ranks there: 2^13 has an odd log2); then the flagship (RSA-1024 PKCS#1
v1.5, SHA disabled, k=15, ``chip_smoke.py``'s) keyed and proven once on
``cuda:0`` in this process (1 cold + 3 warm), its keys saved and proven
by 1, 2 and 4 NCCL ranks and by 2 gloo ranks on two GPUs (1 cold + 3 warm
each, ``random.Random(41)``), every rank's proof equal to the single
device's. Prints one line per run and, last, one JSON object.

Usage: python3 -m halo2_rsa_tpu_torch.parallel.scaling
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import subprocess
import tempfile
import time

import torch

from .. import entry, golden
from ..circuit import checker
from ..pipelines import Pkcs1v15Circuit, sign_fixture
from ..prover import kzg, plonk
from ..utils import serialization as ser
from . import launch, ranks

SEED = 41
WARM = 3
RUNS = (("nccl", 1), ("nccl", 2), ("nccl", 4), ("gloo", 2))


def flagship() -> tuple:
    """chip_smoke.py's flagship: a 32 B message and a key from
    random.Random(7), SHA disabled: (circuit, compiled, k)."""
    msg = bytes(random.Random(7).randrange(256) for _ in range(32))
    n, sig = sign_fixture(1024, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    circ = Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed)
    compiled = circ.compile()
    return circ, compiled, max(compiled.num_gates + 20, compiled.num_witness // 5 + 1).bit_length()


def main() -> dict:
    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"needs 4 GPUs, found {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"smi": smi.splitlines()}
    t = time.perf_counter()
    out["dryrun_nccl4"] = dict(entry.dryrun_multichip(4, "nccl"), seconds=time.perf_counter() - t)
    if out["dryrun_nccl4"]["skipped"]:
        raise AssertionError(f"the dry run skipped {out['dryrun_nccl4']['skipped']}")
    print("dryrun_multichip(4, 'nccl'):", out["dryrun_nccl4"], flush=True)

    _, want = golden.load("mulmod_k10")
    res = launch.spawn(ranks.prove_golden, 2, "nccl", timeout=300, args=(["mulmod_k10"],))
    out["mulmod_k10_nccl2"] = [r["mulmod_k10"]["collectives"] for r in res]
    if not all(r["mulmod_k10"]["proof"] == want and r["mulmod_k10"]["verified"] for r in res):
        raise AssertionError("the k=10 golden proof on 2 NCCL ranks differs or does not verify")
    print("k=10 golden proof on 2 NCCL ranks: equal, verified;", out["mulmod_k10_nccl2"][0],
          flush=True)

    circ, compiled, k = flagship()
    srs = kzg.setup((1 << k) + plonk.BLIND, tau=777, device="cuda")
    pk, vk = plonk.keygen(compiled, srs, k=k)
    times = []
    for _ in range(1 + WARM):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = plonk.prove(pk, circ.builder.values, circ.public_inputs, rng=random.Random(SEED))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    sha = hashlib.sha256(proof).hexdigest()
    out["single"] = dict(sha256=sha, cold_s=times[0], warm_s=times[1:])
    print(f"single device: {sha}, cold {times[0]:.3f} s, warm {times[1:]}", flush=True)

    d = tempfile.mkdtemp(prefix="h2r_scaling_")
    try:
        paths = {"srs": os.path.join(d, "srs.npz"), "pk": os.path.join(d, "pk.npz"),
                 "vk": os.path.join(d, "vk.json")}
        ser.save_srs(srs, paths["srs"])
        ser.save_pk(pk, paths["pk"])
        ser.save_vk(vk, paths["vk"])
        witness = checker.witness_limbs(circ.builder)
        for backend, world in RUNS:
            res = launch.spawn(ranks.prove_from_keys, world, backend, timeout=300,
                               args=(paths, witness, circ.public_inputs, SEED, WARM))
            rows = [{key: v for key, v in r.items() if key != "proof"} for r in res]
            out[f"{backend}x{world}"] = rows
            for rank, r in enumerate(rows):
                if r["sha256"] != sha or not (r["verified"] and r["wrong_pub_rejected"]):
                    raise AssertionError(f"{backend} x{world} rank {rank}: {r['sha256']}")
                print(f"{backend} x{world} rank {rank}: same bytes, cold {r['cold_s']:.3f} s, "
                      f"warm {r['warm_s']}, launches {r['launches']}, collectives "
                      f"{r['collectives']}", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()

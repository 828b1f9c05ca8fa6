#!/usr/bin/env python3
"""Where a warm flagship prove of the PyTorch port spends its time on the card.

Builds the RSA-1024 SHA-disabled circuit (k=15), keys it on CUDA, proves
once to warm up, then profiles one warm prove with ``torch.profiler``
(CPU + CUDA activities) and writes:

* chiprun_out/profile_prove.json — device busy/idle share, kernel time by
  name (top 25), the four hand-written kernels' totals, per-round Phases,
  and the per-layer times: one MSM of 2^15 affine SRS points and one NTT
  of 2^18 elements (mean of 5 after a warm-up, host clock around
  ``torch.cuda.synchronize``).

Usage: python3 scripts/profile_torch_prove.py   (needs one CUDA card)
"""

import hashlib
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _layer_times(srs, device, reps: int = 5) -> dict:
    import numpy as np
    import torch

    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.prover import msm, ntt

    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 32, size=(1 << 18, 8), dtype=np.uint64)
    limbs[:, 7] &= 0x0FFFFFFF  # < 2^252 < r: canonical without a reduction
    vals = torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(device)
    fr = ntt.FR
    scalars = vals[None, : 1 << 15]
    pts = tuple(c[: 1 << 15] for c in srs.g1_powers)
    poly = vecfield.to_mont(fr, vals)[None]

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    return dict(
        msm_2p15_s=timed(lambda: msm.msm_many(scalars, pts, z_one=True)),
        ntt_2p18_s=timed(lambda: ntt.ntt_batch(poly, 18)),
    )


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture
    from halo2_rsa_tpu_torch.prover import kzg, plonk
    from halo2_rsa_tpu_torch.utils.profiling import Phases

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_prove: no CUDA device")
    msg = bytes(random.Random(7).randrange(256) for _ in range(32))
    n, sig = sign_fixture(1024, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    circ = Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed)
    compiled = circ.compile()
    k = max(compiled.num_gates + 20, compiled.num_witness // 5 + 1).bit_length()
    srs = kzg.setup((1 << k) + plonk.BLIND, tau=777, device="cuda")
    pk, vk = plonk.keygen(compiled, srs, k=k)
    plonk.prove(pk, circ.builder.values, circ.public_inputs)  # warm-up
    torch.cuda.synchronize()

    ph = Phases()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proof = plonk.prove(pk, circ.builder.values, circ.public_inputs, phases=ph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert plonk.verify(vk, proof, circ.public_inputs, device="cuda")

    rows = []  # device kernels only (operator rows would count their kernels twice)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    ours = {key: [0.0, 0] for key in ("h2r_mont_mul", "h2r_g1_add_mixed", "h2r_g1_add", "h2r_g1_double")}
    for name, us, cnt in rows:
        for key in ours:
            if name.startswith(key + "_kernel"):
                ours[key][0] += us
                ours[key][1] += cnt
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    report = dict(
        card=smi,
        prove_wall_s=wall,
        device_busy_s=device_us / 1e6,
        device_busy_share=device_us / 1e6 / wall,
        kernels_launched=sum(r[2] for r in rows),
        hand_written={k_: dict(device_s=v[0] / 1e6, launches=v[1]) for k_, v in ours.items()},
        top=[dict(name=r[0][:120], device_s=r[1] / 1e6, count=r[2]) for r in rows[:25]],
        phases_s=ph.times,
        layers=_layer_times(srs, "cuda"),
    )
    with open(os.path.join(out_dir, "profile_prove.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k_: report[k_] for k_ in ("card", "prove_wall_s", "device_busy_s",
                                                "device_busy_share", "kernels_launched")}))
    print(json.dumps(report["hand_written"]))
    print(json.dumps(report["layers"]))
    for r in report["top"][:15]:
        print(f"{r['device_s'] * 1e3:10.2f} ms {r['count']:7d}  {r['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Card gate of the PyTorch/CUDA port: drives halo2_rsa_tpu_torch's main
path on one NVIDIA GPU and checks it.

Phases (each prints one line before the next starts; any failure raises and
the script exits non-zero without its final line):

1. device and toolchain (torch/CUDA/nvcc/Triton versions, nvidia-smi);
2. build K1-K4 from halo2_rsa_tpu_torch/csrc with nvcc (sm_90a);
3. kernel parity on the card: each kernel against its plain torch version
   (K1 at 2^20 products over four fields, K2-K4 at 2^16 points with the
   identity, P+P and P+(-P)), all compared bitwise, with both times;
4. the committed JAX-made golden proofs reproduced byte for byte;
5. the flagship: RSA-1024 PKCS#1 v1.5, SHA disabled, k=15 — build, compile,
   setup, keygen, one cold and five warm proves, verify;
6. launch counts of K1-K4 during the flagship (all must be > 0).

Then it prints the kernels' JSON line, the card's name and power limit, and
as its last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py   (needs one CUDA card and nvcc)
"""

import hashlib
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
WARM_PROVES = 5


def line(msg: str) -> None:
    print(msg, flush=True)


def _cmd(args) -> str:
    try:
        return subprocess.run(args, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _time_cuda(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after a warm-up (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, want) -> int:
    """Largest absolute limb difference between two limb tensors/tuples."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF)
        err = max(err, int(d.abs().max().item()))
    return err


def phase_device(report):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    from halo2_rsa_tpu_torch.utils import cuda_build

    nvcc = _cmd([cuda_build.nvcc_path(), "--version"]).splitlines()
    smi = _cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    report["device"] = dict(
        python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc[-1] if nvcc else "", triton=triton_v, smi=smi,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )
    line(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} | "
         f"nvcc: {report['device']['nvcc']} | triton {triton_v} | {smi}")


def phase_build(report):
    from halo2_rsa_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.build(verbose=True)
    cuda_build.library()
    dt = time.perf_counter() - t0
    report["build"] = dict(seconds=dt, library=os.path.relpath(path, HERE))
    line(f"[2 build] K1-K4 built for sm_90a in {dt:.2f} s -> {report['build']['library']}")


def _parity_k1(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.fields import ALL_FIELDS, cuda_mont, vecfield

    n = 1 << 20
    rng = random.Random(11)
    worst = 0
    for field in ALL_FIELDS:
        fc = vecfield.consts(field)
        p = field.p
        edge = [0, 1, p - 1]
        xs = edge * 3 + [rng.randrange(p) for _ in range(n - 9)]
        ys = [e for e in edge for _ in range(3)] + [rng.randrange(p) for _ in range(n - 9)]
        a = vecfield.from_ints(fc, xs, mont=False, device="cuda")
        b = vecfield.from_ints(fc, ys, mont=False, device="cuda")
        got = cuda_mont.mont_mul(fc, a, b)
        want = cuda_mont.mont_mul_plain(fc, a, b)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        host = vecfield.to_ints(fc, got[:16], mont=False)
        rinv = pow(1 << 256, -1, p)
        assert host == [x * y * rinv % p for x, y in zip(xs[:16], ys[:16])], field.name
        if err:
            raise AssertionError(f"K1 differs from its plain version over {field.name}: {err}")
        worst = max(worst, err)
        if field.name == "bn254_fr":
            ms = _time_cuda(lambda: cuda_mont.mont_mul(fc, a, b), 50)
            plain_ms = _time_cuda(lambda: cuda_mont.mont_mul_plain(fc, a, b), 3)
    kernels["K1"] = dict(
        name="mont_mul", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms, shape=f"{n} products",
    )
    line(f"[3 parity] K1 mont_mul: 2^20 x 4 fields bitwise equal | kernel {ms:.4f} ms, "
         f"plain {plain_ms:.3f} ms (bn254_fr, 2^20)")


def _test_points(n: int, device):
    """n projective points (X Z, Y Z, Z) over 256 affine curve points with
    random Z; returns (the affine points, their (x, y) tensors, the
    projective tensors)."""
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.prover import curve, g1_vec

    rng = random.Random(12)
    base = [curve.g1_mul(curve.G1_GEN, rng.randrange(1, curve.R)) for _ in range(256)]
    aff = [base[i % 256] for i in range(n)]
    ax, ay, _ = g1_vec.points_to_device(aff, device=device)
    z = vecfield.from_ints(g1_vec.FQ, [rng.randrange(1, curve.Q) for _ in range(n)], device=device)
    fq = g1_vec.FQ
    proj = (cuda_mont.mont_mul_plain(fq, ax, z), cuda_mont.mont_mul_plain(fq, ay, z), z)
    return aff, (ax, ay), proj


def _parity_g1(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.prover import cuda_g1, curve, g1_vec

    n = 1 << 16
    fq = g1_vec.FQ
    aff, affxy, p1 = _test_points(n, "cuda")
    # second operands: a shifted batch, with lanes 0-63 = P1 itself (P+P),
    # lanes 64-127 = -P1 (P+(-P)), and P1 = identity on lanes 128-191
    roll = tuple(c.roll(1, dims=0) for c in p1)
    neg = g1_vec.point_neg(p1)
    p2 = tuple(torch.cat([a[:64], b[64:128], c[128:]]) for a, b, c in zip(p1, neg, roll))
    ident = g1_vec.identity((64,), device="cuda")
    p1 = tuple(torch.cat([a[:128], i, a[192:]]) for a, i in zip(p1, ident))
    aff2 = [aff[i] for i in range(64)] + [curve.g1_neg(aff[i]) for i in range(64, 128)] + \
        [aff[(i - 1) % n] for i in range(128, n)]
    aff1 = aff[:128] + [None] * 64 + aff[192:]
    # mixed add: the affine operand is a real point on every lane
    aff2m = aff[1:] + aff[:1]
    p2m = tuple(c.roll(-1, dims=0).contiguous() for c in affxy)

    cases = {
        "K2": ("g1_add_mixed", lambda: cuda_g1.point_add_mixed(fq, p1, p2m),
               lambda: cuda_g1.point_add_mixed_plain(fq, p1, p2m),
               lambda i: curve.g1_add(aff1[i], aff2m[i]), "_point_add_mixed_kernel", 80),
        "K3": ("g1_add", lambda: cuda_g1.point_add(fq, p1, p2),
               lambda: cuda_g1.point_add_plain(fq, p1, p2),
               lambda i: curve.g1_add(aff1[i], aff2[i]), "_point_add_kernel", 43),
        "K4": ("g1_double", lambda: cuda_g1.point_double(fq, p1),
               lambda: cuda_g1.point_double_plain(fq, p1),
               lambda i: curve.g1_add(aff1[i], aff1[i]), "_point_double_kernel", 121),
    }
    for key, (name, kern, plain, host, pallas_fn, pallas_line) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"{key} {name} differs from its plain version: {err}")
        lanes = [0, 1, 64, 65, 128, 129, 200, n - 1]
        sel = tuple(c[lanes] for c in got)
        assert g1_vec.points_from_device(sel) == [host(i) for i in lanes], key
        ms = _time_cuda(kern, 50)
        plain_ms = _time_cuda(plain, 3)
        kernels[key] = dict(
            name=name, route="cuda", source="halo2_rsa_tpu_torch/csrc/g1.cu",
            replaces=f"halo2_rsa_tpu/prover/pallas_g1.py:{pallas_line}", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, shape=f"{n} points",
        )
        line(f"[3 parity] {key} {name}: 2^16 points bitwise equal (identity, P+P, P-P, "
             f"host affine) | kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")


def phase_parity(report, kernels):
    _parity_k1(report, kernels)
    _parity_g1(report, kernels)


def phase_golden(report):
    from halo2_rsa_tpu_torch import golden
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.prover import kzg, plonk

    out = {}
    for name in golden.CASES:
        meta, want = golden.load(name)
        t0 = time.perf_counter()
        b, pubs = golden.build_circuit(name)
        compiled = checker.compile_circuit(b)
        srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device="cuda")
        pk, vk = plonk.keygen(compiled, srs, k=meta["k"])
        for key in ("fixed_commitments", "sigma_commitments", "table_commitments"):
            if golden.points_to_json(getattr(vk, key)) != meta["vk"][key]:
                raise AssertionError(f"golden {name}: vk {key} differ from the JAX package's")
        proof = plonk.prove(pk, b.values, pubs, rng=random.Random(meta["seed"]))
        if proof != want:
            raise AssertionError(f"golden {name}: proof bytes differ from the JAX package's")
        assert plonk.verify(vk, proof, pubs, device="cuda")
        dt = time.perf_counter() - t0
        out[name] = dict(k=meta["k"], bytes=len(proof), seconds=dt)
        line(f"[4 golden] {name}: k={meta['k']} proof {len(proof)} B equals the JAX-made "
             f"proof byte for byte; vk equal; verify ok ({dt:.1f} s)")
    report["golden"] = out


def phase_flagship(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.fields import cuda_mont
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture
    from halo2_rsa_tpu_torch.prover import cuda_g1, kzg, plonk
    from halo2_rsa_tpu_torch.utils.profiling import Phases

    bits = 1024
    msg = bytes(random.Random(7).randrange(256) for _ in range(32))
    n, sig = sign_fixture(bits, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")

    # launch counts cover the main path only (parity launches excluded)
    for counts in (cuda_mont.LAUNCHES, cuda_g1.LAUNCHES):
        for key in counts:
            counts[key] = 0
    f = {}
    t0 = time.perf_counter()
    circ = Pkcs1v15Circuit.build(bits, n, sig, hashed_msg=hashed)
    compiled = circ.compile()
    f["build_compile_s"] = time.perf_counter() - t0
    k = max(compiled.num_gates + 20, compiled.num_witness // 5 + 1).bit_length()
    f.update(k=k, gates=int(compiled.num_gates), witness=int(compiled.num_witness))
    line(f"[5 flagship] RSA-1024 SHA-disabled: {f['gates']} gates, k={k}, "
         f"build+compile {f['build_compile_s']:.2f} s")
    assert k == 15, k

    t0 = time.perf_counter()
    srs = kzg.setup((1 << k) + plonk.BLIND, tau=777, device="cuda")
    torch.cuda.synchronize()
    f["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk, vk = plonk.keygen(compiled, srs, k=k)
    torch.cuda.synchronize()
    f["keygen_s"] = time.perf_counter() - t0
    line(f"[5 flagship] setup {f['setup_s']:.2f} s, keygen {f['keygen_s']:.2f} s")

    def timed_prove():
        ph = Phases()
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = plonk.prove(pk, circ.builder.values, circ.public_inputs, phases=ph)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t, ph

    proof, f["prove_cold_s"], ph = timed_prove()
    f["phases_cold"] = dict(ph.times)
    line(f"[5 flagship] cold prove {f['prove_cold_s']:.3f} s, {len(proof)} B")
    warm, phases = [], []
    for _ in range(WARM_PROVES):
        _, dt, ph = timed_prove()
        warm.append(dt)
        phases.append(ph.times)
    f["prove_warm_s"] = warm
    f["phases_warm_mean"] = {
        key: sum(p[key] for p in phases) / len(phases) for key in phases[0]
    }
    t0 = time.perf_counter()
    ok = plonk.verify(vk, proof, circ.public_inputs, device="cuda")
    f["verify_s"] = time.perf_counter() - t0
    bad = circ.public_inputs[:]
    bad[0] += 1
    rejected = not plonk.verify(vk, proof, bad, device="cuda")
    torch.cuda.synchronize()
    f["proof_bytes"] = len(proof)
    if not ok:
        raise AssertionError("flagship proof does not verify")
    if not rejected:
        raise AssertionError("flagship verify accepted a wrong public input")
    if len(proof) != 2272:
        raise AssertionError(f"flagship proof is {len(proof)} B, expected 2272")
    ph_txt = " ".join(f"{k_}={v:.3f}" for k_, v in f["phases_warm_mean"].items())
    line(f"[5 flagship] warm prove x{WARM_PROVES}: min {min(warm):.3f} mean "
         f"{sum(warm) / len(warm):.3f} max {max(warm):.3f} s | phases(mean s) {ph_txt} | "
         f"verify {f['verify_s']:.3f} s ok, wrong public input rejected, proof 2272 B")

    counts = {
        "K1": cuda_mont.LAUNCHES["mont_mul"],
        "K2": cuda_g1.LAUNCHES["g1_add_mixed"],
        "K3": cuda_g1.LAUNCHES["g1_add"],
        "K4": cuda_g1.LAUNCHES["g1_double"],
    }
    f["launches"] = counts
    report["flagship"] = f
    line("[6 launches] flagship path: " + ", ".join(f"{k_}={v}" for k_, v in counts.items()))
    for key, v in counts.items():
        kernels[key]["launches"] = v
        if v == 0:
            raise AssertionError(f"{key} was never launched on the flagship path")


def main() -> int:
    sys.path.insert(0, HERE)
    report: dict = {}
    kernels: dict = {}
    t_all = time.perf_counter()
    phase_device(report)
    phase_build(report)
    phase_parity(report, kernels)
    phase_golden(report)
    phase_flagship(report, kernels)
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)

    import torch

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kernels[kk][k] for k in keys} for kk in sorted(kernels)]}))
    print(report["device"]["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

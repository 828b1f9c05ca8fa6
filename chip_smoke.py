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
6. launch counts of K1-K4 during the flagship (all must be > 0), and over
   one warm prove;
7. P1, the integer op-rate probe: each of its 7 bodies at (16, 2^20), REPS
   64, bitwise against its plain version on the card, then the probe's own
   timed run (``bench.vpu_ops.run``) with its launches counted;
8. P2, K1's layouts: (b') limb-major and (d') staged through shared memory
   for each block size, bitwise against their plain versions at 2^20
   products over BN254 Fr, then the probe's timed run (``bench.mont_layout.run``,
   which also asserts every variant equal to K1) with its launches counted;
9. each kernel's bound: bytes over 3.35 TB/s against its SASS instructions
   (``cuobjdump -sass`` of the built library) over the rates derived from
   the architecture at the card's maximum SM clock: the FMA pipe's integer
   opcodes and the ALU pipe's, 64 lanes per SM each, and all instructions
   over 128 issued per SM. P1's best measured integer rate is reported
   beside it, as a reading.

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
HBM_BYTES_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
# Hopper architecture white paper, per SM per clock: 64 lanes on each of the
# FMA pipe (IMAD) and the integer ALU pipe; four schedulers of one warp
# instruction each, 128 thread-instructions in all
PIPE_LANES_PER_SM, ISSUE_PER_SM = 64, 128
P1_LOG_N, P1_REPS, P1_ITERS = 20, 64, 8
P2_LOG_N, P2_ITERS, P2_THREADS = 20, 10, 256  # P2-staged's ms and bound are at T = 256


def line(msg: str) -> None:
    print(msg, flush=True)


def _cmd(args) -> str:
    try:
        return subprocess.run(args, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


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


# kernel key -> (SASS symbol, template arguments); P1's bodies are added below
SASS_NAMES = {
    "K1": ("h2r_mont_mul_kernel", ()),
    "K2": ("h2r_g1_add_mixed_kernel", ()),
    "K3": ("h2r_g1_add_kernel", ()),
    "K4": ("h2r_g1_double_kernel", ()),
    "P2-lm": ("h2r_mont_mul_lm_kernel", ()),
    "P2-staged": ("h2r_mont_mul_staged_kernel", (P2_THREADS,)),
}


def phase_build(report):
    from halo2_rsa_tpu_torch.bench import vpu_ops
    from halo2_rsa_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.build(verbose=True)
    cuda_build.library()
    dt = time.perf_counter() - t0
    report["build"] = dict(seconds=dt, library=os.path.relpath(path, HERE))
    line(f"[2 build] K1-K4, P1, P2 built for sm_90a in {dt:.2f} s -> {report['build']['library']}")
    sass = cuda_build.sass_opcodes(path)
    names = dict(SASS_NAMES)
    for body, bid in vpu_ops.BODY_IDS.items():
        names[f"P1/{body}"] = ("h2r_int_ops_kernel", (bid, P1_REPS))
    counts = {}
    for key, (sym, targs) in names.items():
        ops = cuda_build.kernel_opcodes(sass, sym, *targs)
        counts[key] = dict(
            int=cuda_build.int_instructions(ops), total=sum(ops.values()),
            **cuda_build.pipe_counts(ops),
            branches=sum(n for op, n in ops.items() if op.startswith("BRA")),
            top=dict(ops.most_common(8)),
        )
    report["sass"] = counts
    line("[2 build] SASS integer instructions per thread: " + ", ".join(
        f"{k}={v['int']}" for k, v in counts.items()))
    for body in vpu_ops.BODIES:
        n_int = counts[f"P1/{body}"]["int"]
        if n_int < P1_REPS:
            raise AssertionError(f"P1 {body}: the compiler folded the chain ({n_int} integer "
                                 f"instructions for REPS {P1_REPS})")


def _parity_k1(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.fields import ALL_FIELDS, cuda_mont, vecfield
    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

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
            ms = chain_ms(lambda x: cuda_mont.mont_mul(fc, x, b), a, 50)
            plain_ms = chain_ms(lambda x: cuda_mont.mont_mul_plain(fc, x, b), a, 3)
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
    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

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

    # each kernel and plain version takes the first operand, so it can be
    # timed as a chain p = f(p)
    cases = {
        "K2": ("g1_add_mixed", lambda p: cuda_g1.point_add_mixed(fq, p, p2m),
               lambda p: cuda_g1.point_add_mixed_plain(fq, p, p2m),
               lambda i: curve.g1_add(aff1[i], aff2m[i]), "_point_add_mixed_kernel", 80),
        "K3": ("g1_add", lambda p: cuda_g1.point_add(fq, p, p2),
               lambda p: cuda_g1.point_add_plain(fq, p, p2),
               lambda i: curve.g1_add(aff1[i], aff2[i]), "_point_add_kernel", 43),
        "K4": ("g1_double", lambda p: cuda_g1.point_double(fq, p),
               lambda p: cuda_g1.point_double_plain(fq, p),
               lambda i: curve.g1_add(aff1[i], aff1[i]), "_point_double_kernel", 121),
    }
    for key, (name, kern, plain, host, pallas_fn, pallas_line) in cases.items():
        got = kern(p1)
        want = plain(p1)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"{key} {name} differs from its plain version: {err}")
        lanes = [0, 1, 64, 65, 128, 129, 200, n - 1]
        sel = tuple(c[lanes] for c in got)
        assert g1_vec.points_from_device(sel) == [host(i) for i in lanes], key
        ms = chain_ms(kern, p1, 50)
        plain_ms = chain_ms(plain, p1, 3)
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

    def counts_now():
        return {
            "K1": cuda_mont.LAUNCHES["mont_mul"],
            "K2": cuda_g1.LAUNCHES["g1_add_mixed"],
            "K3": cuda_g1.LAUNCHES["g1_add"],
            "K4": cuda_g1.LAUNCHES["g1_double"],
        }

    proof, f["prove_cold_s"], ph = timed_prove()
    f["phases_cold"] = dict(ph.times)
    line(f"[5 flagship] cold prove {f['prove_cold_s']:.3f} s, {len(proof)} B")
    warm, phases = [], []
    for _ in range(WARM_PROVES):
        before = counts_now()
        _, dt, ph = timed_prove()
        per_prove = {k_: v - before[k_] for k_, v in counts_now().items()}
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

    counts = counts_now()
    f["launches"] = counts
    f["launches_per_warm_prove"] = per_prove
    report["flagship"] = f
    line("[6 launches] flagship path (setup, keygen, 1 cold + 5 warm proves, 2 verifies): "
         + ", ".join(f"{k_}={v}" for k_, v in counts.items())
         + " | over one warm prove: " + ", ".join(f"{k_}={v}" for k_, v in per_prove.items()))
    for key, v in counts.items():
        kernels[key]["launches"] = v
        kernels[key]["launches_per_warm_prove"] = per_prove[key]
        if v == 0:
            raise AssertionError(f"{key} was never launched on the flagship path")


def phase_p1(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.bench import vpu_ops
    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    gen = torch.Generator(device="cuda").manual_seed(17)
    shape = (16, 1 << P1_LOG_N)
    x = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device="cuda", generator=gen)
    y = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device="cuda", generator=gen)
    worst, plain_ms = 0, {}
    for body in vpu_ops.BODIES:
        got = vpu_ops.int_ops(body, x, y, P1_REPS)
        want = vpu_ops.int_ops_plain(body, x, y, P1_REPS)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"P1 {body} differs from its plain version: {err}")
        worst = max(worst, err)
        plain_ms[body] = chain_ms(
            lambda v, body=body: vpu_ops.int_ops_plain(body, v, y, P1_REPS), x, 1)
    line(f"[7 P1] all 7 bodies bitwise equal to their plain versions at (16, 2^{P1_LOG_N}), "
         f"REPS {P1_REPS}, 32-bit random operands")

    vpu_ops.LAUNCHES["int_ops"] = 0
    res = vpu_ops.run(P1_LOG_N, P1_REPS, P1_ITERS, device="cuda")
    launches = vpu_ops.LAUNCHES["int_ops"]
    lanes = shape[0] * shape[1]
    sass = report["sass"]
    for body, r in res["bodies"].items():
        r["plain_ms"] = plain_ms[body]
        r["sass_int_per_lane"] = sass[f"P1/{body}"]["int"]
        r["t_int_instr_s"] = r["sass_int_per_lane"] * lanes / (r["ms"] / 1e3) / 1e12
        line(f"[7 P1] {body:10s}: {r['ms']:.4f} ms  {r['tops']:6.2f} T ops/s  "
             f"{r['t_int_instr_s']:6.2f} T int instr/s ({r['sass_int_per_lane']} SASS int "
             f"instr/lane) | plain {plain_ms[body]:.2f} ms")
    report["p1"] = res
    if launches == 0:
        raise AssertionError("P1 was never launched by its timed run")
    kernels["P1"] = dict(
        name="int_ops", route="cuda", source="halo2_rsa_tpu_torch/csrc/int_ops.cu",
        replaces="scripts/bench_vpu_ops.py:50", launches=launches, max_abs_err=worst,
        ms=sum(r["ms"] for r in res["bodies"].values()), plain_ms=sum(plain_ms.values()),
        shape=f"7 bodies x (16, 2^{P1_LOG_N}) lanes, REPS {P1_REPS} (times summed over bodies)",
    )
    line(f"[7 P1] launches in the timed run: {launches}")


def phase_p2(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR
    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    fc = vecfield.consts(BN254_FR)
    n = 1 << P2_LOG_N
    a = mont_layout.random_elements(fc, n, 21, "cuda")
    b = mont_layout.random_elements(fc, n, 22, "cuda")
    at, bt = a.t().contiguous(), b.t().contiguous()
    cases = {"P2-lm": (lambda v: mont_layout.mont_mul_lm(fc, v, bt),
                       lambda v: mont_layout.mont_mul_lm_plain(fc, v, bt), at)}
    for t in mont_layout.THREADS:
        cases[f"P2-staged-{t}"] = (lambda v, t=t: mont_layout.mont_mul_staged(fc, v, b, t),
                                   lambda v: mont_layout.mont_mul_staged_plain(fc, v, b), a)
    errs, plain_ms = {}, {}
    for key, (kern, plain, x0) in cases.items():
        errs[key] = _max_abs_err(kern(x0), plain(x0))
        if errs[key]:
            raise AssertionError(f"{key} differs from its plain version: {errs[key]}")
    plain_ms["P2-lm"] = chain_ms(cases["P2-lm"][1], at, 1)
    plain_ms["P2-staged"] = chain_ms(cases[f"P2-staged-{P2_THREADS}"][1], a, 1)
    line(f"[8 P2] (b') and (d') for T in {mont_layout.THREADS} bitwise equal to their plain "
         f"versions at 2^{P2_LOG_N} products (bn254_fr)")

    for key in mont_layout.LAUNCHES:
        mont_layout.LAUNCHES[key] = 0
    res = mont_layout.run(P2_LOG_N, P2_ITERS, device="cuda")  # raises unless all equal K1
    launches = dict(mont_layout.LAUNCHES)
    for name, r in res["variants"].items():
        line(f"[8 P2] {name:6s}: {r['ms']:9.4f} ms  {r['mel_s']:9.1f} M el/s  "
             f"{r['gb_s']:7.1f} GB/s = {r['gb_s'] / (HBM_BYTES_S / 1e9) * 100:5.1f} % of 3.35 TB/s")
    line("[8 P2] (a), (b'), (c) and every (d') bitwise equal over all products; launches "
         f"in the timed run: {launches}")
    report["p2"] = res
    for key, count in launches.items():
        if count == 0:
            raise AssertionError(f"P2 {key} was never launched by its timed run")
    common = dict(route="cuda", source="halo2_rsa_tpu_torch/csrc/mont_layout.cu",
                  replaces="scripts/bench_mont_layout.py:110")
    kernels["P2-lm"] = dict(
        name="mont_mul_lm", launches=launches["mont_mul_lm"], max_abs_err=errs["P2-lm"],
        ms=res["variants"]["b'"]["ms"], plain_ms=plain_ms["P2-lm"],
        shape=f"2^{P2_LOG_N} products", **common)
    kernels["P2-staged"] = dict(
        name="mont_mul_staged<" + "|".join(map(str, mont_layout.THREADS)) + ">",
        launches=launches["mont_mul_staged"],
        max_abs_err=max(v for k_, v in errs.items() if k_.startswith("P2-staged")),
        ms=res["variants"][f"d'{P2_THREADS}"]["ms"], plain_ms=plain_ms["P2-staged"],
        shape=f"2^{P2_LOG_N} products; launches and max_abs_err over T in "
              f"{mont_layout.THREADS}, ms, plain_ms and the bound at T={P2_THREADS}", **common)


def phase_bounds(report, kernels):
    """Each kernel's least time: the larger of its bytes over HBM_BYTES_S
    and its SASS instructions over the pipes' rates at the card's maximum
    SM clock (FMA-pipe and ALU-pipe integer opcodes at PIPE_LANES_PER_SM
    each, every instruction at ISSUE_PER_SM). Beside it, the integer
    instructions over P1's best measured rate, a reading only."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_cmd(["nvidia-smi", "--query-gpu=clocks.max.sm",
                      "--format=csv,noheader,nounits"]).splitlines()[0])
    pipe = PIPE_LANES_PER_SM * sms * mhz * 1e6
    issue = ISSUE_PER_SM * sms * mhz * 1e6
    bodies = report["p1"]["bodies"]
    best = max(bodies, key=lambda k_: bodies[k_]["t_int_instr_s"])
    measured = bodies[best]["t_int_instr_s"] * 1e12
    report["int_rate"] = dict(pipe_per_s=pipe, issue_per_s=issue, sms=sms,
                              clocks_max_sm_mhz=mhz, p1_measured_per_s=measured,
                              p1_measured_body=best)
    line(f"[9 bounds] per pipe {PIPE_LANES_PER_SM} x {sms} SMs x {mhz:.0f} MHz = "
         f"{pipe / 1e12:.2f} T/s, issue {issue / 1e12:.2f} T/s (derived); P1 measured "
         f"{measured / 1e12:.2f} T int instr/s ({best})")
    sass = report["sass"]
    n_p1 = 16 << P1_LOG_N
    work = {  # key -> [(elements, bytes per element, SASS counts per element)]
        "K1": [(1 << 20, 96, sass["K1"])],
        "K2": [(1 << 16, 8 * 32, sass["K2"])],
        "K3": [(1 << 16, 9 * 32, sass["K3"])],
        "K4": [(1 << 16, 6 * 32, sass["K4"])],
        "P1": [(n_p1, 12, sass[f"P1/{b}"]) for b in bodies],
        "P2-lm": [(1 << P2_LOG_N, 96, sass["P2-lm"])],
        "P2-staged": [(1 << P2_LOG_N, 96, sass["P2-staged"])],
    }
    for key, parts in work.items():
        # P1's parts are its bodies, launched one after another: bounds add
        mem = [n * nb / HBM_BYTES_S * 1e3 for n, nb, _ in parts]
        ops = [n * max(c["fma"] / pipe, c["alu"] / pipe, c["issued"] / issue) * 1e3
               for n, _, c in parts]
        p1_rate_ms = sum(n * c["int"] for n, _, c in parts) / measured * 1e3
        k = kernels[key]
        k.update(
            bound_ms=sum(map(max, mem, ops)),
            bound_by="bytes" if sum(mem) >= sum(ops) else "operations",
            bytes_ms=sum(mem), ops_ms=sum(ops), int_ms_at_p1_rate=p1_rate_ms,
            sass_per_element=[{f: c[f] for f in ("fma", "alu", "issued")} for _, _, c in parts],
            library_ms=None,
        )
        line(f"[9 bounds] {key}: {k['ms']:.4f} ms vs bound {k['bound_ms']:.4f} ms "
             f"({k['bound_by']}; bytes {sum(mem):.4f}, pipes/issue {sum(ops):.4f}; int at P1's "
             f"rate {p1_rate_ms:.4f}) = {k['bound_ms'] / k['ms'] * 100:.1f} % of bound")


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
    phase_p1(report, kernels)
    phase_p2(report, kernels)
    phase_bounds(report, kernels)
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)

    import torch

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[kk][k] for k in keys} for kk in sorted(kernels)]}))
    print(report["device"]["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Card gate of the PyTorch/CUDA port: drives halo2_rsa_tpu_torch's main
path on one NVIDIA GPU and checks it.

Phases (each prints one line before the next starts; any failure raises and
the script exits non-zero without its final line):

1. device and toolchain (torch/CUDA/nvcc/Triton versions, nvidia-smi);
2. build K1-K4 from halo2_rsa_tpu_torch/csrc with nvcc (sm_90a);
3. kernel parity on the card: each kernel against its plain torch version
   (K1 at 2^20 products over four fields, K2-K4 at 2^16 points with the
   identity, P+P and P+(-P), K3 also on coordinates lifted by q, as its lazy
   core may hold them; K3's row scans at (128, 512) and (128, 255) with the
   halving tree, with 1, 2, 4 and 8 blocks per row; K3's bucket splice at
   128 rows x 256 buckets over 2^15 points; K1-pow, the exponentiation in
   one launch, at 256 elements for exponents 0, 1, 2, p - 2 and a random
   253-bit one over four fields; K1-prefix, the prefix and suffix product in
   at most three launches, over rows of 1 and 3 at lengths around its tile
   over four fields and at one row of more than tile^2; the NTT, one launch
   a stage, at 2 to 2^21 elements a poly in both directions against the
   torch stage loop, log_n launches a call and no K1 launch), all compared
   bitwise; K1 timed there (K2's, K3's and K4's times are phase 6's);
4. the committed JAX-made golden proofs reproduced byte for byte;
5. the flagship: RSA-1024 PKCS#1 v1.5, SHA disabled, k=15 — build, compile,
   setup, keygen, one cold and five warm proves, verify;
6. launch counts of K1-K4 and the NTT during the flagship (all must be >
   0), and over one warm prove (K1-pow exactly once: the one field
   inversion; K1-prefix at most three launches per call; the NTT one a
   stage); the shapes of every K1-K4 and NTT launch of one more warm prove
   (``chip_smoke.json``: ``k1_calls_per_warm_prove``,
   ``k1_pow_calls_per_warm_prove``, ``k1_prefix_calls_per_warm_prove``,
   ``ntt_calls_per_warm_prove``, ``g1_calls_per_warm_prove``); then K1 at
   each of its shapes, K1-pow at its shapes (the inversion) and at 2^14
   elements, K1-prefix at its shapes (rows, length, direction), the NTT at
   its shapes (polys, log_n, direction) and at the same calls at k=18's
   sizes (time per NTT and per stage beside its bytes bound, the torch
   loop's time), K2
   at the shapes the flagship launches it with (one scan of C = 64 mixed
   adds per thread over the windows x chunks of one bucket pipeline) and at
   2^16 points with C = 1, K3 at its shapes and at 2^16 points, its row
   scans (with every cluster size) and bucket splice at theirs, and K4 at
   its shapes (one launch of 8 doublings
   per Horner window, over the P points of one ``msm_many`` call) and at
   2^16 points with 1 and 8 doublings, each bitwise against its plain
   version, timed as the card's time alone (the launches queued behind a
   spin kernel, ``queued_ms``) and as paced by the host, beside an empty
   launch;
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
   over 128 issued per SM (K2 and K4: the loop body once per add or
   doubling, the rest once per thread). P1's best measured integer rate is
   reported beside it, as a reading. The rank of each kernel, launches per
   warm prove x (ms - bound ms), summed over its path shapes (K1's in
   buckets of products per launch);
10. the constraint checker on the card: the flagship's
    ``Pkcs1v15Circuit.check()`` (0 violations, K1 launched) and a seeded
    corruption of its witness against the CPU's counts, ``failing_gates``
    and ``explain``; BASELINE config #1 (bench.py's mul_mod-2048 at batch
    256) checked in one batched pass, a seeded corruption of six instances
    against the CPU's per-instance counts, the pass timed (checks/s), and K1
    at the checker's shape;
11. RSA-1024 + SHA-256 of a 64 B message (k=17, 90,442 gates): build,
    check, set-up, keygen, one prove and verify on the card, a wrong public
    input rejected, every kernel launched on that path, the shape of every
    K1-K4 launch recorded (``chip_smoke.json``: ``sha.calls``); then each
    shape the flagship's warm prove does not launch (the fixed-base set-up,
    keygen, the checker, the MSM's point-axis segments, k=17's NTT stages)
    and each kernel's largest held bitwise against its plain version, on the
    inputs of a second run of the path (``sha.held``); then the zk-email
    cell's circuit (RSA-2048, SHA-256 in its dynamic-length mode up to
    1,024 B, k=20, 650,151 gates) the same way, its key made from the
    witness-free circuit (``zkemail.calls``, ``zkemail.held``), and one
    warm prove's NTT and K1 shapes, and its K2 and row-scan
    shapes the flagship's does not launch, timed on the card alone
    (``zkemail.ntt``, ``zkemail.k1``, ``zkemail.k2``, ``zkemail.k3_scan``);
12. batched witness replay (``witness.WitnessProgram``): BASELINE config #1
    at its batch of 256 distinct instances, and 16 flagship instances under
    one key tiled to 64, replayed on the card with the launch counts set to
    0 before and read after (K1 and K1-pow must launch) and every launch's
    shape recorded (``replay.*.calls``); each witness bitwise equal to
    synthesis, 0 violations in the batched check, six corrupted config #1
    instances against the CPU's counts; the flagship instances' trace shape
    equal to phase 5's, and instance 0's replayed witness proven with phase
    5's key, byte-equal to the proof of its synthesized witness, verified;
    each replay shape that phases 6 and 11 do not hold, and each kernel's
    largest, held bitwise on the replay's own operands; the warm split
    (host big ops, device program, whole generate; witnesses/s), the card's
    operations per generate (torch.profiler), and K1 at the flagship
    replay's largest shape and K1-pow at its inversion timed on the card
    alone (the kernels line's ``K1-replay`` and ``K1-pow-replay`` rows);
13. multi-rank (``parallel``), every rank a process of its own started by
    ``parallel.spawn`` (a deadline; any rank's failure fails the phase):
    two ranks on this one card over gloo (collectives staged through host
    memory) run ``entry.dryrun_multichip(2, "gloo")`` with no section
    skipped; then the flagship with phase 5's keys saved and loaded in each
    rank, proven with ``MeshKernels`` (1 cold + 3 warm, ``random.Random(41)``):
    the same SHA-256 on both ranks as phase 5's single-device proof with that
    rng, verified, a wrong public input rejected, per-rank launch counts and
    collectives (calls, bytes, staged bytes) over one warm prove, each
    rank's K2 and chunk-total K3-scan work 1/2 of phase 5's (its blinding
    tails' row scans phase 5's in full: each rank sums its own); config #1 by
    ``ShardedChecker`` on meshes (2, 1) and (1, 2) and ``WireShardedChecker``
    on (2, 1), 0 violations and the six corrupted instances' counts equal
    to phase 10's, checks/s; then one rank over NCCL proves the flagship
    again, byte-equal (its collectives are over one rank: trivial).

Phase 5 also saves the flagship's keys (``utils.serialization``) under
``.keys/``, loads them back, proves byte-equal from them and runs
``load_or_keygen`` twice on a fresh directory (generated, then loaded).

Then it prints the kernels' JSON line (each row also names its ``shape``
and its ``timing``: ``queued`` on every row, CUDA events over launches
queued behind a spin kernel so that the host cannot pace them; the
host-paced figure is ``host_paced_ms`` in chip_smoke.json), the card's name
and power limit, and
as its last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py   (needs one CUDA card and nvcc)
"""

import collections
import contextlib
import functools
import hashlib
import io
import itertools
import json
import math
import os
import random
import re
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
K4_BIG = 1 << 16  # K2's and K4's parity shape
QUEUED_ITERS = 50  # launches per queued_ms chain at the parity shapes
# K2 calls per timed chain: a checkout whose K2 is one add per launch makes C
# = 64 launches per call, and ~1,000 queued launches outgrow the card's
# launch queue (the host then waits)
K2_ITERS = 15
# row-scan calls per timed chain: a checkout without the scan kernel runs
# each scan as ~100-200 launches, and the chain must stay within the card's
# launch queue
K3_SCAN_ITERS = 4
QUEUE_LEAD_MS = 20.0  # queued_ms's first spin, lengthened while the host needs longer


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
    "K1": ("h2r_mont_mul_kernel", (0,)),
    "K1/cycle": ("h2r_mont_mul_kernel", (1,)),  # a broadcast operand over leading axes
    "K1/repeat": ("h2r_mont_mul_kernel", (2,)),  # a broadcast operand along the row axis
    "K1-pow": ("h2r_mont_pow_kernel", ()),
    "K1-prefix": ("h2r_mont_scan_tiles_kernel", ()),
    "K2": ("h2r_g1_scan_mixed_kernel", ()),
    "K3": ("h2r_g1_add_kernel", ()),
    "K3-scan": ("h2r_g1_scan_rows_kernel", (0,)),  # one block per row
    "K3-scan/cluster": ("h2r_g1_scan_rows_kernel", (1,)),  # a cluster of blocks per row
    "K3-splice": ("h2r_g1_bucket_splice_kernel", ()),
    "K4": ("h2r_g1_double_kernel", ()),
    "NTT": ("h2r_ntt_stage_kernel", (0,)),  # a stage before the last
    "NTT/last": ("h2r_ntt_stage_kernel", (1,)),  # the last: bit-reversed store, 1/N
    "P2-lm": ("h2r_mont_mul_lm_kernel", ()),
    "P2-staged": ("h2r_mont_mul_staged_kernel", (P2_THREADS,)),
}


def phase_build(report):
    from halo2_rsa_tpu_torch.bench import vpu_ops
    from halo2_rsa_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):  # nvcc's -Xptxas=-v report
        path = cuda_build.build(verbose=True)
    cuda_build.library()
    dt = time.perf_counter() - t0
    usage = ptxas_usage(log.getvalue())
    report["build"] = dict(seconds=dt, library=os.path.relpath(path, HERE), ptxas=usage)
    line(f"[2 build] K1-K4 (K3 with its row scans and bucket splice), P1, P2 built for sm_90a "
         f"in {dt:.2f} s -> {report['build']['library']}")
    k4_use = [u for sym, u in usage.items() if "h2r_g1_double_kernel" in sym]
    spilled = [sym for sym, u in usage.items() if u.get("spill_stores") or u.get("spill_loads")]
    k2_use = [u for sym, u in usage.items() if "h2r_g1_scan_mixed_kernel" in sym]
    k3_use = [u for sym, u in usage.items() if "h2r_g1_add_kernel" in sym]
    scan_use = [u for sym, u in usage.items() if "h2r_g1_scan_rows_kernel" in sym]
    splice_use = [u for sym, u in usage.items() if "h2r_g1_bucket_splice_kernel" in sym]
    ntt_use = [u for sym, u in usage.items() if "h2r_ntt_stage_kernel" in sym]
    line(f"[2 build] ptxas: K2 {k2_use}, K3 {k3_use}, K3-scan {scan_use}, K3-splice "
         f"{splice_use}, K4 {k4_use}, NTT {ntt_use} | kernels that spill: {spilled or 'none'}")
    listing = cuda_build.sass_listing(path)
    sass = {sym: collections.Counter(op for _, op, _ in insns) for sym, insns in listing.items()}
    names = dict(SASS_NAMES)
    for body, bid in vpu_ops.BODY_IDS.items():
        names[f"P1/{body}"] = ("h2r_int_ops_kernel", (bid, P1_REPS))
    counts = {}
    for key, (sym, targs) in names.items():
        ops = cuda_build.kernel_opcodes(sass, sym, *targs)
        counts[key] = dict(
            _pipes(ops), total=sum(ops.values()),
            branches=sum(n for op, n in ops.items() if op.startswith("BRA")),
            top=dict(ops.most_common(8)),
        )
    # K2 loops over its adds and K4 over its doublings: the body runs c or
    # reps times, the rest once per thread
    for key in ("K2", "K4"):
        body, rest = cuda_build.loop_split(listing[cuda_build.kernel_symbol(
            listing, SASS_NAMES[key][0])])
        counts[key].update(body=_pipes(body), rest=_pipes(rest))
    report["sass"] = counts
    line("[2 build] SASS integer instructions per thread: " + ", ".join(
        f"{k}={v['int']}" for k, v in counts.items()))
    for body in vpu_ops.BODIES:
        n_int = counts[f"P1/{body}"]["int"]
        if n_int < P1_REPS:
            raise AssertionError(f"P1 {body}: the compiler folded the chain ({n_int} integer "
                                 f"instructions for REPS {P1_REPS})")


def _pipes(ops) -> dict:
    from halo2_rsa_tpu_torch.utils import cuda_build

    return dict(int=cuda_build.int_instructions(ops), **cuda_build.pipe_counts(ops))


def ptxas_usage(log: str) -> dict:
    """{entry symbol: registers and spill bytes} from ``nvcc -Xptxas=-v``."""
    out, cur = {}, None
    for text in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", text)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        if m:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", text)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# (a's shape, b's shape) of K1's broadcast parity: cycle (b's rows over a's
# leading axes) with one row, with a twiddle row over polys and over a batch;
# repeat (a row per poly) with 11 and with 2^10 rows
K1_BCAST_PARITY = [
    ((1 << 20, 8), (8,)),
    ((4, 1 << 18, 8), (1, 1 << 18, 8)),
    ((3, 5, 1 << 16, 8), (5, 1 << 16, 8)),
    ((11, 95_325, 8), (11, 1, 8)),
    ((1 << 10, 1 << 10, 8), (1 << 10, 1, 8)),
]


def _parity_k1(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
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
            step = lambda x: cuda_mont.mont_mul(fc, x, b)  # noqa: E731
            ms = queued_ms(step, a, QUEUED_ITERS)
            host_ms = chain_ms(step, a, QUEUED_ITERS)
            plain_ms = chain_ms(lambda x: cuda_mont.mont_mul_plain(fc, x, b), a, 3)
    # a broadcast operand read in place: its rows repeated over the leading
    # axes (cycle) or along the row axis (repeat), against the plain product
    # of the materialised operands
    fc = vecfield.consts(ALL_FIELDS[0])
    for shape_a, shape_b in K1_BCAST_PARITY:
        a = mont_layout.random_elements(fc, math.prod(shape_a[:-1]), 41, "cuda").view(shape_a)
        b = mont_layout.random_elements(fc, math.prod(shape_b[:-1]), 42, "cuda").view(shape_b)
        want = cuda_mont.mont_mul_plain(
            fc, *[t.contiguous() for t in torch.broadcast_tensors(a, b)])
        for x, y in ((a, b), (b, a)):
            err = _max_abs_err(vecfield.mont_mul(fc, x, y), want)
            if err:
                raise AssertionError(f"K1 at {tuple(x.shape)} x {tuple(y.shape)} differs from its "
                                     f"plain version")
    kernels["K1"] = dict(
        name="mont_mul", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", max_abs_err=worst,
        ms=ms, host_paced_ms=host_ms, plain_ms=plain_ms, shape=f"{n} products",
        timing="queued",
    )
    line(f"[3 parity] K1 mont_mul: 2^20 x 4 fields bitwise equal | card {ms:.4f} ms, "
         f"host-paced {host_ms:.4f} ms, plain {plain_ms:.3f} ms (bn254_fr, 2^20); broadcast "
         f"operands read in place bitwise equal at " + ", ".join(
             f"{a} x {b}" for a, b in K1_BCAST_PARITY) + " (either operand first)")


POW_N = 256  # K1-pow's parity shape: elements per field and exponent


def _parity_pow(report, kernels):
    """K1-pow against its plain version over every field at POW_N elements
    (0, 1 and p - 1 among them) for exponents 0, 1, 2, p - 2 and a random
    253-bit one, and against Python ints."""
    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import ALL_FIELDS, cuda_mont, vecfield

    rng = random.Random(13)
    worst = 0
    for field in ALL_FIELDS:
        fc = vecfield.consts(field)
        p = field.p
        a = mont_layout.random_elements(fc, POW_N, 36, "cuda")
        a[:3] = vecfield.from_ints(fc, [0, 1, p - 1], device="cuda")
        for e in (0, 1, 2, p - 2, rng.getrandbits(253) | 1 << 252):
            got = cuda_mont.mont_pow(fc, a, e)
            err = _max_abs_err(got, cuda_mont.mont_pow_plain(fc, a, e))
            xs = vecfield.to_ints(fc, a[:8])
            if vecfield.to_ints(fc, got[:8]) != [pow(x, e, p) for x in xs]:
                raise AssertionError(f"K1-pow over {field.name}, e = {e}, differs from Python ints")
            if err:
                raise AssertionError(f"K1-pow over {field.name}, e = {e}, differs from its plain "
                                     f"version")
            worst = max(worst, err)
    kernels["K1-pow"] = dict(
        name="mont_pow", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont_pow.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", max_abs_err=worst, timing="queued")
    line(f"[3 parity] K1-pow mont_pow: {POW_N} elements x 4 fields x exponents 0, 1, 2, p - 2 "
         f"and a random 253-bit one bitwise equal to the plain version and to Python ints")


def _parity_prefix(report, kernels):
    """K1-prefix against its plain version, forward and reversed, over every
    field for rows of 1 and 3 at lengths around its tile, and over BN254 Fr
    at one row of more than PREFIX_TILE^2 elements (its tile totals scanned
    a tile at a time); each direction's plain run once over the longest
    rows (a prefix of the first n elements is the first n prefixes, a
    suffix product of the last n the last n). The first prefixes also
    against Python ints."""
    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import ALL_FIELDS, cuda_mont, vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    tile = cuda_mont.PREFIX_TILE
    lengths = [1, 2, 3, 37, tile - 1, tile, tile + 1, 2 * tile + 3, (1 << 12) + 4, (1 << 15) + 4]
    worst = held = 0
    for field in ALL_FIELDS:
        fc = vecfield.consts(field)
        cases = [(1, lengths), (3, lengths)]
        if field is BN254_FR:
            cases.append((1, [tile * tile + 3, tile * tile - 1]))
        for rows, ls in cases:
            top = max(ls)
            x = mont_layout.random_elements(fc, rows * top, 38 + rows, "cuda").view(rows, top, 8)
            for reverse in (False, True):
                want = cuda_mont.mont_prefix_plain(fc, x, reverse)
                for n in ls:
                    got = cuda_mont.mont_prefix(
                        fc, (x[:, -n:] if reverse else x[:, :n]).contiguous(), reverse)
                    err = _max_abs_err(got, want[:, -n:] if reverse else want[:, :n])
                    if err:
                        raise AssertionError(f"K1-prefix over {field.name} at {rows} x {n}, "
                                             f"reverse {reverse}, differs from its plain version")
                    worst, held = max(worst, err), held + 1
            ints = vecfield.to_ints(fc, x[0, :8])
            got = vecfield.to_ints(fc, cuda_mont.mont_prefix(fc, x[:1, :8].contiguous()))
            if got != list(itertools.accumulate(ints, lambda u, v: u * v % field.p)):
                raise AssertionError(f"K1-prefix over {field.name} differs from Python ints")
    kernels["K1-prefix"] = dict(
        name="mont_prefix", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont_scan.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", max_abs_err=worst, timing="queued")
    line(f"[3 parity] K1-prefix mont_prefix: {held} (field, rows, length, direction) cases bitwise "
         f"equal to the plain version, rows of 1 and 3 at lengths {lengths} over 4 fields and of "
         f"{tile * tile + 3} over bn254_fr (tile {tile}); first prefixes equal to Python ints")


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


G1_SOURCES = {"K2": "g1_scan.cu", "K3": "g1.cu", "K4": "g1_double.cu"}


def _plus_q(t):
    """Canonical limbs (..., 8) -> the same residue plus q, in [q, 2q): a
    value as the lazy core may hold it."""
    import torch

    from halo2_rsa_tpu_torch.fields import cuda_mont
    from halo2_rsa_tpu_torch.prover import curve

    v, out, carry = cuda_mont.u64(t), [], 0
    for j in range(8):
        s = v[..., j] + ((curve.Q >> (32 * j)) & 0xFFFFFFFF) + carry
        out.append(s & 0xFFFFFFFF)
        carry = s >> 32
    return cuda_mont.to_int32(torch.stack(out, dim=-1))


def _lifted(pt, lifts):
    """pt with coordinate k (0 X, 1 Y, 2 Z) lifted by q on each (k, lanes)."""
    out = [c.clone() for c in pt]
    for k, lanes in lifts:
        out[k][lanes] = _plus_q(out[k][lanes])
    return tuple(out)


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

    # K2, K3 and K4 are timed at their own shapes in phase 6
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
        kernels[key] = dict(
            name=name, route="cuda", source=f"halo2_rsa_tpu_torch/csrc/{G1_SOURCES[key]}",
            replaces=f"halo2_rsa_tpu/prover/pallas_g1.py:{pallas_line}", max_abs_err=err,
        )
        extra = ""
        if key == "K3":
            # coordinates in [q, 2q), as the lazy core holds them between
            # steps: X = Z = q on the identities of both sides (lanes
            # 129-191), Y of P1 and of -P, Z and X of either side elsewhere
            lp1 = _lifted(p1, [(0, slice(129, 192)), (2, slice(129, 192)), (1, slice(0, 64)),
                               (1, slice(256, 512)), (2, slice(512, 768)), (0, slice(768, 1024))])
            lp2 = _lifted(p2, [(0, slice(129, 192)), (2, slice(129, 192)), (1, slice(64, 128)),
                               (2, slice(384, 640)), (0, slice(1024, 1280))])
            lazy = cuda_g1.point_add(fq, lp1, lp2)
            torch.cuda.synchronize()
            err = _max_abs_err(lazy, want)
            if err:
                raise AssertionError(f"K3 on lifted coordinates differs from its plain version: "
                                     f"{err}")
            extra = "; also on coordinates lifted by q"
        line(f"[3 parity] {key} {name}: 2^16 points bitwise equal (identity, P+P, P-P, "
             f"host affine{extra})")


K3_SCAN_CLUSTERS = (1, 2, 4, 8)  # blocks per row the scan kernel is checked and timed with


def k3_scan_inputs(rows: int, length: int):
    """The row scans' inputs on the card: (rows, length) projective points
    from ``_test_points``; row 0 all the identity, row 1 one point repeated
    (P+P in round 0), row 2 pairs (P, -P) (P+(-P) in round 0), row 3 the
    identity on every even element. A shape (rows', length') takes the first
    rows' rows and length' columns."""
    import torch

    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.prover import g1_vec

    _, _, proj = _test_points(rows * length, "cuda")
    ps = tuple(c.reshape(rows, length, 8).clone() for c in proj)
    ident = g1_vec.identity((length,), device="cuda")
    odd = length // 2
    for c, i in zip(ps, ident):
        c[0] = i
        c[1] = c[1, 0].clone()
        c[2, 1::2] = c[2, 0::2][:odd].clone()
        c[3, 0::2] = i[0::2]
    ps[1][2, 1::2] = vecfield.sub(g1_vec.FQ, torch.zeros_like(ps[1][2, 1::2]), ps[1][2, 1::2])
    return ps


def _parity_scan(report, kernels):
    """The row scans at the flagship's widest shapes, (128, 512) and (128,
    255) with the tree, bitwise against their plain versions, with every
    cluster size; the affine sums of rows 0-2 against the host."""
    import torch

    from halo2_rsa_tpu_torch.prover import cuda_g1, curve, g1_vec

    fq = g1_vec.FQ
    rows = k3_scan_inputs(128, 512)
    worst = 0
    for n, tree, wrapper, plain in ((512, False, cuda_g1.point_scan, cuda_g1.point_scan_plain),
                                    (255, True, cuda_g1.point_scan_sum,
                                     cuda_g1.point_scan_sum_plain)):
        s = tuple(c[:, :n].contiguous() for c in rows)
        got, want = wrapper(fq, s), plain(fq, s)
        torch.cuda.synchronize()
        errs = [_max_abs_err(got, want)] + [
            _max_abs_err(cuda_g1._scan_rows(fq, s, tree, k), want) for k in K3_SCAN_CLUSTERS]
        if any(errs):
            raise AssertionError(f"K3-scan at (128, {n}), tree {tree}, differs from its plain "
                                 f"version: {errs}")
        worst = max(worst, *errs)
        # rows 0-2 on the host: a scan's last prefix, a tree's sum of every
        # prefix (row 1's prefixes are 1..n times its P; row 2's are its
        # even elements, each followed by the identity)
        p = g1_vec.points_from_device(tuple(c[1, :1] for c in s))[0]
        evens = g1_vec.points_from_device(tuple(c[2, 0::2] for c in s))
        host = ([None, curve.g1_mul(p, n * (n + 1) // 2), functools.reduce(curve.g1_add, evens)]
                if tree else [None, curve.g1_mul(p, n), evens[-1] if n % 2 else None])
        ends = tuple(c[:3] if tree else c[:3, -1] for c in got)
        assert g1_vec.points_from_device(ends) == host, (n, tree)
    kernels["K3-scan"] = dict(
        name="point_scan_rows", route="cuda", source="halo2_rsa_tpu_torch/csrc/g1_rows.cu",
        replaces="halo2_rsa_tpu/prover/pallas_g1.py:43", max_abs_err=worst,
    )
    line(f"[3 parity] K3-scan point_scan_rows: (128, 512) scan and (128, 255) with the tree "
         f"bitwise equal (identity rows, P+P, P-P) with {K3_SCAN_CLUSTERS} blocks per row")


SPLICE_SHAPE = (128, 256, 1 << 15, 512)  # rows, buckets, npad, nchunks: the flagship's widest


def k3_splice_inputs(rows: int, buckets: int, npad: int, nchunks: int):
    """The bucket splice's inputs on the card, as ``msm._bucket_sums`` makes
    them: within (rows, npad) and incl (rows, nchunks) projective points
    drawn from ``k4_points``, and the ends of each bucket from sorted random
    digits. Row 0 leaves buckets 0-6 empty (their ends are -1), row 1 puts
    every point in one bucket. A shape of rows' rows takes the first."""
    import torch

    pool = k4_points()
    gen = torch.Generator(device="cuda").manual_seed(19)
    idx = torch.randint(0, K4_BIG, (rows, npad + nchunks), device="cuda", generator=gen)
    within = tuple(c[idx[:, :npad]] for c in pool)
    incl = tuple(c[idx[:, npad:]] for c in pool)
    digits = torch.randint(0, buckets, (rows, npad), device="cuda", generator=gen)
    digits[0] = digits[0].clamp(min=7)
    digits[1] = buckets // 2
    ds, _ = digits.sort(dim=1)
    targets = torch.arange(buckets, device="cuda").expand(rows, buckets).contiguous()
    return within, incl, torch.searchsorted(ds, targets, right=True) - 1


def _parity_splice(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    within, incl, ends = k3_splice_inputs(*SPLICE_SHAPE)
    got = cuda_g1.bucket_splice(g1_vec.FQ, within, incl, ends)
    want = cuda_g1.bucket_splice_plain(g1_vec.FQ, within, incl, ends)
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err:
        raise AssertionError(f"K3-splice differs from its plain version: {err}")
    kernels["K3-splice"] = dict(
        name="bucket_splice", route="cuda", source="halo2_rsa_tpu_torch/csrc/g1_splice.cu",
        replaces="halo2_rsa_tpu/prover/pallas_g1.py:43", max_abs_err=err,
    )
    line("[3 parity] K3-splice bucket_splice: 128 rows x 256 buckets over 2^15 points in 512 "
         "chunks bitwise equal (empty buckets, one full bucket)")


# (polys, log_n) of the NTT's parity, both directions: every stage kind at
# the smallest sizes (log_n = 1: the last stage alone), one stage from the
# low twiddle table on (log_n = 5, h = 2), and the extended domain at k=18
NTT_PARITY = [(3, 1), (3, 2), (3, 5), (11, 12), (2, 21)]


def _parity_ntt(report, kernels):
    """The NTT kernel (``csrc/ntt.cu``) against the torch stage loop
    (``ntt._ntt_loop``) at NTT_PARITY, forward and inverse, 0, 1 and p - 1
    among the inputs; log_n launches a call and no K1 launch; and
    ``ntt.ntt``/``intt`` on the card against Python ints at 2^4."""
    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.prover import ntt

    fc = ntt.FR
    worst = 0
    for polys, log_n in NTT_PARITY:
        x = mont_layout.random_elements(fc, polys << log_n, 45 + log_n, "cuda")
        edge = [0, 1, fc.field.p - 1][: 1 << log_n]
        x[: len(edge)] = vecfield.from_ints(fc, edge, device="cuda")
        x = x.view(polys, 1 << log_n, 8)
        for inverse in (False, True):
            k1, before = dict(cuda_mont.LAUNCHES), ntt.LAUNCHES["ntt"]
            got = ntt._ntt_graph(x, log_n, inverse)
            if ntt.LAUNCHES["ntt"] - before != log_n or cuda_mont.LAUNCHES != k1:
                raise AssertionError(f"the NTT at {polys} x 2^{log_n} made "
                                     f"{ntt.LAUNCHES['ntt'] - before} launches (and K1 "
                                     f"{cuda_mont.LAUNCHES} from {k1}), expected {log_n} and none")
            err = _max_abs_err(got, ntt._ntt_loop(x, log_n, inverse))
            if err:
                raise AssertionError(f"the NTT at {polys} x 2^{log_n}, inverse {inverse}, differs "
                                     f"from the torch loop")
            worst = max(worst, err)
    vals = [random.Random(46).randrange(fc.field.p) for _ in range(16)]
    fwd = ntt.ntt(vecfield.from_ints(fc, vals, device="cuda"), 4)
    if (vecfield.to_ints(fc, fwd) != ntt.ntt_host(vals)
            or vecfield.to_ints(fc, ntt.intt(fwd, 4)) != vals):
        raise AssertionError("the NTT on the card differs from the host DFT at 2^4")
    kernels["NTT"] = dict(
        name="ntt", route="cuda", source="halo2_rsa_tpu_torch/csrc/ntt.cu",
        replaces="none: halo2_rsa_tpu/prover/ntt.py is plain jnp", max_abs_err=worst,
        timing="queued")
    line("[3 parity] NTT h2r_ntt: " + ", ".join(f"{p} x 2^{n}" for p, n in NTT_PARITY)
         + ", forward and inverse, bitwise equal to the torch stage loop, log_n launches a call "
           "and no K1 launch; 2^4 equal to the host DFT both ways")


def phase_parity(report, kernels):
    _parity_k1(report, kernels)
    _parity_pow(report, kernels)
    _parity_prefix(report, kernels)
    _parity_g1(report, kernels)
    _parity_scan(report, kernels)
    _parity_splice(report, kernels)
    _parity_ntt(report, kernels)


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


def reset_launch_counts() -> None:
    from halo2_rsa_tpu_torch.fields import cuda_mont
    from halo2_rsa_tpu_torch.prover import cuda_g1, ntt

    for counts in (cuda_mont.LAUNCHES, cuda_g1.LAUNCHES, ntt.LAUNCHES):
        for key in counts:
            counts[key] = 0


def launch_counts() -> dict:
    """K1-K4's and the NTT's launch counters, by kernels-line row."""
    from halo2_rsa_tpu_torch.fields import cuda_mont
    from halo2_rsa_tpu_torch.prover import cuda_g1, ntt

    return {
        "K1": cuda_mont.LAUNCHES["mont_mul"],
        "K1-pow": cuda_mont.LAUNCHES["mont_pow"],
        "K1-prefix": cuda_mont.LAUNCHES["mont_prefix"],
        "K2": cuda_g1.LAUNCHES["g1_add_mixed"],
        "K3": cuda_g1.LAUNCHES["g1_add"],
        "K3-scan": cuda_g1.LAUNCHES["g1_scan"],
        "K3-splice": cuda_g1.LAUNCHES["g1_splice"],
        "K4": cuda_g1.LAUNCHES["g1_double"],
        "NTT": ntt.LAUNCHES["ntt"],
    }


def flagship_circuit() -> tuple:
    """The flagship, RSA-1024 PKCS#1 v1.5 with SHA disabled, over a 32 B
    message signed by ``sign_fixture`` (both from random.Random(7)), built
    and compiled: (circuit, compiled, k)."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    bits = 1024
    msg = bytes(random.Random(7).randrange(256) for _ in range(32))
    n, sig = sign_fixture(bits, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    circ = Pkcs1v15Circuit.build(bits, n, sig, hashed_msg=hashed)
    compiled = circ.compile()
    return circ, compiled, max(compiled.num_gates + 20, compiled.num_witness // 5 + 1).bit_length()


def phase_flagship(report, kernels):
    import torch

    from halo2_rsa_tpu_torch.prover import kzg, plonk
    from halo2_rsa_tpu_torch.utils.profiling import Phases

    # launch counts cover the main path only (parity launches excluded)
    reset_launch_counts()
    f = {}
    t0 = time.perf_counter()
    circ, compiled, k = flagship_circuit()
    f["build_compile_s"] = time.perf_counter() - t0
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
        before = launch_counts()
        _, dt, ph = timed_prove()
        per_prove = {k_: v - before[k_] for k_, v in launch_counts().items()}
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

    counts = launch_counts()
    f["launches"] = counts
    f["launches_per_warm_prove"] = per_prove
    calls = _calls_of(timed_prove)
    f["k1_calls_per_warm_prove"] = calls.pop("K1")
    f["k1_pow_calls_per_warm_prove"] = calls.pop("K1-pow")
    f["k1_prefix_calls_per_warm_prove"] = calls.pop("K1-prefix")
    f["ntt_calls_per_warm_prove"] = calls.pop("NTT")
    f["g1_calls_per_warm_prove"] = calls
    report["flagship"] = f
    line("[6 launches] flagship path (setup, keygen, 1 cold + 5 warm proves, 2 verifies): "
         + ", ".join(f"{k_}={v}" for k_, v in counts.items())
         + " | over one warm prove: " + ", ".join(f"{k_}={v}" for k_, v in per_prove.items()))
    for key, v in counts.items():
        kernels[key]["launches"] = v
        kernels[key]["launches_per_warm_prove"] = per_prove[key]
        if v == 0:
            raise AssertionError(f"{key} was never launched on the flagship path")
    f["keys"] = _key_artifacts(report, circ, compiled, k, srs, pk, vk)
    return dict(circ=circ, compiled=compiled, pk=pk, vk=vk)


KEY_SEED = 41  # the rng of the proves that compare generated and loaded keys


def _key_artifacts(report, circ, compiled, k, srs, pk, vk) -> dict:
    """The flagship's SRS, pk and vk saved under a fresh directory in .keys/
    and loaded back on the card: a prove from the loaded keys must equal one
    from the generated keys with the same rng, and the loaded vk must verify
    it. Then ``load_or_keygen`` twice on another fresh directory: generated,
    then loaded, with the same proof bytes. The directory is removed."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from halo2_rsa_tpu_torch.prover import plonk
    from halo2_rsa_tpu_torch.utils import serialization as ser

    def prove(key):
        return plonk.prove(key, circ.builder.values, circ.public_inputs,
                           rng=random.Random(KEY_SEED))

    keys_dir = os.path.join(HERE, ".keys")
    os.makedirs(keys_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_", dir=keys_dir)
    out = {}
    try:
        paths = {name: os.path.join(d, name) for name in ("srs.npz", "pk.npz", "vk.json")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ser.save_srs(srs, paths["srs.npz"])
        ser.save_pk(pk, paths["pk.npz"])
        ser.save_vk(vk, paths["vk.json"])
        out["save_s"] = time.perf_counter() - t0
        out["file_bytes"] = {name: os.path.getsize(path) for name, path in paths.items()}
        t0 = time.perf_counter()
        srs2 = ser.load_srs(paths["srs.npz"])
        pk2 = ser.load_pk(paths["pk.npz"], srs2)
        vk2 = ser.load_vk(paths["vk.json"])
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        if dataclasses.asdict(vk2) != dataclasses.asdict(vk):
            raise AssertionError("the vk loaded from its file differs from the generated vk")
        want = prove(pk)
        out["proof_sha256"] = hashlib.sha256(want).hexdigest()
        if prove(pk2) != want:
            raise AssertionError("the proof from the loaded keys differs from the generated keys'")
        if not plonk.verify(vk2, want, circ.public_inputs):
            raise AssertionError("the loaded vk does not verify the flagship's proof")
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, pk3, _, loaded = ser.load_or_keygen(compiled, k, os.path.join(d, "fresh"), tau=777)
            torch.cuda.synchronize()
            runs.append(dict(loaded=loaded, seconds=time.perf_counter() - t0))
            if prove(pk3) != want:
                raise AssertionError(f"load_or_keygen (loaded={loaded}): the proof differs")
        if [r["loaded"] for r in runs] != [False, True]:
            raise AssertionError(f"load_or_keygen on a fresh directory: {runs}")
        out["load_or_keygen"] = runs
    finally:
        shutil.rmtree(d, ignore_errors=True)
    line(f"[5 keys] the flagship's proof from random.Random({KEY_SEED}): sha256 "
         f"{out['proof_sha256']}")
    line(f"[5 keys] SRS + pk + vk saved in {out['save_s']:.3f} s "
         f"({sum(out['file_bytes'].values()) / 2**20:.1f} MiB), loaded back in {out['load_s']:.3f} s; "
         f"the proof from the loaded keys equals the generated keys' byte for byte and the "
         f"loaded vk verifies it | load_or_keygen on a fresh directory: generated "
         f"{runs[0]['seconds']:.3f} s, then loaded {runs[1]['seconds']:.3f} s, same proof bytes | "
         f"{report['device']['smi']}")
    return out


def _copy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return tuple(_copy(v) for v in x)
    return x


def _calls_of(run, keep=None) -> dict:
    """{kernel: [[shape..., calls], ...]} over ``run()``, read by
    pass-through wrappers around the K1-K4 wrappers: K1 (products, rows of
    b, broadcast mode: 0 b of a's shape, 1 cycle, 2 repeat), K1-pow
    (elements, exponent bits), K1-prefix (rows, length, 1 reversed else 0),
    K2 (rows, C), K3 (points,), K3-scan (rows, L, 1 with the tree else 0),
    K3-splice (rows, buckets, npad, nchunks), K4 (points, doublings), NTT
    (polys, log_n, 1 inverse else 0; read around ``ntt._ntt_graph``). Each
    call launches its kernel once, K1-prefix ``prefix_launches`` times (at
    most three), the NTT log_n times (once a stage). The launches made
    inside the wrappers must add up to each kernel's launch count over the
    same run.
    Given ``keep`` (a dict), the first launch at each (kernel, shape) is
    kept there as (its plain version, copies of its arguments and of its
    output)."""
    from halo2_rsa_tpu_torch.fields import cuda_mont
    from halo2_rsa_tpu_torch.prover import cuda_g1, ntt

    calls = {key: collections.Counter() for key in launch_counts()}
    launched = collections.Counter()

    def points(t):
        return t.numel() // t.shape[-1]

    def rows(t):
        return points(t) // t.shape[-2]

    shape_of = {
        (cuda_mont, "mont_mul"): ("K1", lambda fc, a, b, bcast=None: (
            points(a), points(b), cuda_mont.BCAST.index(bcast))),
        (cuda_mont, "mont_pow"): ("K1-pow", lambda fc, a, e: (points(a), e.bit_length())),
        (cuda_mont, "mont_prefix"): ("K1-prefix", lambda fc, vals, reverse=False: (
            rows(vals), vals.shape[-2], int(reverse))),
        (cuda_g1, "point_scan_mixed"): ("K2", lambda fc, p1, pts: (
            points(p1[0]), pts[0].shape[-2])),
        (cuda_g1, "point_add_mixed"): ("K2", lambda fc, p1, p2: (points(p1[0]), 1)),
        (cuda_g1, "point_add"): ("K3", lambda fc, p1, p2: (points(p1[0]),)),
        (cuda_g1, "point_scan"): ("K3-scan", lambda fc, ps: (rows(ps[0]), ps[0].shape[-2], 0)),
        (cuda_g1, "point_scan_sum"): ("K3-scan", lambda fc, ps: (
            rows(ps[0]), ps[0].shape[-2], 1)),
        (cuda_g1, "bucket_splice"): ("K3-splice", lambda fc, within, incl, ends: (
            ends.shape[0], ends.shape[1], within[0].shape[1], incl[0].shape[1])),
        (cuda_g1, "point_double"): ("K4", lambda fc, p, reps=1: (points(p[0]), reps)),
        (ntt, "_ntt_graph"): ("NTT", lambda a, log_n, inverse, tw_full=None: (
            a.shape[0], log_n, int(inverse))),
    }
    real = {target: getattr(*target) for target in shape_of}

    def recorder(target):
        key, shape_fn = shape_of[target]
        plain = ntt._ntt_loop if key == "NTT" else getattr(target[0], target[1] + "_plain")

        def wrapped(*args, **kw):
            shape = shape_fn(*args, **kw)
            calls[key][shape] += 1
            before = launch_counts()[key]
            out = real[target](*args, **kw)
            made = launch_counts()[key] - before
            if key == "NTT" and made != shape[1]:
                raise AssertionError(f"an NTT at {shape} made {made} launches, not one a stage")
            if key != "NTT" and made > (3 if key == "K1-prefix" else 1):
                raise AssertionError(f"one call of {key} at {shape} made {made} launches")
            launched[key] += made
            if keep is not None and (key, shape) not in keep:
                keep[key, shape] = (plain, _copy(args), dict(kw), _copy(out))
            return out

        return wrapped

    before = launch_counts()
    for target in shape_of:
        setattr(*target, recorder(target))
    try:
        run()
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    after = launch_counts()
    for key in calls:
        if launched[key] != after[key] - before[key]:
            raise AssertionError(f"{key} launches recorded {launched[key]} differ from "
                                 f"its count over the same run {after[key] - before[key]}")
    return {key: [[*shape, n] for shape, n in sorted(hist.items())]
            for key, hist in calls.items()}


def queued_ms(step, x, iters: int) -> float:
    """Mean device ms of ``step`` over a chain ``x = step(x)`` of ``iters``
    calls queued behind a spin kernel: the host has enqueued the whole chain
    before the card reaches it, so the time is the card's (launch gaps
    included), not the host's. A chain that takes the host longer than half
    the spin is timed again behind a spin four times longer."""
    import torch

    x = step(x)
    lead = x if isinstance(x, torch.Tensor) else x[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lead_ms = QUEUE_LEAD_MS
    for _ in range(4):
        torch.cuda.synchronize(lead.device)
        torch.cuda._sleep(int(lead_ms * 2e6))  # cycles: ~1 ms per 2e6 at <= 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            x = step(x)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize(lead.device)
        if host_ms < 0.5 * lead_ms:
            return start.elapsed_time(end) / iters
        lead_ms *= 4
    raise RuntimeError(f"queued_ms: the host needed {host_ms:.1f} ms to enqueue the chain")


def k4_points():
    """K4's inputs: 2^16 projective points on the card, lane 1 the identity
    (0 : 1 : 0); a shape of n points takes the first n."""
    import torch

    from halo2_rsa_tpu_torch.prover import g1_vec

    _, _, pts = _test_points(K4_BIG, "cuda")
    ident = g1_vec.identity((1,), device="cuda")
    return tuple(torch.cat([c[:1], i, c[2:]]) for c, i in zip(pts, ident))


def k4_times(double, plain, shapes, pts) -> list:
    """K4 at each (kind, n, reps) of ``shapes``: ``double(p, reps)`` held
    bitwise against ``plain(p, reps)``, then ms per launch on the card alone
    (``queued_ms``) and paced by the host (``chain_ms``); the plain version's
    ms at the path's shapes. ``scripts/time_kernels.py`` runs it on another
    checkout's wrappers."""
    import torch

    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    out = []
    for kind, n, reps in shapes:
        p = tuple(c[:n].contiguous() for c in pts)
        got, want = double(p, reps), plain(p, reps)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"K4 at {n} points, reps {reps}, differs from its plain version")
        iters = 100 if kind == "path" else 50
        r = dict(kind=kind, n=n, reps=reps, max_abs_err=err,
                 ms=queued_ms(lambda q: double(q, reps), p, iters),
                 host_paced_ms=chain_ms(lambda q: double(q, reps), p, iters))
        if kind == "path":
            r["plain_ms"] = chain_ms(lambda q: plain(q, reps), p, 3)
        out.append(r)
    return out


def k3_times(add, plain, shapes, pts) -> list:
    """K3 at each (kind, n) of ``shapes``: ``add(p, q)`` on the first n of
    ``pts`` and the same n rotated by one, hashed (``digest``, for comparing
    checkouts) and, given ``plain``, held bitwise against ``plain(p, q)``;
    then ms per launch on the card alone (``queued_ms``) and paced by the
    host (``chain_ms``), and the plain version's ms at the path's shapes.
    ``scripts/time_kernels.py`` runs it on another checkout's wrappers."""
    import torch

    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    out = []
    for kind, n in shapes:
        p = tuple(c[:n].contiguous() for c in pts)
        q = tuple(c.roll(1, dims=0) for c in p)
        got = add(p, q)
        r = dict(kind=kind, n=n, digest=_digest(got))
        if plain is not None:
            want = plain(p, q)
            torch.cuda.synchronize()
            r["max_abs_err"] = _max_abs_err(got, want)
            if r["max_abs_err"]:
                raise AssertionError(f"K3 at {n} points differs from its plain version")
            if kind == "path":
                r["plain_ms"] = chain_ms(lambda x: plain(x, q), p, 3)
        step = lambda x: add(x, q)  # noqa: E731
        r.update(ms=queued_ms(step, p, QUEUED_ITERS),
                 host_paced_ms=chain_ms(step, p, QUEUED_ITERS))
        out.append(r)
    return out


def _check_and_time(res: dict, call, x, plain=None, label: str = "",
                    iters: int = K3_SCAN_ITERS) -> dict:
    """Fills ``res`` for one shape: the sha256 of ``call()``'s result
    (``digest``, for comparing checkouts); given ``plain`` (a call), its ms
    and the largest difference from it, which must be 0; then ms per call on
    the card alone (``queued_ms``) and paced by the host (``chain_ms``),
    over ``iters`` calls behind ``x``."""
    import torch

    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    got = call()
    res["digest"] = _digest(got)
    if plain is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        res["plain_ms"] = (time.perf_counter() - t0) * 1e3
        res["max_abs_err"] = _max_abs_err(got, want)
        if res["max_abs_err"]:
            raise AssertionError(f"{label} differs from its plain version")
    del got
    step = lambda q: (call(), q)[1]  # noqa: E731
    res.update(ms=queued_ms(step, x, iters), host_paced_ms=chain_ms(step, x, iters))
    return res


def k3_scan_times(make, shapes, rows, plain=None) -> list:
    """The row scans at each (kind, rows, len, tree) of ``shapes``, on the
    first rows x len points of ``rows`` (``_check_and_time``). ``make(s,
    tree)`` returns a call that computes them: one scan launch, or, for a
    checkout without ``point_scan``, its round-by-round
    ``msm._hs_point_scan`` or ``msm._bucket_reduce``; ``plain(s, tree)``
    their plain version. ``scripts/time_kernels.py`` runs it on another
    checkout's wrappers."""
    out = []
    for kind, m, n, tree in shapes:
        s = tuple(c[:m, :n].contiguous() for c in rows)
        out.append(_check_and_time(
            dict(kind=kind, rows=m, len=n, tree=tree), make(s, tree), s[0],
            plain and (lambda s=s, tree=tree: plain(s, tree)),
            f"K3-scan at {m} rows x {n}, tree {tree},"))
    return out


def k3_splice_times(make, shapes, inputs, plain=None) -> list:
    """The bucket splice at each (kind, rows, buckets, npad, nchunks) of
    ``shapes``, on the first rows of ``inputs`` (``k3_splice_inputs``;
    ``_check_and_time``). ``make(within, incl, ends)`` returns a call that
    computes it: one splice launch, or, for a checkout without
    ``bucket_splice``, the gathers, adds and selects of its
    ``msm._bucket_sums``; ``plain`` takes the same arguments.
    ``scripts/time_kernels.py`` runs it on another checkout's wrappers."""
    out = []
    for kind, m, b, npad, nchunks in shapes:
        within, incl = (tuple(c[:m] for c in part) for part in inputs[:2])
        ends = inputs[2][:m]
        if (ends.shape[1], within[0].shape[1], incl[0].shape[1]) != (b, npad, nchunks):
            raise ValueError(f"K3-splice inputs do not hold the shape {(m, b, npad, nchunks)}")
        out.append(_check_and_time(
            dict(kind=kind, rows=m, buckets=b, npad=npad, nchunks=nchunks),
            make(within, incl, ends), ends,
            plain and (lambda w=within, i=incl, e=ends: plain(w, i, e)),
            f"K3-splice at {m} rows x {b} buckets"))
    return out


def _empty_launch(report):
    """An empty launch (a zero-cycle spin) timed on the card alone and paced
    by the host."""
    import torch

    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    empty = torch.zeros(1, device="cuda")
    step = lambda x: (torch.cuda._sleep(0), x)[1]  # noqa: E731
    report["empty_launch"] = dict(ms=queued_ms(step, empty, 200),
                                  host_paced_ms=chain_ms(step, empty, 200))
    line("[6 empty] empty launch: card {ms:.4f} ms, host-paced {host_paced_ms:.4f} ms".format(
        **report["empty_launch"]))


K1_MODES = ("same", "cycle", "repeat")  # K1's recorded broadcast modes, cuda_mont.BCAST's order
K1_STAGED_FROM = 229_376  # K1 beside P2's staged tiles at the path's shapes of this many products


def k1_operands(n: int, nb: int, mode: int, a, b) -> tuple:
    """The ``vecfield.mont_mul`` operands of a recorded K1 shape (n
    products, nb rows of b, broadcast mode) from the first n elements of a
    and nb of b: (n, 8) x (n, 8); cycle (n / nb, nb, 8) x (nb, 8); repeat
    (nb, n / nb, 8) x (nb, 1, 8)."""
    x, y = a[:n], b[:nb]
    if mode == 1:
        return x.view(n // nb, nb, 8), y
    if mode == 2:
        return x.view(nb, n // nb, 8), y.view(nb, 1, 8)
    return x, y


def k1_times(mul, shapes, plain=None) -> list:
    """K1 at each (kind, n, nb, mode) of ``shapes``: ``mul(x, y)`` (a
    checkout's ``vecfield.mont_mul``, which reads a broadcast operand in
    place or materialises it first) on ``k1_operands`` of random BN254 Fr
    elements, hashed (``digest``) and, given ``plain(x, y)``, held bitwise
    against it (``plain_ms``); then ms per call on the card alone
    (``queued_ms``, QUEUED_ITERS calls). ``scripts/time_kernels.py`` runs it
    on another checkout's ``vecfield.mont_mul``."""
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    fc = vecfield.consts(BN254_FR)
    a = mont_layout.random_elements(fc, max(s[1] for s in shapes), 31, "cuda")
    b = mont_layout.random_elements(fc, max(s[2] for s in shapes), 32, "cuda")
    out = []
    for kind, n, nb, mode in shapes:
        x, y = k1_operands(n, nb, mode, a, b)
        got = mul(x, y)
        res = dict(kind=kind, n=n, nb=nb, mode=mode, digest=_digest((got,)))
        if plain is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(x, y)
            torch.cuda.synchronize()
            res["plain_ms"] = (time.perf_counter() - t0) * 1e3
            res["max_abs_err"] = _max_abs_err(got, want)
            if res["max_abs_err"]:
                raise AssertionError(f"K1 at {n} products, {nb} rows of b ({K1_MODES[mode]}), "
                                     f"differs from its plain version")
        del got
        res["ms"] = queued_ms(lambda v, y=y: mul(v, y), x, QUEUED_ITERS)
        out.append(res)
    return out


def phase_k1(report, kernels):
    """K1 at every shape (products, rows of b, broadcast mode) one warm
    prove launches it with, on random BN254 Fr operands through
    ``vecfield.mont_mul`` (``k1_times``): each bitwise against the plain
    product of the materialised operands and timed on the card alone. The
    2^20 parity row is phase 3's. Then K1 beside P2's staged tiles (d') at
    the path's shapes of at least K1_STAGED_FROM products, both with b of
    a's shape."""
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    fc = vecfield.consts(BN254_FR)
    hist = {tuple(c[:-1]): c[-1] for c in report["flagship"]["k1_calls_per_warm_prove"]}
    out = k1_times(
        lambda x, y: vecfield.mont_mul(fc, x, y), [("path", *s) for s in sorted(hist)],
        plain=lambda x, y: cuda_mont.mont_mul_plain(
            fc, *[t.contiguous() for t in torch.broadcast_tensors(x, y)]))
    for r in out:
        r["launches_per_warm_prove"] = hist[r["n"], r["nb"], r["mode"]]
    k1 = kernels["K1"]
    out.append(dict(kind="parity", n=1 << 20, nb=1 << 20, mode=0, launches_per_warm_prove=0,
                    max_abs_err=k1["max_abs_err"], ms=k1["ms"]))
    k1["max_abs_err"] = max(r["max_abs_err"] for r in out)
    report["k1"] = dict(shapes=out)
    card = sum(r["launches_per_warm_prove"] * r["ms"] for r in out)
    report["k1"]["card_ms_per_warm_prove"] = card
    line(f"[6 K1] {len(hist)} path shapes, {min(s[0] for s in hist)} to {max(s[0] for s in hist)} "
         f"products per launch, {sum(hist.values())} launches per warm prove: all bitwise equal "
         f"| card time per warm prove (sum of launches x queued ms) {card:.3f} ms")
    for mode, name in enumerate(K1_MODES):
        rows = [r for r in out if r["kind"] == "path" and r["mode"] == mode]
        line(f"[6 K1] {name}: {len(rows)} shapes, "
             f"{sum(r['launches_per_warm_prove'] for r in rows)} launches per warm prove: "
             + ", ".join(f"{r['n']} x {r['nb']} rows ({r['launches_per_warm_prove']})"
                         for r in rows))
    # K1's 16-byte vector loads against P2's staged tiles (d'), b of a's shape
    staged = []
    for n in sorted({r["n"] for r in out if r["kind"] == "path" and r["n"] >= K1_STAGED_FROM}):
        a = mont_layout.random_elements(fc, n, 43, "cuda")
        b = mont_layout.random_elements(fc, n, 44, "cuda")
        if _max_abs_err(mont_layout.mont_mul_staged(fc, a, b, P2_THREADS),
                        cuda_mont.mont_mul(fc, a, b)):
            raise AssertionError(f"P2 (d') differs from K1 at {n} products")
        row = dict(n=n, bytes_ms=n * 96 / HBM_BYTES_S * 1e3,
                   k1_ms=queued_ms(lambda v, b=b: cuda_mont.mont_mul(fc, v, b), a, QUEUED_ITERS),
                   staged_ms=queued_ms(lambda v, b=b: mont_layout.mont_mul_staged(
                       fc, v, b, P2_THREADS), a, QUEUED_ITERS))
        staged.append(row)
        line(f"[6 K1] {n} products, b of a's shape: K1 {row['k1_ms']:.4f} ms "
             f"({row['bytes_ms'] / row['k1_ms'] * 100:.1f} % of the byte bound), P2 staged "
             f"(d', {P2_THREADS} threads) {row['staged_ms']:.4f} ms "
             f"({row['bytes_ms'] / row['staged_ms'] * 100:.1f} %)")
    report["k1"]["staged"] = staged


POW_BIG = 1 << 14  # K1-pow's throughput shape: about one block of 128 threads per SM
# inversions per timed chain: a checkout whose exponentiation is one K1 launch
# per product queues ~380 launches per inversion, and the chain must stay
# within the card's launch queue
K1_POW_ITERS = 2


def inversion_products(e: int) -> int:
    """The dependent products of a left-to-right square-and-multiply to the
    power e >= 1: a squaring per bit below the top, a multiply per set bit
    below it."""
    return e.bit_length() - 1 + bin(e).count("1") - 1


def k1_pow_times(inv, shapes, plain=None) -> list:
    """The field inversion over BN254 Fr (K1-pow to the power p - 2) at each
    (kind, n) of ``shapes``, on the first n of POW_BIG random elements
    (``_check_and_time``): ``inv(x)``, hashed and, given ``plain(x)``, held
    bitwise against it; K1_POW_ITERS calls per timed chain.
    ``scripts/time_kernels.py`` runs it on another checkout's
    ``vecfield.inv``."""
    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    fc = vecfield.consts(BN254_FR)
    xs = mont_layout.random_elements(fc, max(n for _, n in shapes), 35, "cuda")
    out = []
    for kind, n in shapes:
        x = xs[:n]
        out.append(_check_and_time(
            dict(kind=kind, n=n, products=inversion_products(BN254_FR.p - 2)),
            lambda x=x: inv(x), x, plain and (lambda x=x: plain(x)),
            f"K1-pow at {n} elements", iters=K1_POW_ITERS))
    return out


def phase_k1_pow(report, kernels):
    """K1-pow at the shapes one warm prove launches it with (the one field
    inversion) and at POW_BIG elements (``k1_pow_times``); one launch per
    warm prove."""
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    f = report["flagship"]
    e = BN254_FR.p - 2
    fc = vecfield.consts(BN254_FR)
    per_prove = f["launches_per_warm_prove"]
    if per_prove["K1-pow"] != 1:
        raise AssertionError(f"K1-pow launched {per_prove['K1-pow']} times per warm prove, "
                             f"expected 1 (the one field inversion)")
    hist = {}
    for n, bits, calls in f["k1_pow_calls_per_warm_prove"]:
        if bits != e.bit_length():
            raise AssertionError(f"K1-pow to a {bits}-bit power on the path: only the inversion "
                                 f"(a {e.bit_length()}-bit power) is timed")
        hist[n] = calls
    shapes = [("path", n) for n in sorted(hist)] + [("parity", POW_BIG)]
    out = k1_pow_times(lambda x: cuda_mont.mont_pow(fc, x, e), shapes,
                       plain=lambda x: cuda_mont.mont_pow_plain(fc, x, e))
    empty = report["empty_launch"]["ms"]
    for r in out:
        r["launches_per_warm_prove"] = hist.get(r["n"], 0) if r["kind"] == "path" else 0
        line(f"[6 K1-pow] {r['kind']} n={r['n']}: bitwise equal | card {r['ms']:.4f} ms for a "
             f"chain of {r['products']} dependent products ({r['ms'] / r['products'] * 1e3:.3f} "
             f"us each; empty launch {empty:.4f} ms), host-paced {r['host_paced_ms']:.4f} ms, "
             f"plain {r['plain_ms']:.1f} ms | {r['launches_per_warm_prove']} launches per warm "
             f"prove")
    report["k1_pow"] = dict(shapes=out)
    row = _path_row(out, "n")
    kernels["K1-pow"].update(
        **_row_fields(kernels["K1-pow"], row),
        shape=f"{row['n']} element, e = p - 2 over BN254 Fr (the inversion of batch_inv_nz; a "
              f"chain of {row['products']} products)")


def k1_prefix_times(prefix, shapes, plain=None) -> list:
    """The prefix product over BN254 Fr at each (kind, rows, n, reverse) of
    ``shapes``: ``prefix(x, reverse)`` on the first rows of random rows, their
    first n elements (the last n when reversed), hashed (``digest``) and,
    given ``plain(x, reverse)``, held bitwise against one plain run per
    direction over that direction's most rows and longest n (a prefix of the
    first n elements is the first n prefixes, a suffix product of the last n
    the last n; ``plain_ms`` is that run's); then ms per call on the card
    alone (``queued_ms``, K3_SCAN_ITERS calls) and host-paced.
    ``scripts/time_kernels.py`` runs it on another checkout's
    ``vecfield.prefix_mul``."""
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR
    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    fc = vecfield.consts(BN254_FR)
    m_top, n_top = max(m for _, m, _, _ in shapes), max(n for _, _, n, _ in shapes)
    xs = mont_layout.random_elements(fc, m_top * n_top, 37, "cuda").view(m_top, n_top, 8)
    want, out = {}, []
    for kind, m, n, rev in shapes:
        x = (xs[:m, -n:] if rev else xs[:m, :n]).contiguous()
        got = prefix(x, rev)
        res = dict(kind=kind, rows=m, n=n, reverse=rev, digest=_digest((got,)))
        if plain is not None:
            top = (max(m_ for _, m_, _, r_ in shapes if r_ == rev),
                   max(n_ for _, _, n_, r_ in shapes if r_ == rev))
            if rev not in want:
                whole = (xs[:top[0], -top[1]:] if rev else xs[:top[0], :top[1]]).contiguous()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want[rev] = plain(whole, rev)
                torch.cuda.synchronize()
                want[rev, "ms"] = (time.perf_counter() - t0) * 1e3
            w = want[rev][:m, -n:] if rev else want[rev][:m, :n]
            res["max_abs_err"] = _max_abs_err(got, w)
            if res["max_abs_err"]:
                raise AssertionError(f"K1-prefix at {m} x {n}, reverse {rev}, differs from its "
                                     f"plain version")
            if (m, n) == top:
                res["plain_ms"] = want[rev, "ms"]
        del got
        step = lambda q, x=x, rev=rev: (prefix(x, rev), q)[1]  # noqa: E731
        res.update(ms=queued_ms(step, x, K3_SCAN_ITERS),
                   host_paced_ms=chain_ms(step, x, K3_SCAN_ITERS))
        out.append(res)
    return out


def phase_k1_prefix(report, kernels):
    """K1-prefix at the shapes one warm prove launches it with
    (``k1_prefix_times``); at most three launches per call. Then K1's,
    K1-pow's and K1-prefix's launches per warm prove."""
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    f = report["flagship"]
    fc = vecfield.consts(BN254_FR)
    per_prove = f["launches_per_warm_prove"]
    hist = {(m, n, rev): calls for m, n, rev, calls in f["k1_prefix_calls_per_warm_prove"]}
    calls = sum(hist.values())
    want = sum(k * cuda_mont.prefix_launches(n) for (_, n, _), k in hist.items())
    if per_prove["K1-prefix"] != want or per_prove["K1-prefix"] > 3 * calls:
        raise AssertionError(f"K1-prefix launched {per_prove['K1-prefix']} times per warm prove "
                             f"over {calls} calls, expected {want}")
    out = k1_prefix_times(lambda x, rev: cuda_mont.mont_prefix(fc, x, rev),
                          [("path", *k) for k in sorted(hist)],
                          plain=lambda x, rev: cuda_mont.mont_prefix_plain(fc, x, rev))
    for r in out:
        r["calls_per_warm_prove"] = hist[r["rows"], r["n"], r["reverse"]]
        r["launches_per_call"] = cuda_mont.prefix_launches(r["n"])
        r["launches_per_warm_prove"] = r["calls_per_warm_prove"] * r["launches_per_call"]
        line(f"[6 K1-prefix] path rows={r['rows']} n={r['n']} reverse={r['reverse']}: bitwise "
             f"equal | card {r['ms']:.4f} ms per call ({r['launches_per_call']} launches), "
             f"host-paced {r['host_paced_ms']:.4f} ms"
             + (f", plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
             + f" | {r['calls_per_warm_prove']} calls per warm prove")
    report["k1_prefix"] = dict(shapes=out)
    row = max((r for r in out if "plain_ms" in r), key=lambda r: r["rows"] * r["n"])
    kernels["K1-prefix"].update(
        **_row_fields(kernels["K1-prefix"], row),
        shape=f"{row['rows']} x {row['n']} elements, reverse {row['reverse']} (the flagship's "
              f"longest prefix product; ms per call of {row['launches_per_call']} launches)")
    line(f"[6 K1-prefix] launches per warm prove: K1 mont_mul {per_prove['K1']}, K1-pow "
         f"{per_prove['K1-pow']}, K1-prefix {per_prove['K1-prefix']} over {calls} prefix_mul "
         f"calls")


def k2_inputs(m: int, c: int):
    """K2's inputs on the card: start points (m, 8) and affine rows (m, c, 8)
    drawn from 2^16 curve points (``_test_points``). Every start is the
    identity (0 : 1 : 0), as in the bucket scan, but rows 2 and 3, which
    start at a projective point with random Z. Row 0 adds A then A (P+P at
    step 2), row 1 D then -D (P+(-P)), row 2 its own start's point (P+P) and
    row 3 its start's negation. A shape (m', c') takes the first m' rows and
    c' columns."""
    import torch

    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.prover import g1_vec

    _, (ax, ay), proj = _test_points(K4_BIG, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    idx = torch.randint(0, K4_BIG, (m, c), device="cuda", generator=gen)
    idx[0, 1], idx[1, 1], idx[2, 0], idx[3, 0] = idx[0, 0], idx[1, 0], 2, 3
    x, y = ax[idx], ay[idx]
    for i, j in ((1, 1), (3, 0)):
        y[i, j] = vecfield.sub(g1_vec.FQ, torch.zeros_like(y[i, j]), y[i, j])
    start = g1_vec.identity((m,), device="cuda")
    start = tuple(torch.cat([i[:2], pc[2:4], i[4:]]) for i, pc in zip(start, proj))
    return start, (x, y)


def _prefix_rows(res):
    """The prefixes as (m, c, 8) coordinates, from a scan's output or from a
    list of c single adds' outputs."""
    import torch

    if isinstance(res, list):
        return tuple(torch.stack(coord, dim=1) for coord in zip(*res))
    return res


def _digest(coords) -> str:
    h = hashlib.sha256()
    for t in coords:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k2_times(make, shapes, start, rows, plain=None) -> list:
    """K2 at each (kind, m, c) of ``shapes``, on the first m start points and
    the first c columns of their rows. ``make(s, r)`` returns a call that
    computes every prefix: one scan launch, or, for a checkout whose K2 is
    one add per launch, c adds on inputs sliced beforehand (a list of their
    outputs). Its prefixes' sha256 is kept (``digest``, for comparing
    checkouts); given ``plain(s, r)``, they are held bitwise against the
    plain version, run once per c at the largest m (each shape compares its
    first m rows; ``plain_ms`` is that run's). Then ms per call on the card
    alone (``queued_ms``) and paced by the host (``chain_ms``).
    ``scripts/time_kernels.py`` runs it on another checkout's wrappers."""
    import torch

    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    want, out = {}, []
    for kind, m, c in shapes:
        s = tuple(t[:m] for t in start)
        r = tuple(t[:m, :c].contiguous() for t in rows)
        call = make(s, r)
        got = _prefix_rows(call())
        res = dict(kind=kind, m=m, c=c, digest=_digest(got))
        if plain is not None:
            top = max(m_ for _, m_, c_ in shapes if c_ == c)
            if c not in want:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want[c] = plain(tuple(t[:top] for t in start),
                                tuple(t[:top, :c].contiguous() for t in rows))
                torch.cuda.synchronize()
                want[c, "ms"] = (time.perf_counter() - t0) * 1e3
            res["max_abs_err"] = _max_abs_err(got, tuple(w[:m] for w in want[c]))
            if res["max_abs_err"]:
                raise AssertionError(f"K2 at {m} rows x C {c} differs from its plain version")
            if m == top:
                res["plain_ms"] = want[c, "ms"]
        del got
        step = lambda q: (call(), q)[1]  # noqa: E731
        res.update(ms=queued_ms(step, s[0], K2_ITERS),
                   host_paced_ms=chain_ms(step, s[0], K2_ITERS))
        out.append(res)
    return out


# the k=18 cell's NTTs are the flagship's at 8x the rows: its circuit has the
# same 8 wires and 3 lookup tables, so the same polys a call
NTT_K18_SHIFT = 3
# stage launches per queued_ms chain: ~50 NTTs of 15-21 launches each
# outgrew the card's launch queue (the host then waited)
NTT_QUEUED_LAUNCHES = 256


def ntt_times(shapes) -> list:
    """The NTT at each (kind, polys, log_n, inverse) of ``shapes`` on random
    BN254 Fr polys: the kernel bitwise against the torch stage loop
    (``plain_ms``, one synchronised run), then ms per NTT on the card alone
    (``queued_ms``) and per stage, beside its bytes bound (each stage reads
    and writes every element once, 64 bytes, over HBM_BYTES_S)."""
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.prover import ntt

    out = []
    for kind, polys, log_n, inverse in shapes:
        x = mont_layout.random_elements(ntt.FR, polys << log_n, 47 + log_n, "cuda")
        x = x.view(polys, 1 << log_n, 8)
        got = ntt._ntt_graph(x, log_n, bool(inverse))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ntt._ntt_loop(x, log_n, bool(inverse))
        torch.cuda.synchronize()
        res = dict(kind=kind, polys=polys, log_n=log_n, inverse=inverse,
                   plain_ms=(time.perf_counter() - t0) * 1e3, max_abs_err=_max_abs_err(got, want),
                   digest=_digest((got,)))
        del got, want
        if res["max_abs_err"]:
            raise AssertionError(f"the NTT at {polys} x 2^{log_n}, inverse {inverse}, differs "
                                 f"from the torch loop")
        res["ms"] = queued_ms(lambda v, n=log_n, i=bool(inverse): (ntt._ntt_graph(x, n, i), v)[1],
                              x, max(1, NTT_QUEUED_LAUNCHES // log_n))
        res["stage_ms"] = res["ms"] / log_n
        res["bound_ms"] = (polys << log_n) * 64 * log_n / HBM_BYTES_S * 1e3
        res["share"] = res["bound_ms"] / res["ms"]
        out.append(res)
    return out


def phase_ntt(report, kernels):
    """[6 NTT] The NTT at every (polys, log_n, direction) one flagship warm
    prove calls it with, and at the same calls at k=18's sizes (log_n +
    NTT_K18_SHIFT): each bitwise against the torch loop, its time per NTT
    and per stage on the card alone beside its bytes bound, and the loop's
    time; log_n launches a call."""
    f = report["flagship"]
    hist = {(p, n, inv): calls for p, n, inv, calls in f["ntt_calls_per_warm_prove"]}
    want = sum(calls * n for (_, n, _), calls in hist.items())
    if f["launches_per_warm_prove"]["NTT"] != want:
        raise AssertionError(f"the NTT launched {f['launches_per_warm_prove']['NTT']} times per "
                             f"warm prove, {want} stages expected")
    shapes = [("path", *k) for k in sorted(hist)]
    shapes += [("k18", p, n + NTT_K18_SHIFT, inv) for _, p, n, inv in shapes]
    out = ntt_times(shapes)
    for r in out:
        r["calls_per_warm_prove"] = hist[r["polys"], r["log_n"] - NTT_K18_SHIFT * (r["kind"] == "k18"),
                                         r["inverse"]]
        line(f"[6 NTT] {r['kind']} {r['polys']} x 2^{r['log_n']} "
             f"{'inverse' if r['inverse'] else 'forward'} ({r['calls_per_warm_prove']} a warm "
             f"prove): bitwise equal | card {r['ms']:.4f} ms ({r['stage_ms']:.4f} a stage) vs "
             f"bytes bound {r['bound_ms']:.4f} ms = {r['share'] * 100:.1f} % | torch loop "
             f"{r['plain_ms']:.1f} ms")
    card = {kind: sum(r["calls_per_warm_prove"] * r["ms"] for r in out if r["kind"] == kind)
            for kind in ("path", "k18")}
    report["ntt"] = dict(shapes=out, card_ms_per_warm_prove=card)
    row = max((r for r in out if r["kind"] == "k18"), key=lambda r: r["polys"] << r["log_n"])
    kernels["NTT"].update(
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by="bytes",
        library_ms=None, max_abs_err=max(kernels["NTT"]["max_abs_err"], row["max_abs_err"]),
        shape=f"{row['polys']} x 2^{row['log_n']}, inverse {row['inverse']} (k=18's largest; "
              f"ms per NTT of {row['log_n']} launches)")
    line(f"[6 NTT] {len(hist)} path shapes, {sum(hist.values())} calls and {want} launches per "
         f"warm prove | card time per warm prove (sum of calls x queued ms): flagship "
         f"{card['path']:.3f} ms, the same calls at k=18's sizes {card['k18']:.3f} ms")


def phase_k2(report, kernels):
    """K2 at the path's shapes and at 2^16 points with C = 1
    (``k2_times``)."""
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    hist = {(m, c): n for m, c, n in report["flagship"]["g1_calls_per_warm_prove"]["K2"]}
    shapes = [("path", m, c) for m, c in sorted(hist, reverse=True)] + [("parity", K4_BIG, 1)]
    start, rows = k2_inputs(max(m for _, m, _ in shapes), max(c for _, _, c in shapes))
    out = k2_times(lambda s, r: lambda: cuda_g1.point_scan_mixed(fq, s, r), shapes, start, rows,
                   plain=lambda s, r: cuda_g1.point_scan_mixed_plain(fq, s, r))
    for r in out:
        r["launches_per_warm_prove"] = hist.get((r["m"], r["c"]), 0)
        line(f"[6 K2] {r['kind']} m={r['m']} C={r['c']}: bitwise equal | card {r['ms']:.4f} ms "
             f"({r['ms'] / r['c'] * 1e3:.2f} us per add step), host-paced "
             f"{r['host_paced_ms']:.4f} ms"
             + (f", plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
             + f" | {r['launches_per_warm_prove']} launches per warm prove")
    report["k2"] = dict(shapes=out)
    # the kernels line's K2 row: the path's largest shape
    row = max((r for r in out if r["kind"] == "path"), key=lambda r: r["m"])
    kernels["K2"].update(
        ms=row["ms"], host_paced_ms=row["host_paced_ms"], plain_ms=row["plain_ms"],
        max_abs_err=max([kernels["K2"]["max_abs_err"]] + [r["max_abs_err"] for r in out]),
        shape=f"{row['m']} rows x C {row['c']} (the bucket scan of one pipeline of the "
              f"flagship's largest msm_many call)", timing="queued",
    )


def _row_fields(kernel, row) -> dict:
    """A kernels-line row's times from one shape's timing (every shape's
    error is 0, or its timing raised)."""
    return dict(ms=row["ms"], host_paced_ms=row["host_paced_ms"], plain_ms=row["plain_ms"],
                max_abs_err=max(kernel["max_abs_err"], row["max_abs_err"]), timing="queued")


def phase_k3(report, kernels):
    """K3 at the path's shapes and at 2^16 points (``k3_times``), and its
    row scans at theirs (``k3_scan_times``)."""
    import torch

    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    hist = {n: k for n, k in report["flagship"]["g1_calls_per_warm_prove"]["K3"]}
    shapes = [("path", n) for n in sorted(hist, reverse=True)] + [("parity", K4_BIG)]
    out = k3_times(lambda p, q: cuda_g1.point_add(fq, p, q),
                   lambda p, q: cuda_g1.point_add_plain(fq, p, q), shapes, k4_points())
    for r in out:
        r["launches_per_warm_prove"] = hist.get(r["n"], 0) if r["kind"] == "path" else 0
        line(f"[6 K3] {r['kind']} n={r['n']}: bitwise equal | card {r['ms']:.4f} ms, host-paced "
             f"{r['host_paced_ms']:.4f} ms"
             + (f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else "")
             + f" | {r['launches_per_warm_prove']} launches per warm prove")
    report["k3"] = dict(shapes=out)
    # the kernels line's K3 row: the path's largest shape
    row = _path_row(out, "n")
    kernels["K3"].update(**_row_fields(kernels["K3"], row),
                         shape=f"{row['n']} points (the flagship's widest K3 launch)")

    # the row scans at their recorded shapes, with the wrappers' cluster
    # choice, then with every cluster size
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hist = {(m, n, t): k for m, n, t, k in report["flagship"]["g1_calls_per_warm_prove"]["K3-scan"]}
    shapes = [("path", m, n, t) for m, n, t in sorted(hist, reverse=True)]
    rows = k3_scan_inputs(max(m for _, m, _, _ in shapes), max(n for _, _, n, _ in shapes))
    wrapper = {0: cuda_g1.point_scan, 1: cuda_g1.point_scan_sum}
    plain = {0: cuda_g1.point_scan_plain, 1: cuda_g1.point_scan_sum_plain}
    out = k3_scan_times(lambda s, t: lambda: wrapper[t](fq, s), shapes, rows,
                        plain=lambda s, t: plain[t](fq, s))
    for r in out:
        r["launches_per_warm_prove"] = hist[r["rows"], r["len"], r["tree"]]
        r["cluster"] = cuda_g1.scan_cluster(r["rows"], r["len"], bool(r["tree"]), sms)
        r["cluster_ms"] = {}
        for k in K3_SCAN_CLUSTERS:
            (t,) = k3_scan_times(
                lambda s, t_, k=k: lambda: cuda_g1._scan_rows(fq, s, bool(t_), k),
                [(r["kind"], r["rows"], r["len"], r["tree"])], rows)
            if t["digest"] != r["digest"]:
                raise AssertionError(f"K3-scan with {k} blocks per row differs at {r['rows']} "
                                     f"rows x {r['len']}")
            r["cluster_ms"][k] = t["ms"]
        line(f"[6 K3-scan] path rows={r['rows']} L={r['len']} tree={r['tree']}: bitwise equal | "
             f"card {r['ms']:.4f} ms ({r['cluster']} blocks per row), host-paced "
             f"{r['host_paced_ms']:.4f} ms, plain {r['plain_ms']:.1f} ms | blocks per row: "
             + ", ".join(f"{k} {ms:.4f}" for k, ms in r["cluster_ms"].items())
             + f" ms | {r['launches_per_warm_prove']} launches per warm prove")
    report["k3_scan"] = dict(shapes=out)
    kernels["K3-scan"].update(
        **_row_fields(kernels["K3-scan"], max(out, key=lambda r: r["rows"] * r["len"])),
        shape="{rows} rows x {len} points, tree {tree}, {cluster} blocks per row (the "
              "flagship's widest row scan)".format(**max(out, key=lambda r: r["rows"] * r["len"])))

    # the bucket splice at its recorded shapes
    recorded = report["flagship"]["g1_calls_per_warm_prove"]["K3-splice"]
    hist = {tuple(k[:4]): k[4] for k in recorded}
    shapes = [("path", *k) for k in sorted(hist, reverse=True)]
    rows, b, npad, nchunks = shapes[0][1:]
    out = k3_splice_times(lambda w, i, e: lambda: cuda_g1.bucket_splice(fq, w, i, e), shapes,
                          k3_splice_inputs(rows, b, npad, nchunks),
                          plain=lambda w, i, e: cuda_g1.bucket_splice_plain(fq, w, i, e))
    for r in out:
        r["launches_per_warm_prove"] = hist[r["rows"], r["buckets"], r["npad"], r["nchunks"]]
        line(f"[6 K3-splice] path rows={r['rows']} buckets={r['buckets']} npad={r['npad']} "
             f"nchunks={r['nchunks']}: bitwise equal | card {r['ms']:.4f} ms, host-paced "
             f"{r['host_paced_ms']:.4f} ms, plain {r['plain_ms']:.1f} ms | "
             f"{r['launches_per_warm_prove']} launches per warm prove")
    report["k3_splice"] = dict(shapes=out)
    row = max(out, key=lambda r: r["rows"] * r["buckets"])
    kernels["K3-splice"].update(
        **_row_fields(kernels["K3-splice"], row),
        shape="{rows} rows x {buckets} buckets over {npad} points in {nchunks} chunks (the "
              "flagship's widest splice)".format(**row))


def phase_k4(report, kernels):
    """K4 at the path's shapes and at 2^16 points (``k4_times``)."""
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    per_shape = {(n, reps): k for n, reps, k in report["flagship"]["g1_calls_per_warm_prove"]["K4"]}
    shapes = [("path", n, reps) for n, reps in sorted(per_shape)] + \
        [("parity", K4_BIG, 1), ("parity", K4_BIG, 8)]
    out = k4_times(lambda p, reps: cuda_g1.point_double(fq, p, reps),
                   lambda p, reps: cuda_g1.point_double_plain(fq, p, reps), shapes, k4_points())
    for r in out:
        r["launches_per_warm_prove"] = per_shape.get((r["n"], r["reps"]), 0)
        line(f"[6 K4] {r['kind']} n={r['n']} reps={r['reps']}: bitwise equal | card "
             f"{r['ms']:.4f} ms ({r['ms'] / r['reps']:.4f} per doubling), host-paced "
             f"{r['host_paced_ms']:.4f} ms"
             + (f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else "")
             + f" | {r['launches_per_warm_prove']} launches per warm prove")
    report["k4"] = dict(shapes=out)
    # the kernels line's K4 row: the path's largest shape
    row = max((r for r in out if r["kind"] == "path"), key=lambda r: r["n"])
    kernels["K4"].update(
        ms=row["ms"], host_paced_ms=row["host_paced_ms"], plain_ms=row["plain_ms"],
        max_abs_err=max([kernels["K4"]["max_abs_err"]] + [r["max_abs_err"] for r in out]),
        shape=f"{row['n']} points, reps {row['reps']} (one Horner window of the flagship's "
              f"largest msm_many call)", timing="queued",
    )


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
    # the kernels line's time: each body queued behind a spin kernel (the
    # timed run's chain, paced by the host, is kept as host_paced_ms)
    queued = {body: queued_ms(lambda v, body=body: vpu_ops.int_ops(body, v, y, P1_REPS), x,
                              QUEUED_ITERS) for body in vpu_ops.BODIES}
    kernels["P1"] = dict(
        name="int_ops", route="cuda", source="halo2_rsa_tpu_torch/csrc/int_ops.cu",
        replaces="scripts/bench_vpu_ops.py:50", launches=launches, max_abs_err=worst,
        ms=sum(queued.values()), host_paced_ms=sum(r["ms"] for r in res["bodies"].values()),
        plain_ms=sum(plain_ms.values()),
        shape=f"7 bodies x (16, 2^{P1_LOG_N}) lanes, REPS {P1_REPS} (times summed over bodies)",
        timing="queued",
    )
    line(f"[7 P1] launches in the timed run: {launches} | queued on the card: " + ", ".join(
        f"{b} {ms:.4f}" for b, ms in queued.items()) + " ms")


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
    # the kernels line's times: queued behind a spin kernel (the timed run's
    # chains, paced by the host, are kept as host_paced_ms)
    q_lm = queued_ms(cases["P2-lm"][0], at, QUEUED_ITERS)
    q_staged = queued_ms(cases[f"P2-staged-{P2_THREADS}"][0], a, QUEUED_ITERS)
    line(f"[8 P2] queued on the card: b' {q_lm:.4f} ms, d'{P2_THREADS} {q_staged:.4f} ms")
    common = dict(route="cuda", source="halo2_rsa_tpu_torch/csrc/mont_layout.cu",
                  replaces="scripts/bench_mont_layout.py:110", timing="queued")
    kernels["P2-lm"] = dict(
        name="mont_mul_lm", launches=launches["mont_mul_lm"], max_abs_err=errs["P2-lm"],
        ms=q_lm, host_paced_ms=res["variants"]["b'"]["ms"], plain_ms=plain_ms["P2-lm"],
        shape=f"2^{P2_LOG_N} products", **common)
    kernels["P2-staged"] = dict(
        name="mont_mul_staged<" + "|".join(map(str, mont_layout.THREADS)) + ">",
        launches=launches["mont_mul_staged"],
        max_abs_err=max(v for k_, v in errs.items() if k_.startswith("P2-staged")),
        ms=q_staged, host_paced_ms=res["variants"][f"d'{P2_THREADS}"]["ms"],
        plain_ms=plain_ms["P2-staged"],
        shape=f"2^{P2_LOG_N} products; launches and max_abs_err over T in "
              f"{mont_layout.THREADS}, ms, plain_ms and the bound at T={P2_THREADS}", **common)


def _looped(sass, key: str, threads: int, steps: int, nbytes: int):
    """(threads, bytes per thread, SASS per thread) of one launch of K2 or
    K4: the loop body once per step (an add or a doubling), the rest (load,
    canonicalisation, store) once."""
    body, rest = sass[key]["body"], sass[key]["rest"]
    return (threads, nbytes,
            {f: body[f] * steps + rest[f] for f in ("fma", "alu", "issued", "int")})


def _k2_part(sass, r):
    # reads 3 start coordinates and 2 per step, writes 3 per step
    return _looped(sass, "K2", r["m"], r["c"], (5 * r["c"] + 3) * 32)


def _k4_part(sass, r):
    return _looped(sass, "K4", r["n"], r["reps"], 6 * 32)


def _k3_part(sass, r):
    # reads 6 coordinates and writes 3 per point
    return (r["n"], 9 * 32, sass["K3"])


def _splice_part(sass, r):
    # per (row, bucket) thread: the whole kernel (three adds); reads at most
    # 4 points and one end, writes 1 point
    return (r["rows"] * r["buckets"], 4 * 96 + 8 + 96, sass["K3-splice"])


def scan_adds(n: int, tree: int) -> int:
    """The adds of one row scan over n points: n - d in each round d = 1, 2,
    4, ... < n, and msize - 1 in the halving tree."""
    adds = sum(n - (1 << s) for s in range((n - 1).bit_length()))
    return adds + ((1 << max(1, (n - 1).bit_length())) - 1 if tree else 0)


def _scan_part(sass, r):
    # per row: its adds at K3's SASS per add (the elementwise kernel's, load
    # and store included); reads 3 coordinates per point, writes 3 per point
    # (the scan) or per row (the tree)
    adds = scan_adds(r["len"], r["tree"])
    nbytes = 96 * r["len"] + 96 * (1 if r["tree"] else r["len"])
    return (r["rows"], nbytes, {f: sass["K3"][f] * adds for f in ("fma", "alu", "issued", "int")})


def _k1_part(sass, r):
    # reads a and writes out per product, and b's nb rows once
    return (r["n"], 64 + 32 * r["nb"] / r["n"], sass[("K1", "K1/cycle", "K1/repeat")[r["mode"]]])


def _prefix_part(sass, r):
    # reads and writes each element once; the n - 1 products a row's prefix
    # product needs at least, at K1's SASS per product
    return (r["rows"] * r["n"], 64,
            {f: sass["K1"][f] * (r["n"] - 1) / r["n"] for f in ("fma", "alu", "issued", "int")})


def _pow_part(sass, r):
    # reads and writes 1 element; its chain of products at K1's SASS per
    # product (the ops bound of one thread's chain: ~0 at n = 1)
    return (r["n"], 64, {f: sass["K1"][f] * r["products"] for f in ("fma", "alu", "issued", "int")})


def shape_bound(report, n: int, nbytes: int, counts: dict) -> dict:
    """The least time of one launch over n elements of nbytes each, whose
    SASS per element is ``counts``: the larger of its bytes over HBM_BYTES_S
    and its instructions over the pipes' and issue's rates (phase 9's
    ``int_rate``)."""
    rate = report["int_rate"]
    mem = n * nbytes / HBM_BYTES_S * 1e3
    ops = n * max(counts["fma"] / rate["pipe_per_s"], counts["alu"] / rate["pipe_per_s"],
                  counts["issued"] / rate["issue_per_s"]) * 1e3
    return dict(bound_ms=max(mem, ops), bound_by="bytes" if mem >= ops else "operations",
                bytes_ms=mem, ops_ms=ops)


def _path_row(shapes, size: str):
    return max((r for r in shapes if r["kind"] == "path"), key=lambda r: r[size])


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
        "K1-pow": [_pow_part(sass, _path_row(report["k1_pow"]["shapes"], "n"))],
        "K1-prefix": [_prefix_part(sass, max(
            (r for r in report["k1_prefix"]["shapes"] if "plain_ms" in r),
            key=lambda r: r["rows"] * r["n"]))],
        "K2": [_k2_part(sass, _path_row(report["k2"]["shapes"], "m"))],
        "K3": [_k3_part(sass, _path_row(report["k3"]["shapes"], "n"))],
        "K3-scan": [_scan_part(sass, max(report["k3_scan"]["shapes"],
                                         key=lambda r: r["rows"] * r["len"]))],
        "K3-splice": [_splice_part(sass, max(report["k3_splice"]["shapes"],
                                             key=lambda r: r["rows"] * r["buckets"]))],
        "K4": [_k4_part(sass, _path_row(report["k4"]["shapes"], "n"))],
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
    empty = report["empty_launch"]["ms"]
    line("[9 bounds] K3 SASS per add (the whole kernel: load, add, canonicalise, store): FMA "
         "pipe {fma}, ALU pipe {alu}, issued {issued}".format(**sass["K3"])
         + "; K3-splice per bucket (three adds): FMA pipe {fma}, ALU pipe {alu}, issued "
           "{issued}".format(**sass["K3-splice"]))
    for key, step in (("K2", "add"), ("K4", "doubling")):
        line(f"[9 bounds] {key} SASS per {step} (its loop body): FMA pipe {{fma}}, ALU pipe "
             "{alu}, issued {issued}".format(**sass[key]["body"])
             + "; once per thread (load, canonicalise, store): FMA pipe {fma}, ALU pipe {alu}, "
               "issued {issued}".format(**sass[key]["rest"]))
    # the next redesign's rank: launches per warm prove x (kernel ms - bound
    # ms), summed over each kernel's path shapes
    rank = {}
    for key, part, dims in (
            ("K1", _k1_part, None),
            ("K1-pow", _pow_part, lambda r: f"n={r['n']}, {r['products']} products per element"),
            ("K1-prefix", _prefix_part, lambda r: (
                f"rows={r['rows']} n={r['n']} reverse={r['reverse']}, {r['calls_per_warm_prove']} "
                f"calls of {r['launches_per_call']} launches")),
            ("K2", _k2_part, lambda r: f"m={r['m']} C={r['c']}"),
            ("K3", _k3_part, lambda r: f"n={r['n']}"),
            ("K3-scan", _scan_part, lambda r: (
                f"rows={r['rows']} L={r['len']} tree={r['tree']}: "
                f"{scan_adds(r['len'], r['tree'])} adds per row, {r['cluster']} blocks per row, "
                f"{min(sms, r['rows'] * r['cluster'])} of {sms} SMs busy at most")),
            ("K3-splice", _splice_part, lambda r: (
                f"rows={r['rows']} buckets={r['buckets']} npad={r['npad']} "
                f"nchunks={r['nchunks']}")),
            ("K4", _k4_part, lambda r: f"n={r['n']} reps={r['reps']}")):
        rank[key] = 0.0
        for r in report[key.lower().replace("-", "_")]["shapes"]:
            r.update(shape_bound(report, *part(sass, r)))
            # per call: K1-prefix's ms is a call's (one or three launches)
            calls = r.get("calls_per_warm_prove", r["launches_per_warm_prove"])
            rank[key] += calls * (r["ms"] - r["bound_ms"])
            if dims:
                line(f"[9 bounds] {key} {r['kind']} {dims(r)}: {r['ms']:.4f} ms vs bound "
                     f"{r['bound_ms']:.6f} ms ({r['bound_by']}; bytes {r['bytes_ms']:.6f}, "
                     f"pipes/issue {r['ops_ms']:.6f}); empty launch {empty:.4f} ms")
    # K1's path shapes in buckets of products per launch (2^(b-1), 2^b]
    buckets = collections.defaultdict(lambda: dict(shapes=0, launches=0, ms=0.0, bound_ms=0.0))
    for r in report["k1"]["shapes"]:
        if r["kind"] == "path":
            bk = buckets[(r["n"] - 1).bit_length()]
            bk["shapes"] += 1
            bk["launches"] += r["launches_per_warm_prove"]
            bk["ms"] += r["launches_per_warm_prove"] * r["ms"]
            bk["bound_ms"] += r["launches_per_warm_prove"] * r["bound_ms"]
    report["k1"]["buckets"] = {b: buckets[b] for b in sorted(buckets)}
    for b, bk in report["k1"]["buckets"].items():
        line(f"[9 bounds] K1 path, {1 << max(b - 1, 0)}-{1 << b} products per launch: "
             f"{bk['shapes']} shapes, {bk['launches']} launches per warm prove, "
             f"{bk['ms']:.4f} ms (sum of launches x queued ms) vs bound {bk['bound_ms']:.6f} ms "
             f"= {bk['bound_ms'] / bk['ms'] * 100:.1f} % of bound")
    k1 = report["k1"]
    line(f"[9 bounds] K1 over its path shapes: {k1['card_ms_per_warm_prove']:.4f} ms of card time "
         f"per warm prove, rank {rank['K1']:.4f} ms (bound {k1['card_ms_per_warm_prove'] - rank['K1']:.4f} "
         f"ms); at the 2^20 parity shape {kernels['K1']['ms']:.4f} ms vs bound "
         f"{kernels['K1']['bound_ms']:.4f} ms")
    family = {"K1": k1["card_ms_per_warm_prove"]}
    for key in ("K1-pow", "K1-prefix"):
        family[key] = sum(r.get("calls_per_warm_prove", r["launches_per_warm_prove"]) * r["ms"]
                          for r in report[key.lower().replace("-", "_")]["shapes"])
    report["k1_family_card_ms_per_warm_prove"] = family
    line("[9 bounds] K1's kernels, card ms per warm prove (sum of launches or calls x queued ms): "
         + ", ".join(f"{k_} {v:.4f}" for k_, v in family.items())
         + f"; {sum(family.values()):.4f} in all")
    report["rank_ms_per_warm_prove"] = rank
    line("[9 bounds] rank, launches per warm prove x (ms - bound ms): " + ", ".join(
        f"{k_} {v:.2f} ms" for k_, v in rank.items()))


CHECK_BITS, CHECK_BATCH, CHECK_ITERS = 2048, 256, 20  # BASELINE config #1 (bench.py:34-118)


def config1_builders(count: int = 4) -> list:
    """bench.py's config #1: ``BigIntChip(b, 64, 2048)`` ``mul_mod`` with n
    from ``random.Random(0)`` and a, b from seeds 0 to count - 1, the
    product asserted equal to a fresh assignment of the answer; ``count``
    real witnesses of one trace shape."""
    from halo2_rsa_tpu_torch.bigint import BigIntChip
    from halo2_rsa_tpu_torch.circuit import Builder
    from halo2_rsa_tpu_torch.fields import BN254_FR

    rng = random.Random(0)
    n_v = 0
    while n_v.bit_length() != CHECK_BITS:
        n_v = rng.getrandbits(CHECK_BITS)
    out = []
    for seed in range(count):
        r = random.Random(seed)
        a_v = r.getrandbits(CHECK_BITS) % n_v
        b_v = r.getrandbits(CHECK_BITS) % n_v
        b = Builder(BN254_FR)
        chip = BigIntChip(b, 64, CHECK_BITS)
        res = chip.mul_mod(chip.assign_integer(a_v), chip.assign_integer(b_v),
                           chip.assign_integer(n_v))
        chip.assert_equal_fresh(res, chip.assign_integer((a_v * b_v) % n_v))
        out.append(b)
    return out


def corrupt(builder, rng, values=None, gates: int = 3, lookups: int = 3) -> list:
    """A copy of ``values`` (default the builder's) with ``gates`` cells of
    gate rows set to random canonical values and ``lookups`` lookup cells set
    to 2^bits, 2^31 + 5 (bit 31 of limb 0 set) and 2^63 + 1 in turn; ``rng``
    is a numpy Generator."""
    import numpy as np

    p = builder.field.p
    vals = list(builder.values if values is None else values)
    for c in rng.choice(np.unique(np.asarray(builder.gate_idx)), gates, replace=False):
        vals[int(c)] = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % p
    for i, j in enumerate(rng.choice(len(builder.lookups), lookups, replace=False)):
        cell, bits = builder.lookups[int(j)]
        vals[cell] = (1 << bits, 1 << 31 | 5, 1 << 63 | 1)[i % 3]
    return vals


def config1_inputs() -> tuple:
    """Config #1 ready to check: (its four builders, the compiled circuit,
    the (CHECK_BATCH, W, 8) witness batch on the host (the four witnesses
    tiled), and a function giving the checker's arrays on a device)."""
    import numpy as np

    from halo2_rsa_tpu_torch.circuit import checker

    builders = config1_builders()
    c1 = checker.compile_circuit(builders[0])
    w4 = np.stack([checker.witness_limbs(b) for b in builders])
    device_arrays = functools.partial(checker_arrays, c1)
    return builders, c1, np.tile(w4, (CHECK_BATCH // 4, 1, 1)), device_arrays


def checker_arrays(compiled, dev) -> tuple:
    """The batched checker's arrays of a compiled circuit on ``dev``: gate
    indices, each row's coefficients, and (bits, cells) per lookup width."""
    import numpy as np
    import torch

    idx = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)  # noqa: E731
    coef = torch.from_numpy(compiled.coef_table).to(dev)[idx(compiled.gate_coef_id)]
    return idx(compiled.gate_idx), coef, [(bits, idx(i)) for bits, i in compiled.lookup_groups]


def batched_check_ms(c1, wb, dev) -> tuple:
    """(ms per batched check on the card, CUDA events over CHECK_ITERS
    checks; host wall ms per check; the last check's counts)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(CHECK_ITERS):
        gates, lk = batched_violations(c1, wb, dev)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / CHECK_ITERS
    return start.elapsed_time(end) / CHECK_ITERS, wall * 1e3, (gates, lk)


def batched_violations(compiled, wb, device_arrays) -> tuple:
    """Per-instance (gate, lookup) violation counts, (B,) each, of a (B, W, 8)
    standard-form witness batch: the witness into Montgomery form (one K1
    launch), one ``eval_gates`` and one ``eval_lookup`` per bit width over
    the whole batch, as bench.py's ``check_all``."""
    import torch

    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.fields import vecfield

    gate_idx, coef, lookups = device_arrays
    fc = compiled.fc
    gates = (~checker.eval_gates(fc, gate_idx, coef, vecfield.to_mont(fc, wb))).sum(-1)
    lk = torch.zeros_like(gates)
    for bits, idx in lookups:
        lk = lk + (~checker.eval_lookup(wb[:, idx], bits)).sum(-1)
    return gates, lk


def corrupted_counts(compiled, wb, device_arrays, bad: dict, label: str) -> list:
    """A copy of the (B, W, 8) witness batch ``wb`` on the card with the
    instances of ``bad`` ({instance: corrupted values}) replaced, checked in
    one batched pass (``batched_violations``): each corrupted instance's
    (gate, lookup) counts must equal ``checker.check`` of its values on the
    CPU, and every other instance must have none. Returns the corrupted
    instances' counts, in the order of ``bad``."""
    import torch

    from halo2_rsa_tpu_torch.circuit import checker

    wbad = wb.clone()
    for inst, vals in bad.items():
        wbad[inst] = torch.from_numpy(checker.witness_limbs(vals)).to(wb.device)
    g_bad, l_bad = batched_violations(compiled, wbad, device_arrays)
    g_bad, l_bad = g_bad.cpu().tolist(), l_bad.cpu().tolist()
    for inst in range(wb.shape[0]):
        if inst in bad:
            want = checker.check(compiled, checker.witness_limbs(bad[inst]), device="cpu")
            got = (g_bad[inst], l_bad[inst])
            if got != (want["gate_violations"], want["lookup_violations"]) or want["ok"]:
                raise AssertionError(f"{label} instance {inst}: card {got}, cpu {want}")
        elif g_bad[inst] or l_bad[inst]:
            raise AssertionError(f"{label} instance {inst} (not corrupted) has violations")
    return [[g_bad[i], l_bad[i]] for i in bad]


def phase_checker(report, kernels, flagship):
    """[10 checker] The constraint checker on the card: the flagship's
    ``Pkcs1v15Circuit.check()`` and a seeded corruption of its witness
    against the same functions on the CPU; then BASELINE config #1 (bench.py
    :34-118), 256 witnesses checked in one batched pass, a seeded corruption
    of some instances against the CPU's counts, and the pass timed with CUDA
    events; K1 at the checker's shape, bitwise and queued."""
    import numpy as np
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield

    smi = report["device"]["smi"]
    out = {}
    circ, compiled = flagship["circ"], flagship["compiled"]
    cuda_mont.LAUNCHES["mont_mul"] = 0
    t0 = time.perf_counter()
    res = circ.check()
    out["flagship_check_s"] = time.perf_counter() - t0
    k1_flagship = cuda_mont.LAUNCHES["mont_mul"]
    if res != {"ok": True, "gate_violations": 0, "lookup_violations": 0, "instance_ok": True}:
        raise AssertionError(f"the flagship's check on the card: {res}")
    if k1_flagship == 0:
        raise AssertionError("K1 was never launched by the flagship's check")
    rng = np.random.default_rng(29)
    bad = checker.witness_limbs(corrupt(circ.builder, rng))
    card = checker.check(compiled, bad)
    cpu = checker.check(compiled, bad, device="cpu")
    rows = checker.failing_gates(compiled, bad, limit=1 << 20)
    if card != cpu or rows != checker.failing_gates(compiled, bad, limit=1 << 20, device="cpu"):
        raise AssertionError(f"the flagship's corrupted check differs: card {card}, cpu {cpu}")
    if card["ok"] or not card["lookup_violations"]:
        raise AssertionError(f"the corrupted flagship witness passed: {card}")
    report_card = checker.explain(circ.builder, bad, limit=20)
    if report_card != checker.explain(circ.builder, bad, limit=20, device="cpu"):
        raise AssertionError("explain differs between the card and the CPU")
    out.update(flagship_check=res, flagship_k1_launches=k1_flagship, flagship_corrupted=card,
               flagship_failing_rows=len(rows))
    line(f"[10 checker] flagship Pkcs1v15Circuit.check() on the card: ok, 0 gate and 0 lookup "
         f"violations, instance ok ({out['flagship_check_s']:.3f} s, {k1_flagship} K1 launches); "
         f"corrupted witness: {card['gate_violations']} gate / {card['lookup_violations']} lookup "
         f"violations, failing_gates ({len(rows)} rows) and explain equal to the CPU's | {smi}")

    # BASELINE config #1, batched
    t0 = time.perf_counter()
    builders, c1, w, device_arrays = config1_inputs()
    out["config1_build_s"] = time.perf_counter() - t0
    bad_ids = sorted(int(i) for i in rng.choice(CHECK_BATCH, 6, replace=False))
    bad = {inst: corrupt(builders[inst % 4], rng, gates=i % 3 + 1, lookups=i % 2 + 1)
           for i, inst in enumerate(bad_ids)}
    dev = device_arrays("cuda")
    wb = torch.from_numpy(w).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_mont.LAUNCHES["mont_mul"] = 0
    gates, lk = batched_violations(c1, wb, dev)
    torch.cuda.synchronize()
    k1_per_check = cuda_mont.LAUNCHES["mont_mul"]
    if int(gates.sum()) or int(lk.sum()):
        raise AssertionError("a valid config #1 instance has violations on the card")
    if k1_per_check == 0:
        raise AssertionError("K1 was never launched by the batched check")
    bad_counts = corrupted_counts(c1, wb, dev, bad, "config #1")
    ms, wall_ms, (gates, lk) = batched_check_ms(c1, wb, dev)
    if int(gates.sum()) or int(lk.sum()):
        raise AssertionError("a valid config #1 instance has violations on the card")
    products = CHECK_BATCH * c1.num_gates
    out.update(
        config1=dict(bits=CHECK_BITS, batch=CHECK_BATCH, gate_rows=int(c1.num_gates),
                     witness=int(c1.num_witness), lookups=int(c1.num_lookups),
                     corrupted=bad_ids, corrupted_counts=bad_counts,
                     iters=CHECK_ITERS, ms_per_batch=ms, wall_ms_per_batch=wall_ms,
                     checks_per_s=CHECK_BATCH / (ms / 1e3), k1_launches_per_check=k1_per_check,
                     k1_products_per_launch=[CHECK_BATCH * c1.num_witness, products],
                     peak_mem_bytes=torch.cuda.max_memory_allocated(), build_s=out["config1_build_s"]))
    r1 = out["config1"]
    line(f"[10 checker] config #1 (mul_mod-2048, {r1['gate_rows']} gate rows, {r1['witness']} "
         f"witness cells, {r1['lookups']} lookups) batch {CHECK_BATCH}: every instance 0 "
         f"violations; {len(bad_ids)} corrupted instances' gate/lookup counts "
         f"{r1['corrupted_counts']} equal the CPU's")
    line(f"[10 checker] config #1 batched check: {ms:.3f} ms per batch of {CHECK_BATCH} (CUDA "
         f"events, {CHECK_ITERS} warm iterations; host wall {wall_ms:.3f} ms) = "
         f"{r1['checks_per_s']:.1f} checks/s | K1 {k1_per_check} launches per check, "
         f"{CHECK_BATCH} x {c1.num_witness} products (to_mont) and {CHECK_BATCH} x "
         f"{c1.num_gates} = {products} (gates) | peak memory "
         f"{r1['peak_mem_bytes'] / 2**30:.2f} GiB | {smi}")

    # K1 at the checker's shape, a gate's coefficients (R rows) read in place
    # over the batch: 0 launches per warm prove
    fc = c1.fc
    a = mont_layout.random_elements(fc, products, 33, "cuda").view(CHECK_BATCH, c1.num_gates, 8)
    b = mont_layout.random_elements(fc, c1.num_gates, 34, "cuda")
    err = _max_abs_err(vecfield.mont_mul(fc, a, b),
                       cuda_mont.mont_mul_plain(fc, a, b.expand(a.shape).contiguous()))
    if err:
        raise AssertionError("K1 at the checker's shape differs from its plain version")
    row = dict(kind="checker", n=products, nb=int(c1.num_gates), mode=1,
               launches_per_warm_prove=0, max_abs_err=err,
               ms=queued_ms(lambda v: vecfield.mont_mul(fc, v, b), a, QUEUED_ITERS))
    row.update(shape_bound(report, *_k1_part(report["sass"], row)))
    report["k1"]["shapes"].append(row)
    line(f"[10 checker] K1 at the checker's shape ({products} products): bitwise equal | card "
         f"{row['ms']:.4f} ms vs bound {row['bound_ms']:.4f} ms ({row['bound_by']}) = "
         f"{row['bound_ms'] / row['ms'] * 100:.1f} % of bound | 0 launches per warm prove")
    report["checker"] = out
    return dict(compiled=c1, w4=w[:4], bad={i: checker.witness_limbs(v) for i, v in bad.items()},
                bad_counts=dict(zip(bad_ids, bad_counts)))


SHA_BITS, SHA_MSG_LEN = 1024, 64


def _size(key: str, shape) -> int:
    """A recorded shape's elements: products (K1), elements x exponent bits,
    rows x length, rows x C, points, rows x L, rows x buckets, points x
    doublings, or polys x 2^log_n (NTT)."""
    if key == "NTT":
        return shape[0] << shape[1]
    return shape[0] * (shape[1] if len(shape) > 1 and key != "K1" else 1)


def _hold_path_calls(keep: dict, hist: dict, covered: dict, path: str) -> list:
    """Each shape of ``hist`` (a path's launches, ``_calls_of``; kernels the
    path launched) that is not in ``covered`` (shapes an earlier phase
    holds), and each kernel's largest, held bitwise against its plain
    version on the path's own inputs: those of the first launch at that
    shape in a second run of the path (``keep``). Returns one row per shape
    held. Each copy is dropped once held."""
    import torch

    # give back the blocks the second run freed, so that the plain versions'
    # temporaries fit beside the copies (a k=20 path's copies take ~23 GB)
    torch.cuda.empty_cache()
    out = []
    for key, shapes in hist.items():
        largest = max(shapes, key=lambda s_: _size(key, s_))
        for shape in sorted(s_ for s_ in shapes if s_ not in covered[key] or s_ == largest):
            if (key, shape) not in keep:
                raise AssertionError(f"{key} at {shape} was launched by the first run of the "
                                     f"path only")
            plain, args, kw, got = keep.pop((key, shape))
            t0 = time.perf_counter()
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            del args, got, want
            if err:
                raise AssertionError(f"{key} at {shape} on the {path} path differs from its "
                                     f"plain version")
            out.append(dict(kernel=key, shape=list(shape), launches=shapes[shape],
                            new=shape not in covered[key], largest=shape == largest,
                            max_abs_err=err, plain_s=time.perf_counter() - t0))
    return out


def warm_prove_shapes(report) -> dict:
    """{kernel: the shapes one flagship warm prove launches it with}, which
    phase 6 holds against the plain versions."""
    flag = report["flagship"]
    covered = {key: {tuple(c[:-1]) for c in v} for key, v in flag["g1_calls_per_warm_prove"].items()}
    covered["K1"] = {tuple(c[:-1]) for c in flag["k1_calls_per_warm_prove"]}
    covered["K1-pow"] = {tuple(c[:-1]) for c in flag["k1_pow_calls_per_warm_prove"]}
    covered["K1-prefix"] = {tuple(c[:-1]) for c in flag["k1_prefix_calls_per_warm_prove"]}
    covered["NTT"] = {tuple(c[:-1]) for c in flag["ntt_calls_per_warm_prove"]}
    return covered


def sha_circuit() -> tuple:
    """RSA-1024 + SHA-256 of a SHA_MSG_LEN B message in the circuit, message
    and signature from random.Random(7), built and compiled: (circuit,
    compiled, k)."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    rng = random.Random(7)
    msg = bytes(rng.randrange(256) for _ in range(SHA_MSG_LEN))
    n, sig = sign_fixture(SHA_BITS, msg, rng=random.Random(7))
    circ = Pkcs1v15Circuit.build(SHA_BITS, n, sig, msg=msg)
    compiled = circ.compile()
    return circ, compiled, _k_of(compiled)


def _k_of(compiled) -> int:
    """The rows' log2 a compiled circuit needs: its gates and instance rows,
    and its cells over 5 columns."""
    return max(compiled.num_gates + len(compiled.instance_idx),
               compiled.num_witness // 5 + 1).bit_length()


def _card_path(out: dict, circ, compiled, k: int, label: str, proof_len: int | None = None):
    """A circuit's path on the card as a call ``path(timed=False)``: check,
    SRS set-up (tau 777), keygen from ``compiled``, one prove, verify, a
    wrong public input rejected, the proof's length if ``proof_len``; with
    ``timed``, each step's seconds in ``out``."""
    import torch

    from halo2_rsa_tpu_torch.prover import kzg, plonk

    bad = list(circ.public_inputs)
    bad[0] += 1

    def step(name, fn, timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        if timed:
            out[name] = time.perf_counter() - t
        return res

    def path(timed=False):
        check = step("check_s", circ.check, timed)
        if not check["ok"]:
            raise AssertionError(f"{label} check on the card: {check}")
        srs = step("setup_s", lambda: kzg.setup((1 << k) + plonk.BLIND, tau=777), timed)
        pk, vk = step("keygen_s", lambda: plonk.keygen(compiled, srs, k=k), timed)
        proof = step("prove_s", lambda: plonk.prove(pk, circ.builder.values, circ.public_inputs),
                     timed)
        if not step("verify_s", lambda: plonk.verify(vk, proof, circ.public_inputs), timed):
            raise AssertionError(f"the {label} proof does not verify")
        if plonk.verify(vk, proof, bad):
            raise AssertionError(f"{label}: verify accepted a wrong public input")
        if proof_len is not None and len(proof) != proof_len:
            raise AssertionError(f"{label} proof is {len(proof)} B, expected {proof_len}")
        out["proof_bytes"] = len(proof)

    return path


def phase_sha(report, kernels):
    """[11 sha] RSA-1024 + SHA-256 of a 64 B message in the circuit (k=17;
    halo2-rsa ``benches/bench.rs:349-367``), as ``scripts/time_torch_flagship.py
    1024 --sha 64`` builds it, proof 2,272 B. Its MSMs are the first of this
    script with more points than ``msm._SEG`` (the point-axis segments).
    ``_path_held``."""
    out = {}
    t0 = time.perf_counter()
    circ, compiled, k = sha_circuit()
    out["build_compile_s"] = time.perf_counter() - t0
    out.update(k=k, gates=int(compiled.num_gates))
    if k != 17:
        raise AssertionError(f"RSA-1024 SHA-64 picked k={k}, expected 17")
    report["sha"] = out
    _path_held(report, kernels, "[11 sha]", "RSA-1024 SHA-64", "RSA-1024 SHA-256 of 64 B", out,
               circ, compiled, k, 2272)


def _path_held(report, kernels, tag: str, label: str, what: str, out: dict, circ, compiled,
               k: int, proof_len: int | None = None) -> None:
    """A circuit's path on the card (``_card_path``, keys from ``compiled``):
    check, set-up, keygen, one prove, verify, a wrong public input rejected,
    one line of its times (the build's from ``out``). Every kernel of the flagship's path must launch on it too
    (counts set to 0 before it, read after: ``out["launches"]``), and the
    shape of each launch is recorded (``_calls_of``: ``out["calls"]``).
    Then each shape that the flagship's warm prove does not launch, and each
    kernel's largest, is held bitwise against its plain version, on the
    inputs of a second run of the path (``_hold_path_calls``:
    ``out["held"]``)."""
    import torch

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    path = _card_path(out, circ, compiled, k, label, proof_len)
    # the path's shapes are recorded as it runs (a counter per launch)
    calls = _calls_of(lambda: path(timed=True))
    out["launches"] = launch_counts()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["calls"] = calls
    for key, v in out["launches"].items():
        if v == 0:
            raise AssertionError(f"{key} was never launched on the {label} path")
    line(f"{tag} {what}: {out['gates']} gates, k={k}, build+compile "
         f"{out['build_compile_s']:.2f} s, check {out['check_s']:.3f} s ok, setup "
         f"{out['setup_s']:.2f} s, keygen {out['keygen_s']:.2f} s, prove {out['prove_s']:.3f} s, "
         f"verify {out['verify_s']:.3f} s ok, wrong public input rejected, proof "
         f"{out['proof_bytes']} B, peak {out['peak_mem_bytes'] / 2**30:.2f} GiB | launches "
         + ", ".join(f"{k_}={v}" for k_, v in out["launches"].items())
         + f" | {report['device']['smi']}")

    # the path again, each shape's first launch copied; its launches are not
    # the path's counts (they were read above)
    keep = {}
    t0 = time.perf_counter()
    _calls_of(path, keep)
    hist = {key: {tuple(c[:-1]): c[-1] for c in v} for key, v in calls.items()}
    out["held"] = _hold_path_calls(keep, hist, warm_prove_shapes(report), label)
    del keep
    out["held_s"] = time.perf_counter() - t0
    for key in hist:
        rows = [r for r in out["held"] if r["kernel"] == key]
        kernels[key]["max_abs_err"] = max([kernels[key]["max_abs_err"]]
                                          + [r["max_abs_err"] for r in rows])
        big = max(hist[key], key=lambda s_: _size(key, s_))
        line(f"{tag} {key}: {len(hist[key])} shapes, {sum(hist[key].values())} launches; "
             f"{sum(r['new'] for r in rows)} shapes not launched by the flagship's warm prove; "
             f"{len(rows)} held bitwise against the plain version on this path's own inputs "
             f"(each of those and the largest, {list(big)} x {hist[key][big]} launches)")
    line(f"{tag} the path again with first launches copied, and {len(out['held'])} shapes "
         f"held: {out['held_s']:.1f} s")


# the zk-email cell's circuit (benchmark/configs/zkemail_hdr1024.json): RSA-2048,
# SHA-256 in its dynamic-length mode up to 1,024 B, here over a 700 B header
ZKEMAIL_BITS, ZKEMAIL_MAX_LEN, ZKEMAIL_LEN = 2048, 1024, 700


def zkemail_circuit() -> tuple:
    """The zk-email cell's circuit over a ZKEMAIL_LEN B message, message and
    key from random.Random(7), built and compiled, and the witness-free
    circuit its key is made from (``without_witness(max_len=)``): (circuit,
    compiled, the key's compiled circuit, k)."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    rng = random.Random(7)
    msg = bytes(rng.randrange(256) for _ in range(ZKEMAIL_LEN))
    n, sig = sign_fixture(ZKEMAIL_BITS, msg, rng=random.Random(7))
    circ = Pkcs1v15Circuit.build(ZKEMAIL_BITS, n, sig, msg=msg, max_len=ZKEMAIL_MAX_LEN)
    compiled = circ.compile()
    shape = Pkcs1v15Circuit.without_witness(ZKEMAIL_BITS, max_len=ZKEMAIL_MAX_LEN).compile()
    return circ, compiled, shape, _k_of(compiled)


def phase_zkemail(report, kernels):
    """[11 zkemail] The zk-email cell's circuit (``zkemail_circuit``; k=20,
    round 3 over 2^23 rows, MSMs over 2^20 points), its key made from the
    witness-free circuit (one fingerprint with the instance's):
    ``_path_held``. Then one warm prove's shapes and launches
    (``zkemail.warm_calls``), timed on the card alone: the NTT at each
    (``ntt_times``, beside its bytes bound), K1 at each (``k1_times``,
    beside ``shape_bound``), and K2 and the row scans at each that the
    flagship's warm prove does not launch (phase 6 times those it does)."""
    import torch

    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec, kzg, plonk
    from halo2_rsa_tpu_torch.utils.serialization import circuit_fingerprint

    tag = "[11 zkemail]"
    out = {}
    t0 = time.perf_counter()
    circ, compiled, shape, k = zkemail_circuit()
    out["build_compile_s"] = time.perf_counter() - t0
    out.update(k=k, gates=int(compiled.num_gates), cells=int(compiled.num_witness))
    if k != 20:
        raise AssertionError(f"the zk-email circuit picked k={k}, expected 20")
    if circuit_fingerprint(shape) != circuit_fingerprint(compiled):
        raise AssertionError("the zk-email instance's trace differs from the witness-free one")
    del compiled
    report["zkemail"] = out
    _path_held(report, kernels, tag, "zk-email k=20",
               f"RSA-2048, SHA-256 of {ZKEMAIL_LEN} B in its dynamic mode up to "
               f"{ZKEMAIL_MAX_LEN} B, {out['cells']} cells, keys from the witness-free circuit",
               out, circ, shape, k)

    pk, _ = plonk.keygen(shape, kzg.setup((1 << k) + plonk.BLIND, tau=777), k=k)
    plonk.prove(pk, circ.builder.values, circ.public_inputs)
    reset_launch_counts()
    warm = _calls_of(lambda: plonk.prove(pk, circ.builder.values, circ.public_inputs))
    del pk
    out["warm_launches"] = launch_counts()
    out["warm_calls"] = warm
    line(f"{tag} one warm prove: launches " + ", ".join(
        f"{k_}={v}" for k_, v in out["warm_launches"].items()))

    whist = {key: {tuple(c[:-1]): c[-1] for c in v} for key, v in warm.items()}
    rows = ntt_times([("k20", *s_) for s_ in sorted(whist["NTT"])])
    for r in rows:
        r["calls_per_warm_prove"] = whist["NTT"][r["polys"], r["log_n"], r["inverse"]]
        line(f"{tag} NTT {r['polys']} x 2^{r['log_n']} "
             f"{'inverse' if r['inverse'] else 'forward'} ({r['calls_per_warm_prove']} a warm "
             f"prove): bitwise equal | card {r['ms']:.4f} ms ({r['stage_ms']:.4f} a stage) vs "
             f"bytes bound {r['bound_ms']:.4f} ms = {r['share'] * 100:.1f} % | torch loop "
             f"{r['plain_ms']:.1f} ms")
    out["ntt"] = rows
    fc = vecfield.consts(BN254_FR)
    rows = k1_times(lambda x, y: vecfield.mont_mul(fc, x, y),
                    [("k20", *s_) for s_ in sorted(whist["K1"])])
    for r in rows:
        r["launches_per_warm_prove"] = whist["K1"][r["n"], r["nb"], r["mode"]]
        r.update(shape_bound(report, *_k1_part(report["sass"], r)))
        line(f"{tag} K1 {r['n']} x {r['nb']} rows ({K1_MODES[r['mode']]}; "
             f"{r['launches_per_warm_prove']} a warm prove): card {r['ms']:.4f} ms vs bound "
             f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = {r['bound_ms'] / r['ms'] * 100:.1f} %")
    out["k1"] = rows
    card = {"NTT": sum(r["calls_per_warm_prove"] * r["ms"] for r in out["ntt"]),
            "K1": sum(r["launches_per_warm_prove"] * r["ms"] for r in out["k1"])}
    out["card_ms_per_warm_prove"] = card
    line(f"{tag} card time per warm prove (sum of launches x queued ms): NTT "
         f"{card['NTT']:.3f} ms, K1 {card['K1']:.3f} ms")

    fq = g1_vec.FQ
    covered = warm_prove_shapes(report)
    new = {key: sorted(s_ for s_ in whist[key] if s_ not in covered[key])
           for key in ("K2", "K3-scan")}
    out["k2"], out["k3_scan"] = [], []
    if new["K2"]:
        start, pts = k2_inputs(max(m for m, _ in new["K2"]), max(c for _, c in new["K2"]))
        out["k2"] = k2_times(lambda s_, r_: lambda: cuda_g1.point_scan_mixed(fq, s_, r_),
                             [("k20", *x) for x in new["K2"]], start, pts)
    if new["K3-scan"]:
        scan = {0: cuda_g1.point_scan, 1: cuda_g1.point_scan_sum}
        pts = k3_scan_inputs(max(x[0] for x in new["K3-scan"]),
                             max(x[1] for x in new["K3-scan"]))
        out["k3_scan"] = k3_scan_times(lambda s_, t: lambda: scan[t](fq, s_),
                                       [("k20", *x) for x in new["K3-scan"]], pts)
    line(f"{tag} warm-prove shapes the flagship's does not launch, timed: K2 "
         + (", ".join(f"m={r['m']} C={r['c']} {r['ms']:.4f} ms ({whist['K2'][r['m'], r['c']]} "
                      f"a warm prove)" for r in out["k2"]) or "none")
         + " | K3-scan "
         + (", ".join(f"rows={r['rows']} L={r['len']} tree={r['tree']} {r['ms']:.4f} ms "
                      f"({whist['K3-scan'][r['rows'], r['len'], r['tree']]} a warm prove)"
                      for r in out["k3_scan"]) or "none")
         + f" | {report['device']['smi']}")
    # phase 13's rank processes share the card: give back the blocks this
    # phase's copies left in the allocator's cache
    out["reserved_peak_bytes"] = torch.cuda.max_memory_reserved()
    torch.cuda.empty_cache()
    line(f"{tag} the allocator reserved at most {out['reserved_peak_bytes'] / 2**30:.2f} GiB; "
         f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB kept after emptying its cache")


REPLAY_C1_BATCH = 256  # BASELINE config #1's batch: 256 distinct mul_mod-2048 instances
REPLAY_DISTINCT, REPLAY_BATCH = 16, 64  # flagship instances under one key, tiled to the batch


def replay_instances(template, builders) -> list:
    """Each builder's input values keyed by the template's input cells (the
    instances ``WitnessProgram.generate`` takes)."""
    return [{i: b.values[i] for i in template.input_cells()} for b in builders]


def replay_flagship_circuits(count: int) -> list:
    """``count`` RSA-1024 SHA-disabled instances under the flagship's key
    (``sign_fixture(1024, msg, rng=random.Random(7))``), message s a 32 B
    message from random.Random(s), s = 0 .. count - 1."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    out = []
    for s in range(count):
        msg = bytes(random.Random(s).randrange(256) for _ in range(32))
        n, sig = sign_fixture(1024, msg, rng=random.Random(7))
        hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
        out.append(Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed))
    return out


def same_structure(a, b) -> bool:
    """Whether two compiled circuits have one trace shape (gate indices,
    coefficient ids and table, lookup groups, instance cells): a witness of
    one is proven with the other's key."""
    import numpy as np

    return (np.array_equal(a.gate_idx, b.gate_idx)
            and np.array_equal(a.gate_coef_id, b.gate_coef_id)
            and np.array_equal(a.coef_table, b.coef_table)
            and np.array_equal(a.instance_idx, b.instance_idx)
            and len(a.lookup_groups) == len(b.lookup_groups)
            and all(x[0] == y[0] and np.array_equal(x[1], y[1])
                    for x, y in zip(a.lookup_groups, b.lookup_groups)))


def device_ops(run) -> dict:
    """``run()`` under torch.profiler (the card's activity only): the
    operations on the card (kernels and copies) and their device time,
    against the host's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = dev_us = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            ops += ev.count
            dev_us += us
    return dict(device_ops=ops, device_s=dev_us / 1e6, profiled_wall_s=wall,
                busy_share=dev_us / 1e6 / wall)


def replay_on_card(label: str, prog, insts, want, compiled, covered) -> tuple:
    """One configuration of phase 12: ``prog`` (a ``WitnessProgram``) over
    ``insts`` on the card (host big ops, then the device program), with
    every launch counter at 0 before and read after (K1 and K1-pow must
    launch) and each launch's shape recorded (``_calls_of``); each witness
    bitwise equal to ``want[i]`` (synthesis) and 0 violations in one batched
    check. Then the path again with first launches copied, each shape that
    ``covered`` lacks and each kernel's largest held bitwise
    (``_hold_path_calls``); then warm: host big ops, the device program
    (synchronised) and the whole ``generate``, a generate plus the batched
    check, and one device program under torch.profiler. Returns (the
    record, the device witnesses of the first run)."""
    import numpy as np
    import torch

    batch = len(insts)
    steps = {}
    t_step = [time.perf_counter()]

    def tick(name):
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    def on_card():
        inputs, bigvals = prog.host_inputs(insts)
        return prog.run(torch.from_numpy(inputs).cuda(), torch.from_numpy(bigvals).cuda())

    reset_launch_counts()
    got = []
    calls = _calls_of(lambda: got.append(on_card()))
    torch.cuda.synchronize()
    launches = launch_counts()
    for key in ("K1", "K1-pow"):
        if launches[key] == 0:
            raise AssertionError(f"{key} was never launched by the {label} replay")
    wd = got[0]
    w = wd.cpu().numpy()
    for i in range(batch):
        if not np.array_equal(w[i], want[i]):
            raise AssertionError(f"{label}: replayed witness {i} differs from synthesis")
    tick("path")
    arrays = checker_arrays(compiled, "cuda")
    gates, lk = batched_violations(compiled, wd, arrays)
    if int(gates.sum()) or int(lk.sum()):
        raise AssertionError(f"{label}: a replayed witness has violations on the card")
    tick("compare_check")

    keep = {}
    _calls_of(on_card, keep)
    tick("path_copied")
    hist = {key: {tuple(c[:-1]): c[-1] for c in v} for key, v in calls.items() if v}
    held = _hold_path_calls(keep, hist, covered, f"{label} replay")
    del keep
    tick("held")

    t0 = time.perf_counter()
    inputs, bigvals = prog.host_inputs(insts)
    host_s = time.perf_counter() - t0
    xi, xb = torch.from_numpy(inputs).cuda(), torch.from_numpy(bigvals).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog.run(xi, xb)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog.generate(insts)
    whole_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gates, lk = batched_violations(compiled, on_card(), arrays)
    if int(gates.sum()) or int(lk.sum()):
        raise AssertionError(f"{label}: a replayed witness has violations on the card")
    generate_check_s = time.perf_counter() - t0
    tick("timed")
    profile = device_ops(lambda: prog.run(xi, xb))
    tick("profile")
    out = dict(
        batch=batch, cells=prog.num_cells, groups=len(prog.groups),
        inputs=len(prog.input_idx), big_cells=int(bigvals.shape[1]),
        launches={key: launches[key] for key in ("K1", "K1-pow", "K1-prefix")},
        calls={key: calls[key] for key in ("K1", "K1-pow", "K1-prefix")},
        held=held, held_s=steps["held"], host_s=host_s, device_s=device_s, whole_s=whole_s,
        witnesses_per_s=batch / whole_s, device_witnesses_per_s=batch / device_s,
        generate_check_s=generate_check_s, generate_check_per_s=batch / generate_check_s,
        profile=profile, steps_s=steps)
    return out, wd


def _replay_lines(label: str, r: dict, smi: str) -> None:
    k1 = {tuple(c[:-1]): c[-1] for c in r["calls"]["K1"]}
    line(f"[12 replay] {label} per generate ({r['batch']} witnesses of {r['cells']} cells, "
         f"{r['groups']} groups): K1 {r['launches']['K1']} launches at {len(k1)} shapes, "
         f"{min(s_[0] for s_ in k1)} to {max(s_[0] for s_ in k1)} products; K1-pow "
         f"{r['launches']['K1-pow']} at {[c[0] for c in r['calls']['K1-pow']]} elements; "
         f"K1-prefix {r['launches']['K1-prefix']}; "
         f"{r['profile']['device_ops']} operations on the card (torch.profiler), busy "
         f"{r['profile']['busy_share'] * 100:.1f} % of the device program's wall time")
    line(f"[12 replay] {label} warm: host big ops {r['host_s']:.3f} s, device program "
         f"{r['device_s']:.3f} s (synchronised), whole generate {r['whole_s']:.3f} s = "
         f"{r['witnesses_per_s']:.1f} witnesses/s ({r['device_witnesses_per_s']:.1f} for the "
         f"device program alone); generate + batched check {r['generate_check_s']:.3f} s = "
         f"{r['generate_check_per_s']:.1f} instances/s | {len(r['held'])} shapes held bitwise "
         f"against the plain versions on the replay's own operands ({r['held_s']:.1f} s) | {smi}")


def phase_replay(report, kernels, flagship):
    """[12 replay] Batched witness replay (``witness.WitnessProgram``) on
    the card. BASELINE config #1 at its batch of REPLAY_C1_BATCH distinct
    instances, and REPLAY_DISTINCT flagship instances under one key tiled to
    REPLAY_BATCH (``replay_on_card``): each witness bitwise equal to
    synthesis, 0 violations in the batched check; six replayed config #1
    instances corrupted, against the CPU's counts. The flagship instances'
    trace shape must equal phase 5's; instance 0's replayed witness is
    proven with phase 5's key, byte-equal to the proof of its synthesized
    witness (every prover kernel launched), verified, a wrong public input
    rejected. Then K1 at the flagship replay's largest shape and K1-pow at
    its inversion, timed on the card alone, as two rows of the kernels
    line."""
    import numpy as np
    import torch

    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.prover import plonk
    from halo2_rsa_tpu_torch.witness import WitnessProgram

    smi = report["device"]["smi"]
    t_phase = time.perf_counter()
    covered = warm_prove_shapes(report)
    for key, v in report["sha"]["calls"].items():
        covered[key] |= {tuple(c[:-1]) for c in v}
    out = {}

    t0 = time.perf_counter()
    builders = config1_builders(REPLAY_C1_BATCH)
    c1 = checker.compile_circuit(builders[0])
    prog = WitnessProgram(builders[0])
    want = [checker.witness_limbs(b) for b in builders]
    setup_s = time.perf_counter() - t0
    r1, wd = replay_on_card("config #1", prog, replay_instances(builders[0], builders), want, c1,
                            covered)
    rng = np.random.default_rng(31)
    bad_ids = sorted(int(i) for i in rng.choice(REPLAY_C1_BATCH, 6, replace=False))
    bad = {inst: corrupt(builders[inst], rng, values=vecfield.to_ints(c1.fc, wd[inst], mont=False),
                         gates=i % 3 + 1, lookups=i % 2 + 1)
           for i, inst in enumerate(bad_ids)}
    t0 = time.perf_counter()
    r1.update(synthesis_compile_s=setup_s, corrupted=bad_ids,
              corrupted_counts=corrupted_counts(c1, wd, checker_arrays(c1, "cuda"), bad,
                                                "replayed config #1"))
    r1["steps_s"]["corrupted"] = time.perf_counter() - t0
    out["config1"] = r1
    del wd
    line(f"[12 replay] config #1 (mul_mod-2048): {REPLAY_C1_BATCH} distinct instances "
         f"synthesized and compiled in {setup_s:.1f} s; replayed on the card, each witness "
         f"bitwise equal to synthesis, 0 violations in the batched check; {len(bad_ids)} "
         f"corrupted replayed instances' gate/lookup counts {r1['corrupted_counts']} equal the "
         f"CPU's")
    _replay_lines("config #1", r1, smi)

    t0 = time.perf_counter()
    circs = replay_flagship_circuits(REPLAY_DISTINCT)
    compiled = flagship["compiled"]
    for s, c in enumerate(circs):
        if not same_structure(c.compile(), compiled):
            raise AssertionError(f"flagship instance {s}'s trace shape differs from phase 5's")
    template = circs[0].builder
    prog = WitnessProgram(template)
    synth = [checker.witness_limbs(c.builder) for c in circs]
    setup_s = time.perf_counter() - t0
    insts = replay_instances(template, [circs[i % REPLAY_DISTINCT].builder
                                        for i in range(REPLAY_BATCH)])
    rf, wd = replay_on_card("flagship", prog, insts,
                            [synth[i % REPLAY_DISTINCT] for i in range(REPLAY_BATCH)], compiled,
                            covered)
    rf["synthesis_compile_s"] = setup_s
    line(f"[12 replay] flagship (RSA-1024, SHA disabled): {REPLAY_DISTINCT} distinct instances "
         f"under one key, signed, synthesized and compiled in {setup_s:.1f} s, trace shape equal "
         f"to phase 5's; {REPLAY_BATCH} replayed on the card (tiled), each bitwise equal to "
         f"synthesis, 0 violations in the batched check")
    _replay_lines("flagship", rf, smi)

    # instance 0's replayed witness, proven with phase 5's key
    pk, vk = flagship["pk"], flagship["vk"]
    pubs = circs[0].public_inputs
    w0 = wd[0].cpu().numpy()
    del wd
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = plonk.prove(pk, w0, pubs, rng=random.Random(KEY_SEED))
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    prove_launches = launch_counts()
    unused = [key for key, v in prove_launches.items() if v == 0]
    if unused:
        raise AssertionError(f"the prove from a replayed witness never launched {unused}")
    if proof != plonk.prove(pk, circs[0].builder.values, pubs, rng=random.Random(KEY_SEED)):
        raise AssertionError("the proof from the replayed witness differs from the synthesized "
                             "witness's")
    if len(proof) != 2272 or not plonk.verify(vk, proof, pubs):
        raise AssertionError("the proof from the replayed witness does not verify")
    bad_pubs = list(pubs)
    bad_pubs[0] += 1
    if plonk.verify(vk, proof, bad_pubs):
        raise AssertionError("verify accepted a wrong public input for the replayed witness")
    rf["steps_s"]["prove_compare_verify"] = time.perf_counter() - t0
    rf.update(prove_s=prove_s, prove_launches=prove_launches,
              proof_sha256=hashlib.sha256(proof).hexdigest())
    out["flagship"] = rf
    line(f"[12 replay] flagship instance 0 proven from its replayed witness with phase 5's key "
         f"(random.Random({KEY_SEED})) in {prove_s:.3f} s: {len(proof)} B, byte-equal to the "
         f"proof of its synthesized witness, verified, a wrong public input rejected | launches "
         + ", ".join(f"{k_}={v}" for k_, v in prove_launches.items()))

    # K1 at the flagship replay's largest shape and K1-pow at its inversion,
    # each held above on the replay's own operands
    fc = compiled.fc
    e = fc.field.p - 2
    sass = report["sass"]
    held = {r["kernel"]: r for r in rf["held"] if r["largest"]}
    n, nb, mode = held["K1"]["shape"]
    row = k1_times(lambda x, y: vecfield.mont_mul(fc, x, y), [("replay", n, nb, mode)])[0]
    row.update(shape_bound(report, *_k1_part(sass, row)))
    kernels["K1-replay"] = dict(
        name="mont_mul", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", launches=rf["launches"]["K1"],
        max_abs_err=held["K1"]["max_abs_err"], ms=row["ms"],
        plain_ms=held["K1"]["plain_s"] * 1e3, bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=None, timing="queued",
        shape=f"{n} products, {nb} rows of b ({K1_MODES[mode]}): the flagship replay's largest "
              f"(batch {REPLAY_BATCH}); launches per generate")
    pn = held["K1-pow"]["shape"][0]
    prow = k1_pow_times(lambda x: cuda_mont.mont_pow(fc, x, e), [("replay", pn)])[0]
    prow.update(shape_bound(report, *_pow_part(sass, prow)))
    kernels["K1-pow-replay"] = dict(
        name="mont_pow", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont_pow.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", launches=rf["launches"]["K1-pow"],
        max_abs_err=held["K1-pow"]["max_abs_err"], ms=prow["ms"],
        plain_ms=held["K1-pow"]["plain_s"] * 1e3, bound_ms=prow["bound_ms"],
        bound_by=prow["bound_by"], library_ms=None, timing="queued",
        shape=f"{pn} elements, e = p - 2 over BN254 Fr (the flagship replay's inv0 group at "
              f"batch {REPLAY_BATCH}); launches per generate")
    out["k1"], out["k1_pow"] = row, prow
    for key in ("K1-replay", "K1-pow-replay"):
        k = kernels[key]
        line(f"[12 replay] {key}: {k['shape']}: card {k['ms']:.4f} ms vs bound "
             f"{k['bound_ms']:.4f} ms ({k['bound_by']}) = {k['bound_ms'] / k['ms'] * 100:.1f} % "
             f"of bound, plain {k['plain_ms']:.1f} ms, {k['launches']} launches per generate")
    out["phase_s"] = time.perf_counter() - t_phase
    report["replay"] = out
    line(f"[12 replay] phase {out['phase_s']:.1f} s | steps (s): " + "; ".join(
        f"{cfg} " + ", ".join(f"{k_} {v:.1f}" for k_, v in out[cfg]["steps_s"].items())
        for cfg in ("config1", "flagship")))


MESH_WARM = 3  # warm mesh proves of the flagship per rank


def _rank_lines(label: str, r: dict, smi: str) -> None:
    coll = " ".join(f"{k} {v['calls']} calls {v['bytes']} B ({v['staged_bytes']} B staged)"
                    for k, v in r["collectives"].items())
    line(f"[13 multirank] {label}: keys loaded {r['load_s']:.2f} s, cold prove "
         f"{r['cold_s']:.3f} s, warm x{len(r['warm_s'])} min {min(r['warm_s']):.3f} mean "
         f"{sum(r['warm_s']) / len(r['warm_s']):.3f} max {max(r['warm_s']):.3f} s | launches per "
         f"warm prove " + ", ".join(f"{k}={v}" for k, v in r["launches"].items())
         + f" | collectives per warm prove: {coll} | {smi}")


def _scan_work(calls: list, tree=None, tails=None) -> int:
    """Rows x length summed over a kernel's recorded calls (K2: rows x C;
    K3-scan: rows x L of the scans with (1) or without (0) the tree). With
    ``tails`` True or False, only or all but the blinding tails' row scans
    (L = BLIND x TAIL_WINDOWS + 1; an MSM's scans are powers of two or 255
    long), which each rank runs in full."""
    from halo2_rsa_tpu_torch.prover import plonk

    row = plonk.BLIND * plonk.TAIL_WINDOWS + 1
    return sum(c[0] * c[1] * c[-1] for c in calls if (tree is None or c[2] == tree)
               and (tails is None or (c[1] == row) == tails))


def phase_multirank(report, flagship, config1):
    """[13 multirank] The port's multi-rank path (``parallel``) on this
    card: two gloo ranks (the dry run, the flagship mesh-proven from phase
    5's saved keys, config #1's sharded checks), then one NCCL rank (the
    flagship again). Every rank is a process of ``parallel.spawn``; a rank's
    failure or timeout raises here."""
    import shutil
    import tempfile

    import torch

    from halo2_rsa_tpu_torch import entry
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.parallel import launch, ranks
    from halo2_rsa_tpu_torch.utils import serialization as ser

    smi = report["device"]["smi"]
    f5 = report["flagship"]
    out = {}
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(2, "gloo")
    out["dryrun"] = dict(dry, seconds=time.perf_counter() - t0)
    if dry["skipped"]:
        raise AssertionError(f"dryrun_multichip(2, 'gloo') skipped {dry['skipped']}")
    line(f"[13 multirank] dryrun_multichip(2, 'gloo') on one card, every section run, "
         f"{out['dryrun']['seconds']:.1f} s: " + ", ".join(
             f"{k} {v:.2f} s" for k, v in dry["sections"].items()) + f" | {smi}")

    circ, pk, vk = flagship["circ"], flagship["pk"], flagship["vk"]
    keys_dir = os.path.join(HERE, ".keys")
    os.makedirs(keys_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=keys_dir)
    try:
        paths = {"srs": os.path.join(d, "srs.npz"), "pk": os.path.join(d, "pk.npz"),
                 "vk": os.path.join(d, "vk.json")}
        ser.save_srs(pk.srs, paths["srs"])
        ser.save_pk(pk, paths["pk"])
        ser.save_vk(vk, paths["vk"])
        witness = checker.witness_limbs(circ.builder)
        want_sha = f5["keys"]["proof_sha256"]
        runs = {}
        for label, world, backend in (("gloo x2", 2, "gloo"), ("nccl x1", 1, "nccl")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = launch.spawn(ranks.prove_from_keys, world, backend, timeout=900,
                               args=(paths, witness, circ.public_inputs, KEY_SEED,
                                     MESH_WARM if world > 1 else 1))
            runs[label] = dict(seconds=time.perf_counter() - t0, ranks=[
                {k: v for k, v in r.items() if k != "proof"} for r in res])
            for rank, r in enumerate(res):
                if r["sha256"] != want_sha or len(r["proof"]) != 2272:
                    raise AssertionError(f"{label} rank {rank}: proof sha256 {r['sha256']} "
                                         f"({len(r['proof'])} B), phase 5's {want_sha}")
                if not (r["verified"] and r["wrong_pub_rejected"]):
                    raise AssertionError(f"{label} rank {rank}: verified {r['verified']}, "
                                         f"wrong public input rejected {r['wrong_pub_rejected']}")
                if any(r["fallbacks"].values()):
                    raise AssertionError(f"{label} rank {rank}: local fallbacks {r['fallbacks']}")
                zero = [k for k, v in r["launches"].items() if not v]
                if zero:
                    raise AssertionError(f"{label} rank {rank}: {zero} never launched in a warm prove")
                single = f5["g1_calls_per_warm_prove"]
                for key, tree, tails in (("K2", None, None), ("K3-scan", 0, False)):
                    got = _scan_work(r["shapes"][key], tree, tails)
                    one = _scan_work(single[key], tree, tails)
                    if got * world != one:
                        raise AssertionError(f"{label} rank {rank}: {key} work {got} is not 1/"
                                             f"{world} of the single device's {one}")
                got = _scan_work(r["shapes"]["K3-scan"], 0, True)
                one = _scan_work(single["K3-scan"], 0, True)
                if got != one or not one:
                    raise AssertionError(f"{label} rank {rank}: the blinding tails' row scans "
                                         f"{got}, not the single device's {one}")
                _rank_lines(f"{label} rank {rank}", r, smi)
        out["flagship"] = runs
    finally:
        shutil.rmtree(d, ignore_errors=True)
    g = runs["gloo x2"]["ranks"]
    warm5 = f5["prove_warm_s"]
    line(f"[13 multirank] flagship k=15 mesh-proven by 2 gloo ranks on one card: sha256 "
         f"{want_sha} on both ranks = phase 5's single-device proof (random.Random({KEY_SEED})), "
         f"2272 B, verified, wrong public input rejected; 1 NCCL rank (its collectives over one "
         f"rank are trivial): the same bytes | warm prove, 2 ranks: " + "; ".join(
             f"rank {i} min {min(r['warm_s']):.3f} mean {sum(r['warm_s']) / len(r['warm_s']):.3f} "
             f"max {max(r['warm_s']):.3f} s" for i, r in enumerate(g))
         + f" | phase 5 single device x{len(warm5)}: min {min(warm5):.3f} mean "
         f"{sum(warm5) / len(warm5):.3f} max {max(warm5):.3f} s | per rank K2 work "
         f"{_scan_work(g[0]['shapes']['K2'])} = 1/2 of {_scan_work(f5['g1_calls_per_warm_prove']['K2'])}"
         f" row-points, K3 chunk-total scans {_scan_work(g[0]['shapes']['K3-scan'], 0, False)} = "
         f"1/2, the tails' row scans {_scan_work(g[0]['shapes']['K3-scan'], 0, True)} in full, "
         f"bucket-reduce scans {_scan_work(g[0]['shapes']['K3-scan'], 1)} (single device "
         f"{_scan_work(f5['g1_calls_per_warm_prove']['K3-scan'], 1)}) | {smi}")

    plan = [((2, 1), "sharded"), ((1, 2), "sharded"), ((2, 1), "wire")]
    t0 = time.perf_counter()
    res = launch.spawn(ranks.checker_rates, 2, "gloo", timeout=900, args=(
        config1["compiled"], config1["w4"], CHECK_BATCH, config1["bad"], plan, CHECK_ITERS))
    want = [sum(config1["bad_counts"][i]) for i in sorted(config1["bad"])]
    rates = {}
    for rank, r in enumerate(res):
        for (shape, kind), v in r.items():
            if v["valid"].shape != (CHECK_BATCH,) or v["valid"].any():
                raise AssertionError(f"config #1 {kind} {shape} rank {rank}: violations "
                                     f"{v['valid'].nonzero()}")
            if v["bad"].tolist() != want:
                raise AssertionError(f"config #1 {kind} {shape} rank {rank}: corrupted counts "
                                     f"{v['bad'].tolist()}, phase 10's {want}")
            rates[f"{kind} {shape[0]}x{shape[1]} rank {rank}"] = dict(
                checks_per_s=v["checks_per_s"], s_per_check=v["s_per_check"], prep_s=v["prep_s"])
    out["config1"] = dict(seconds=time.perf_counter() - t0, corrupted_counts=want, rates=rates,
                          single_device_checks_per_s=report["checker"]["config1"]["checks_per_s"])
    line(f"[13 multirank] config #1 (batch {CHECK_BATCH}) on 2 gloo ranks: every instance 0 "
         f"violations, the six corrupted instances' counts {want} equal phase 10's (gate + lookup) "
         f"| checks/s (host wall, {CHECK_ITERS} checks): " + "; ".join(
             f"{k} {v['checks_per_s']:.1f}" for k, v in rates.items())
         + f" | phase 10 single device {out['config1']['single_device_checks_per_s']:.1f} | {smi}")
    out["phase_s"] = time.perf_counter() - t_phase
    report["multirank"] = out
    line(f"[13 multirank] phase {out['phase_s']:.1f} s")


def main() -> int:
    sys.path.insert(0, HERE)
    report: dict = {}
    kernels: dict = {}
    t_all = time.perf_counter()
    phase_device(report)
    phase_build(report)
    phase_parity(report, kernels)
    phase_golden(report)
    flagship = phase_flagship(report, kernels)
    _empty_launch(report)
    phase_k1(report, kernels)
    phase_k1_pow(report, kernels)
    phase_k1_prefix(report, kernels)
    phase_ntt(report, kernels)
    phase_k2(report, kernels)
    phase_k3(report, kernels)
    phase_k4(report, kernels)
    phase_p1(report, kernels)
    phase_p2(report, kernels)
    phase_bounds(report, kernels)
    config1 = phase_checker(report, kernels, flagship)
    phase_sha(report, kernels)
    phase_zkemail(report, kernels)
    phase_replay(report, kernels, flagship)
    phase_multirank(report, flagship, config1)
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)

    import torch

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape", "timing")
    print(json.dumps({"kernels": [{k: kernels[kk][k] for k in keys} for kk in sorted(kernels)]}))
    print(report["device"]["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

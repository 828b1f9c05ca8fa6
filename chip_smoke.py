#!/usr/bin/env python3
"""Card gate of the PyTorch/CUDA port: drives halo2_rsa_tpu_torch's main
path on one NVIDIA GPU and checks it.

Each kernel against its plain version at chosen sizes is
``tests/test_torch_kernels_cuda.py``'s (``pytest -m cuda``), and the time of
a whole proof, check or replay is the benchmark's (``benchmark/run.py``);
this script does what neither does. Phases (each prints its lines before the
next starts; any failure raises and the script exits non-zero without its
final line):

1. device and toolchain (torch/CUDA/nvcc/Triton versions, nvidia-smi);
2. build every kernel of halo2_rsa_tpu_torch/csrc with nvcc (sm_90a): each
   kernel's registers and spills (``-Xptxas=-v``) and SASS instructions
   (``cuobjdump -sass``);
3. the paths, one ``hold_path`` for each configuration of ``CONFIGS``:
   built; a single instance checked on the card by the port's own check
   (``Pkcs1v15Circuit.check()``, or ``checker.run`` for a golden: gates,
   lookups and instance cells), and a seeded corruption of it judged by
   ``checker.check``, ``failing_gates`` and ``explain`` equal to the CPU's;
   a batch checked in one batched pass (0 violations) and its corrupted
   instances' counts equal to the CPU's; keys made (or taken from the entry
   named by ``keys_from``) and a proof verified, a wrong public input
   rejected (a replay configuration replays its batch on the card instead,
   each witness bitwise equal to synthesis); the launches counted and the
   shape of every kernel launch recorded (``_calls_of``); then the path
   again, and each shape that no earlier configuration held checked bitwise
   against its plain version on the path's own inputs
   (``_hold_path_calls``). The configurations: the three committed JAX-made
   golden proofs (byte for byte, vk equal); the flagship, RSA-1024 PKCS#1
   v1.5 with SHA disabled, k=15 (its keys saved under ``.keys/``, loaded
   back and proven byte-equal, ``load_or_keygen`` generated then loaded);
   BASELINE config #1, bench.py's mul_mod-2048 at 256 distinct instances,
   checked and replayed; RSA-1024 + SHA-256 of 64 B, k=17 (the MSM's
   point-axis segments); the zk-email cell's circuit, RSA-2048 with SHA-256
   in its dynamic-length mode up to 1,024 B, k=20, its key from the
   witness-free circuit; 16 flagship instances tiled to 64 replayed,
   instance 0 then proven with the flagship's keys from its replayed
   witness byte-equal to the proof of its synthesized one. A configuration
   that proves also records the shapes of one warm prove (phases 4 and 8
   time them);
4. each kernel alone at the shapes one flagship warm prove launches it
   with, and at a few more (K1 at 2^20 products and at the checker's shape,
   K1-pow at 2^14 elements, the NTT at the same calls at k=18's sizes, K2,
   K3 and K4 at 2^16 points): each bitwise against its plain version, then
   timed on the card alone (``queued_ms``: the launches queued behind a spin
   kernel) and paced by the host, beside an empty launch; K2 at the path's
   shapes also in the path's form (its rows read through a bucket sort's
   permutation, held against the dense launch); K3's row scans with every
   cluster size; K1 beside P2's staged tiles;
5. P1, the integer op-rate probe: each of its 7 bodies at (16, 2^20), REPS
   64, bitwise against its plain version on the card, then the probe's own
   timed run (``bench.vpu_ops.run``) with its launches counted;
6. P2, K1's layouts: (b') limb-major and (d') staged through shared memory
   for each block size, bitwise against their plain versions at 2^20
   products over BN254 Fr, then the probe's timed run
   (``bench.mont_layout.run``, which also asserts every variant equal to K1)
   with its launches counted;
7. each kernel's bound: bytes over 3.35 TB/s against its SASS instructions
   over the rates derived from the architecture at the card's maximum SM
   clock: the FMA pipe's integer opcodes and the ALU pipe's, 64 lanes per SM
   each, and all instructions over 128 issued per SM (K2 and K4: the loop
   body once per add or doubling, the rest once per thread). P1's best
   measured integer rate is reported beside it, as a reading. The rank of
   each kernel, launches per warm prove x (ms - bound ms), summed over its
   path shapes (K1's in buckets of products per launch);
8. the zk-email path's warm prove: its NTT and K1 shapes, and its K2 and
   row-scan shapes that the flagship's lacks, timed as in phase 4 (K1 beside
   its bound); K1 at the flagship replay's largest shape and K1-pow at its
   inversion, the kernels line's ``K1-replay`` and ``K1-pow-replay`` rows;
9. multi-rank (``parallel``), every rank a process of its own started by
   ``parallel.spawn`` (a deadline; any rank's failure fails the phase): two
   ranks on this one card over gloo (collectives staged through host
   memory) run ``entry.dryrun_multichip(2, "gloo")`` with no section
   skipped; then the flagship with its keys saved and loaded in each rank,
   proven with ``MeshKernels`` (``random.Random(41)``): the same SHA-256 on
   both ranks as the single device's proof with that rng, verified, a wrong
   public input rejected, per-rank launch counts and collectives (calls,
   bytes, staged bytes) over one warm prove, each rank's K2 and chunk-total
   K3-scan work 1/2 of the single device's (its blinding tails' row scans
   the single device's in full: each rank sums its own); config #1 by
   ``ShardedChecker`` on meshes (2, 1) and (1, 2) and ``WireShardedChecker``
   on (2, 1), 0 violations and the corrupted instances' counts equal to
   phase 3's; then one rank over NCCL proves the flagship again, byte-equal
   (its collectives are over one rank: trivial).

Then it prints the kernels' JSON line (each row also names its ``shape``
and its ``timing``: ``queued`` on every row, CUDA events over launches
queued behind a spin kernel so that the host cannot pace them; the
host-paced figure is ``host_paced_ms`` in chip_smoke.json), the card's name
and power limit, and as its last line {"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py   (needs one CUDA card and nvcc)
"""

import collections
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import random
import re
import subprocess
import sys
import time
from typing import Callable

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
DEVICE = "cuda"  # the card every path runs on
HBM_BYTES_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
# Hopper architecture white paper, per SM per clock: 64 lanes on each of the
# FMA pipe (IMAD) and the integer ALU pipe; four schedulers of one warp
# instruction each, 128 thread-instructions in all
PIPE_LANES_PER_SM, ISSUE_PER_SM = 64, 128
P1_LOG_N, P1_REPS, P1_ITERS = 20, 64, 8
P2_LOG_N, P2_ITERS, P2_THREADS = 20, 10, 256  # P2-staged's ms and bound are at T = 256
K4_BIG = 1 << 16  # K2's, K3's and K4's throughput shape
QUEUED_ITERS = 50  # launches per queued_ms chain at the throughput shapes
# K2 calls per timed chain: a checkout whose K2 is one add per launch makes C
# = 64 launches per call, and ~1,000 queued launches outgrow the card's
# launch queue (the host then waits)
K2_ITERS = 15
# row-scan calls per timed chain: a checkout without the scan kernel runs
# each scan as ~100-200 launches, and the chain must stay within the card's
# launch queue
K3_SCAN_ITERS = 4
QUEUE_LEAD_MS = 20.0  # queued_ms's first spin, lengthened while the host needs longer
KEY_SEED = 41  # the rng of every proof the gate makes (the goldens' own seeds aside)


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

# kernels-line row -> (its wrapper's name, its source under csrc/, the TPU
# kernel it replaces)
KERNEL_ROWS = {
    "K1": ("mont_mul", "mont.cu", "halo2_rsa_tpu/fields/pallas_mont.py:112"),
    "K1-pow": ("mont_pow", "mont_pow.cu", "halo2_rsa_tpu/fields/pallas_mont.py:112"),
    "K1-prefix": ("mont_prefix", "mont_scan.cu", "halo2_rsa_tpu/fields/pallas_mont.py:112"),
    "K2": ("g1_add_mixed", "g1_scan.cu", "halo2_rsa_tpu/prover/pallas_g1.py:80"),
    "K3": ("g1_add", "g1.cu", "halo2_rsa_tpu/prover/pallas_g1.py:43"),
    "K3-scan": ("point_scan_rows", "g1_rows.cu", "halo2_rsa_tpu/prover/pallas_g1.py:43"),
    "K3-splice": ("bucket_splice", "g1_splice.cu", "halo2_rsa_tpu/prover/pallas_g1.py:43"),
    "K4": ("g1_double", "g1_double.cu", "halo2_rsa_tpu/prover/pallas_g1.py:121"),
    "NTT": ("ntt", "ntt.cu", "none: halo2_rsa_tpu/prover/ntt.py is plain jnp"),
}
KERNELS = tuple(KERNEL_ROWS)


def kernel_rows() -> dict:
    """The kernels line's rows of K1-K4 and the NTT, before phase 4 times
    them."""
    return {key: dict(name=name, route="cuda", source=f"halo2_rsa_tpu_torch/csrc/{src}",
                      replaces=replaces, max_abs_err=0, timing="queued")
            for key, (name, src, replaces) in KERNEL_ROWS.items()}


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


# ---------------------------------------------------------------------------
# Phase 3: the paths
# ---------------------------------------------------------------------------

CHECK_BITS, CHECK_BATCH = 2048, 256  # BASELINE config #1 (bench.py:34-118) and its batch
REPLAY_DISTINCT, REPLAY_BATCH = 16, 64  # flagship instances under one key, tiled to the batch
# the zk-email cell's circuit (benchmark/configs/zkemail_hdr1024.json): RSA-2048,
# SHA-256 in its dynamic-length mode up to 1,024 B, here over a 700 B header
ZKEMAIL_BITS, ZKEMAIL_MAX_LEN, ZKEMAIL_LEN = 2048, 1024, 700


@dataclasses.dataclass
class Built:
    """A configuration ready for its path. ``builders`` are its instances
    (one to prove, or a batch to check and replay); ``compiled`` is the
    circuit its checker and its key are made from. ``check`` is the port's
    own check of a single instance (``Pkcs1v15Circuit.check`` or
    ``checker.run`` with the public inputs). Without ``pubs`` (the first
    instance's public inputs) nothing is proven. The SRS has
    ``srs_n`` points ((1 << k) + BLIND by default) from ``tau``; the proof
    draws its blinding from random.Random(seed) and must equal ``proof`` and
    be ``proof_len`` bytes long where they are given, as the vk's
    commitments must equal ``vk`` (JSON, the golden files' form)."""

    builders: list
    compiled: object
    pubs: list | None = None
    check: Callable[[], dict] | None = None
    k: int = 0
    tau: int = 777
    srs_n: int | None = None
    seed: int = KEY_SEED
    proof: bytes | None = None
    proof_len: int | None = None
    vk: dict | None = None


@dataclasses.dataclass
class Config:
    """One entry of the gate's path table: its name in chip_smoke.json,
    how it is built, whether its batch is replayed (in place of a proof),
    the kernels that must launch on its path, whether its keys are saved,
    loaded back and kept (for phase 9, multi-rank, and for later entries),
    and the earlier entry whose kept keys it proves with (``keys_from``;
    default its own set-up and keygen)."""

    name: str
    build: Callable[[], Built]
    replay: bool = False
    launched: tuple = ()
    keys: bool = False
    keys_from: str | None = None


def _k_of(compiled) -> int:
    """The rows' log2 a compiled circuit needs: its gates and instance rows,
    and its cells over 5 columns."""
    return max(compiled.num_gates + len(compiled.instance_idx),
               compiled.num_witness // 5 + 1).bit_length()


def golden_built(name: str) -> Built:
    """A committed golden case: the JAX package's proof, vk and parameters."""
    from halo2_rsa_tpu_torch import golden
    from halo2_rsa_tpu_torch.circuit import checker

    meta, want = golden.load(name)
    b, pubs = golden.build_circuit(name)
    return Built([b], checker.compile_circuit(b), pubs,
                 functools.partial(checker.run, b, pubs, device=DEVICE), k=meta["k"],
                 tau=meta["tau"], srs_n=meta["srs_n"], seed=meta["seed"], proof=want,
                 vk={key: meta["vk"][key] for key in
                     ("fixed_commitments", "sigma_commitments", "table_commitments")})


def _rsa_built(circ, k: int, key_circuit=None, proof_len: int | None = None) -> Built:
    """A Pkcs1v15Circuit to prove at ``k``, which its own rows must pick;
    its key made from ``key_circuit`` (compiled, with the circuit's
    fingerprint; default the circuit itself)."""
    from halo2_rsa_tpu_torch.utils.serialization import circuit_fingerprint

    compiled = circ.compile()
    if _k_of(compiled) != k:
        raise AssertionError(f"the circuit picked k={_k_of(compiled)}, expected {k}")
    if key_circuit is not None and (circuit_fingerprint(key_circuit)
                                    != circuit_fingerprint(compiled)):
        raise AssertionError("the instance's trace differs from its key's circuit")
    return Built([circ.builder], compiled if key_circuit is None else key_circuit,
                 circ.public_inputs, functools.partial(circ.check, device=DEVICE), k=k,
                 proof_len=proof_len)


def flagship_built() -> Built:
    """The flagship, RSA-1024 PKCS#1 v1.5 with SHA disabled, over a 32 B
    message signed by ``sign_fixture`` (both from random.Random(7)), k=15."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    msg = bytes(random.Random(7).randrange(256) for _ in range(32))
    n, sig = sign_fixture(1024, msg, rng=random.Random(7))
    hashed = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    return _rsa_built(Pkcs1v15Circuit.build(1024, n, sig, hashed_msg=hashed), 15, proof_len=2272)


def sha64_built() -> Built:
    """RSA-1024 + SHA-256 of a 64 B message in the circuit (halo2-rsa
    ``benches/bench.rs:349-367``), message and signature from
    random.Random(7), k=17: its MSMs have more points than ``msm._SEG``."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    rng = random.Random(7)
    msg = bytes(rng.randrange(256) for _ in range(64))
    n, sig = sign_fixture(1024, msg, rng=random.Random(7))
    return _rsa_built(Pkcs1v15Circuit.build(1024, n, sig, msg=msg), 17, proof_len=2272)


def zkemail_built() -> Built:
    """The zk-email cell's circuit over a ZKEMAIL_LEN B message, message and
    key from random.Random(7), k=20; its key made from the witness-free
    circuit (``without_witness(max_len=)``), as every length shares it."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    rng = random.Random(7)
    msg = bytes(rng.randrange(256) for _ in range(ZKEMAIL_LEN))
    n, sig = sign_fixture(ZKEMAIL_BITS, msg, rng=random.Random(7))
    circ = Pkcs1v15Circuit.build(ZKEMAIL_BITS, n, sig, msg=msg, max_len=ZKEMAIL_MAX_LEN)
    shape = Pkcs1v15Circuit.without_witness(ZKEMAIL_BITS, max_len=ZKEMAIL_MAX_LEN).compile()
    return _rsa_built(circ, 20, key_circuit=shape)


def config1_builders(count: int) -> list:
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


def config1_built() -> Built:
    """BASELINE config #1 at CHECK_BATCH distinct instances."""
    from halo2_rsa_tpu_torch.circuit import checker

    builders = config1_builders(CHECK_BATCH)
    return Built(builders, checker.compile_circuit(builders[0]))


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


def flagship_replay_built() -> Built:
    """REPLAY_DISTINCT flagship instances (``replay_flagship_circuits``), of
    one trace shape, tiled to REPLAY_BATCH; instance 0 to prove."""
    circs = replay_flagship_circuits(REPLAY_DISTINCT)
    compiled = circs[0].compile()
    for s, c in enumerate(circs):
        if not same_structure(c.compile(), compiled):
            raise AssertionError(f"flagship instance {s}'s trace shape differs from instance 0's")
    return Built([circs[i % REPLAY_DISTINCT].builder for i in range(REPLAY_BATCH)], compiled,
                 circs[0].public_inputs, k=15, proof_len=2272)


CONFIGS = [
    *[Config(name, functools.partial(golden_built, name))
      for name in ("arith_k5", "lookup_k5", "mulmod_k10")],
    Config("flagship", flagship_built, launched=KERNELS, keys=True),
    Config("config1", config1_built, replay=True, launched=("K1", "K1-pow")),
    Config("sha64", sha64_built, launched=KERNELS),
    Config("zkemail", zkemail_built, launched=KERNELS),
    Config("flagship_replay", flagship_replay_built, replay=True, launched=("K1", "K1-pow"),
           keys_from="flagship"),
]


def corrupt(builder, rng, values=None, gates: int = 3, lookups: int = 3) -> list:
    """A copy of ``values`` (default the builder's) with ``gates`` cells of
    gate rows set to random canonical values and ``lookups`` lookup cells
    (as many as the builder has, at most) set to 2^bits, 2^31 + 5 (bit 31 of
    limb 0 set) and 2^63 + 1 in turn; ``rng`` is a numpy Generator."""
    import numpy as np

    p = builder.field.p
    vals = list(builder.values if values is None else values)
    for c in rng.choice(np.unique(np.asarray(builder.gate_idx)), gates, replace=False):
        vals[int(c)] = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % p
    lookups = min(lookups, len(builder.lookups))
    for i, j in enumerate(rng.choice(len(builder.lookups), lookups, replace=False)):
        cell, bits = builder.lookups[int(j)]
        vals[cell] = (1 << bits, 1 << 31 | 5, 1 << 63 | 1)[i % 3]
    return vals


def checker_arrays(compiled, dev) -> tuple:
    """The batched checker's arrays of a compiled circuit on ``dev``: gate
    indices, each row's coefficients, and (bits, cells) per lookup width."""
    import numpy as np
    import torch

    idx = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)  # noqa: E731
    coef = torch.from_numpy(compiled.coef_table).to(dev)[idx(compiled.gate_coef_id)]
    return idx(compiled.gate_idx), coef, [(bits, idx(i)) for bits, i in compiled.lookup_groups]


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


def replay_instances(template, builders) -> list:
    """Each builder's input values keyed by the template's input cells (the
    instances ``WitnessProgram.generate`` takes)."""
    return [{i: b.values[i] for i in template.input_cells()} for b in builders]


def prove_checked(b: Built, values, label: str, keys=None) -> tuple:
    """``b``'s keys (``keys``, (srs, pk, vk), or set-up and keygen from
    ``b.compiled``) and one proof of ``values`` (the first instance's cells,
    or its (W, 8) limbs): verified, a wrong public input rejected, and its
    bytes, its length and the vk's commitments what ``b`` states. Returns
    (srs, pk, vk, proof)."""
    from halo2_rsa_tpu_torch import golden
    from halo2_rsa_tpu_torch.prover import kzg, plonk

    if keys is None:
        srs = kzg.setup(b.srs_n or (1 << b.k) + plonk.BLIND, tau=b.tau, device=DEVICE)
        pk, vk = plonk.keygen(b.compiled, srs, k=b.k)
    else:
        srs, pk, vk = keys
    for key, want in (b.vk or {}).items():
        if golden.points_to_json(getattr(vk, key)) != want:
            raise AssertionError(f"{label}: vk {key} differ from the JAX package's")
    proof = plonk.prove(pk, values, b.pubs, rng=random.Random(b.seed))
    if b.proof is not None and proof != b.proof:
        raise AssertionError(f"{label}: proof bytes differ from the JAX package's")
    if b.proof_len is not None and len(proof) != b.proof_len:
        raise AssertionError(f"{label}: proof is {len(proof)} B, expected {b.proof_len}")
    if not plonk.verify(vk, proof, b.pubs, device=DEVICE):
        raise AssertionError(f"{label}: the proof does not verify")
    bad = list(b.pubs)
    bad[0] += 1
    if plonk.verify(vk, proof, bad, device=DEVICE):
        raise AssertionError(f"{label}: verify accepted a wrong public input")
    return srs, pk, vk, proof


def _recorded(run) -> dict:
    """``run()``'s calls (``_calls_of``) and the launches it made, by
    kernel."""
    before = launch_counts()
    calls = _calls_of(run)
    return dict(calls=calls, launches={k: v - before[k] for k, v in launch_counts().items()})


def _merged(steps: dict) -> dict:
    """{kernel: {shape: calls}} over every step's recorded calls."""
    hist = collections.defaultdict(collections.Counter)
    for step in steps.values():
        for key, calls in step["calls"].items():
            for c in calls:
                hist[key][tuple(c[:-1])] += c[-1]
    return hist


CHECK_OK = {"ok": True, "gate_violations": 0, "lookup_violations": 0, "instance_ok": True}


def hold_path(report, cfg: Config, held, owner=None) -> dict:
    """[3 paths] One configuration's path on the card (the module's
    docstring, phase 3): its steps (replay, check, corrupted, prove) each
    run under ``_calls_of``, so that ``report["paths"][cfg.name]["steps"]``
    holds each step's launch counts and the shape of each launch; its keys'
    round trip (``cfg.keys``); one warm prove's shapes (``warm``); then the
    steps again with each shape's first launch copied, and every shape that
    ``held`` ({kernel: shapes}) lacks held bitwise against its plain version
    and added to it. A single instance is checked by its own ``b.check`` and
    its seeded corruption by ``checker.check``, ``failing_gates`` and
    ``explain``, each equal to the CPU's; a batch by ``batched_violations``
    and ``corrupted_counts``. ``owner`` is the ``hold_path`` result of the
    entry ``cfg.keys_from``, whose keys are proven with (its circuit must
    have this one's trace shape). Returns the built configuration, its keys
    when ``cfg.keys`` and its corrupted instances ({instance: (W, 8) limbs})
    with their counts."""
    import numpy as np
    import torch

    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.prover import plonk
    from halo2_rsa_tpu_torch.witness import WitnessProgram

    t0 = time.perf_counter()
    b = cfg.build()
    label = cfg.name
    single = len(b.builders) == 1
    keys_in = None
    if owner is not None:
        if not same_structure(b.compiled, owner["built"].compiled):
            raise AssertionError(f"{label}: the trace shape differs from {cfg.keys_from}'s")
        keys_in = owner["keys"][:3]
    rec = dict(batch=len(b.builders), gates=int(b.compiled.num_gates),
               cells=int(b.compiled.num_witness), k=b.k, steps={})
    report.setdefault("paths", {})[label] = rec
    want = np.stack([checker.witness_limbs(x) for x in b.builders])
    synth = torch.from_numpy(want).to(DEVICE)
    arrays = checker_arrays(b.compiled, DEVICE)
    if cfg.replay:
        prog = WitnessProgram(b.builders[0])
        insts = replay_instances(b.builders[0], b.builders)

    rng = np.random.default_rng(29)
    ids = sorted(int(i) for i in rng.choice(len(b.builders), min(6, len(b.builders)),
                                             replace=False))
    bad = {inst: corrupt(b.builders[inst], rng, gates=3 - i % 3, lookups=2 - i % 2)
           for i, inst in enumerate(ids)}
    if single:
        bad_w = checker.witness_limbs(bad[ids[0]])

        def judged(device):
            return (checker.check(b.compiled, bad_w, device=device),
                    checker.failing_gates(b.compiled, bad_w, limit=1 << 20, device=device),
                    checker.explain(b.builders[0], bad_w, limit=20, device=device))

        cpu = judged("cpu")
        if cpu[0]["ok"]:
            raise AssertionError(f"{label}: the corrupted witness passed the CPU's check")
    state = {}

    def replay():
        inputs, bigvals = prog.host_inputs(insts)
        state["w"] = prog.run(torch.from_numpy(inputs).to(DEVICE),
                              torch.from_numpy(bigvals).to(DEVICE))
        got = state["w"].cpu().numpy()
        wrong = [i for i in range(len(want)) if not np.array_equal(got[i], want[i])]
        if wrong:
            raise AssertionError(f"{label}: replayed witnesses {wrong} differ from synthesis")

    def check():
        if single:
            res = b.check()
            if res != CHECK_OK:
                raise AssertionError(f"{label}: its check on the card: {res}")
            return
        gates, lk = batched_violations(b.compiled, state.get("w", synth), arrays)
        if int(gates.sum()) or int(lk.sum()):
            raise AssertionError(f"{label}: a witness has violations on the card")

    def corrupted():
        if not single:
            state["counts"] = corrupted_counts(b.compiled, synth, arrays, bad, label)
            return
        card = judged(DEVICE)
        if card != cpu:
            raise AssertionError(f"{label}: the corrupted witness's check, failing_gates or "
                                 f"explain differ: card {card[0]}, cpu {cpu[0]}")
        state["counts"] = [[card[0]["gate_violations"], card[0]["lookup_violations"]]]

    def prove():
        state["keys"] = prove_checked(b, b.builders[0].values, label, keys_in)

    steps = {"replay": replay} if cfg.replay else {}
    steps.update(check=check, corrupted=corrupted)
    if b.pubs is not None and not cfg.replay:
        steps["prove"] = prove

    torch.cuda.reset_peak_memory_stats()
    for name, fn in steps.items():
        rec["steps"][name] = _recorded(fn)
    rec["launches"] = {key: sum(s["launches"][key] for s in rec["steps"].values())
                       for key in KERNELS}
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    unused = [key for key in cfg.launched if not rec["launches"][key]]
    if unused:
        raise AssertionError(f"{label}: {unused} never launched on its path")
    counts = state["counts"]
    rec["corrupted"] = dict(instances=ids, counts=counts)
    if single:
        rec["corrupted"]["failing_rows"] = len(cpu[1])

    keys = state.pop("keys", None)
    if keys is not None:
        proof = keys[3]
        rec.update(proof_bytes=len(proof), proof_sha256=hashlib.sha256(proof).hexdigest())
        rec["warm"] = _recorded(lambda: plonk.prove(keys[1], b.builders[0].values, b.pubs,
                                                    rng=random.Random(b.seed)))
        if cfg.keys:
            rec["keys"] = _key_artifacts(report, b, *keys)
        else:
            keys = None
    if cfg.replay and b.pubs is not None:
        # instance 0 proven from its replayed witness: the same bytes as
        # from its synthesized one
        srs, pk, vk, proof = prove_checked(b, state["w"][0].cpu().numpy(), label, keys_in)
        if proof != plonk.prove(pk, b.builders[0].values, b.pubs, rng=random.Random(b.seed)):
            raise AssertionError(f"{label}: the proof from the replayed witness differs from the "
                                 f"synthesized witness's")
        rec.update(proof_bytes=len(proof), proof_sha256=hashlib.sha256(proof).hexdigest())
        del srs, pk, vk
    state.clear()  # the first run's witnesses and keys

    # the steps again, each new shape's first launch copied
    keep = {}
    _calls_of(lambda: [fn() for fn in steps.values()], keep, skip=held)
    state.clear()
    hist = _merged(rec["steps"])
    rec["held"] = _hold_path_calls(keep, hist, held, label)
    del keep
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    proved = ""
    if "proof_sha256" in rec:
        proved = (f" | proof {rec['proof_bytes']} B (sha256 {rec['proof_sha256'][:16]}) verified, "
                  f"a wrong public input rejected"
                  + (", the JAX-made bytes and vk" if b.proof is not None else "")
                  + (f", from {cfg.keys_from}'s keys" if keys_in is not None else "")
                  + (", from the replayed witness as from synthesis" if cfg.replay else ""))
    checked = ("its own check ok (instance cells too); corrupted: check "
               + f"{counts[0]}, failing_gates ({len(cpu[1])} rows) and explain equal the CPU's"
               if single else f"0 violations in one batched pass; corrupted instances {ids}: "
               f"gate/lookup counts {counts} equal the CPU's")
    line(f"[3 paths] {label}: {rec['gates']} gates, {rec['cells']} cells"
         + (f", k={b.k}" if b.pubs is not None else "") + f", batch {rec['batch']} | "
         + ("replayed bitwise equal to synthesis; " if cfg.replay else "")
         + "on the card " + checked + proved + " | launches " + ", ".join(
             f"{k_}={v}" for k_, v in rec["launches"].items() if v)
         + f" | {sum(len(v) for v in hist.values())} shapes, {len(rec['held'])} new ones held "
         f"bitwise on the path's own inputs | peak {rec['peak_mem_bytes'] / 2**30:.2f} GiB | "
         f"{rec['seconds']:.1f} s")
    return dict(built=b, keys=keys, bad={i: checker.witness_limbs(v) for i, v in bad.items()},
                bad_counts=dict(zip(ids, counts)))


def _key_artifacts(report, b: Built, srs, pk, vk, proof) -> dict:
    """The configuration's SRS, pk and vk saved under a fresh directory in
    .keys/ and loaded back on the card: a prove from the loaded keys must
    equal ``proof`` (from the generated keys with the same rng), and the
    loaded vk must verify it. Then ``load_or_keygen`` twice on another fresh
    directory: generated, then loaded, with the same proof bytes. The
    directory is removed."""
    import shutil
    import tempfile

    import torch

    from halo2_rsa_tpu_torch.prover import plonk
    from halo2_rsa_tpu_torch.utils import serialization as ser

    def prove(key):
        return plonk.prove(key, b.builders[0].values, b.pubs, rng=random.Random(b.seed))

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
        srs2 = ser.load_srs(paths["srs.npz"], device=DEVICE)
        pk2 = ser.load_pk(paths["pk.npz"], srs2)
        vk2 = ser.load_vk(paths["vk.json"])
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        if dataclasses.asdict(vk2) != dataclasses.asdict(vk):
            raise AssertionError("the vk loaded from its file differs from the generated vk")
        if prove(pk2) != proof:
            raise AssertionError("the proof from the loaded keys differs from the generated keys'")
        if not plonk.verify(vk2, proof, b.pubs, device=DEVICE):
            raise AssertionError("the loaded vk does not verify the proof")
        runs = []
        for _ in range(2):
            _, pk3, _, loaded = ser.load_or_keygen(b.compiled, b.k, os.path.join(d, "fresh"),
                                                   tau=b.tau, device=DEVICE)
            runs.append(loaded)
            if prove(pk3) != proof:
                raise AssertionError(f"load_or_keygen (loaded={loaded}): the proof differs")
        if runs != [False, True]:
            raise AssertionError(f"load_or_keygen on a fresh directory: loaded {runs}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    line(f"[3 keys] SRS + pk + vk saved in {out['save_s']:.3f} s "
         f"({sum(out['file_bytes'].values()) / 2**20:.1f} MiB), loaded back in {out['load_s']:.3f} s; "
         f"the proof from the loaded keys equals the generated keys' byte for byte and the "
         f"loaded vk verifies it | load_or_keygen on a fresh directory: generated, then loaded, "
         f"same proof bytes | {report['device']['smi']}")
    return out


def _copy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return tuple(_copy(v) for v in x)
    return x


def _calls_of(run, keep=None, skip=None) -> dict:
    """{kernel: [[shape..., calls], ...]} over ``run()``, read by
    pass-through wrappers around the K1-K4 wrappers: K1 (products, rows of
    b, broadcast mode: 0 b of a's shape, 1 cycle, 2 repeat), K1-pow
    (elements, exponent bits), K1-prefix (rows, length, 1 reversed else 0),
    K2 (rows, C), K3 (points,), K3-scan (rows, L, 1 with the tree else 0),
    K3-splice (rows, buckets, npad, nchunks), K4 (points, doublings), NTT
    (polys, log_n, 1 inverse else 0; read around ``ntt._ntt_graph``). Each
    call launches its kernel once, K1-prefix ``prefix_launches`` times (at
    most three), the NTT log_n times (once a stage; none on the CPU). The
    launches made inside the wrappers must add up to each kernel's launch
    count over the same run.
    Given ``keep`` (a dict), the first launch at each (kernel, shape) that
    ``skip`` ({kernel: shapes}) lacks is kept there as (its plain version,
    copies of its arguments and of its output)."""
    from halo2_rsa_tpu_torch.fields import cuda_mont
    from halo2_rsa_tpu_torch.prover import cuda_g1, ntt

    calls = {key: collections.Counter() for key in launch_counts()}
    launched = collections.Counter()
    skip = skip or {}

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
            if key == "NTT" and made != (shape[1] if args[0].is_cuda else 0):
                raise AssertionError(f"an NTT at {shape} made {made} launches, not one a stage")
            if key != "NTT" and made > (3 if key == "K1-prefix" else 1):
                raise AssertionError(f"one call of {key} at {shape} made {made} launches")
            launched[key] += made
            if keep is not None and (key, shape) not in keep and shape not in skip.get(key, ()):
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


def _hold_path_calls(keep: dict, hist: dict, held: dict, path: str) -> list:
    """Each shape of ``hist`` (a path's calls: {kernel: {shape: calls}})
    that ``held`` ({kernel: shapes} an earlier path held) lacks,
    held bitwise against its plain version on the path's own inputs: those
    of the first launch at that shape in a second run of the path
    (``keep``); each is then added to ``held``. Returns one row per shape
    held. Each copy is dropped once held."""
    import torch

    # give back the blocks the second run freed, so that the plain versions'
    # temporaries fit beside the copies (a k=20 path's copies take ~23 GB)
    torch.cuda.empty_cache()
    out = []
    for key, shapes in hist.items():
        for shape in sorted(s_ for s_ in shapes if s_ not in held[key]):
            if (key, shape) not in keep:
                raise AssertionError(f"{key} at {shape} was launched by the first run of the "
                                     f"{path} path only")
            plain, args, kw, got = keep.pop((key, shape))
            err = _max_abs_err(got, plain(*args, **kw))
            del args, got
            if err:
                raise AssertionError(f"{key} at {shape} on the {path} path differs from its "
                                     f"plain version")
            held[key].add(shape)
            out.append(dict(kernel=key, shape=list(shape), calls=shapes[shape]))
    return out


# ---------------------------------------------------------------------------
# Phases 4-7: the kernels alone, P1, P2, bounds
# ---------------------------------------------------------------------------

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
    line("[4 empty] empty launch: card {ms:.4f} ms, host-paced {host_paced_ms:.4f} ms".format(
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


def _warm(report) -> dict:
    """{kernel: {shape: calls}} of one flagship warm prove (phase 3)."""
    return {key: {tuple(c[:-1]): c[-1] for c in v}
            for key, v in report["paths"]["flagship"]["warm"]["calls"].items()}


def phase_k1(report, kernels):
    """K1 at every shape (products, rows of b, broadcast mode) one warm
    prove launches it with, at 2^20 products (the kernels line's K1 row) and
    at the batched checker's shape (config #1's gate coefficients read in
    place over its batch), on random BN254 Fr operands through
    ``vecfield.mont_mul`` (``k1_times``): each bitwise against the plain
    product of the materialised operands and timed on the card alone. Then
    K1 beside P2's staged tiles (d') at the path's shapes of at least
    K1_STAGED_FROM products, both with b of a's shape."""
    import torch

    from halo2_rsa_tpu_torch.bench import mont_layout
    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    fc = vecfield.consts(BN254_FR)
    hist = _warm(report)["K1"]
    c1 = report["paths"]["config1"]
    out = k1_times(
        lambda x, y: vecfield.mont_mul(fc, x, y),
        [("path", *s) for s in sorted(hist)] + [("parity", 1 << 20, 1 << 20, 0),
                                                ("checker", c1["batch"] * c1["gates"],
                                                 c1["gates"], 1)],
        plain=lambda x, y: cuda_mont.mont_mul_plain(
            fc, *[t.contiguous() for t in torch.broadcast_tensors(x, y)]))
    for r in out:
        r["launches_per_warm_prove"] = hist.get((r["n"], r["nb"], r["mode"]), 0) \
            if r["kind"] == "path" else 0
    row = out[-2]
    kernels["K1"].update(ms=row["ms"], plain_ms=row["plain_ms"], shape=f"{row['n']} products",
                         max_abs_err=max(r["max_abs_err"] for r in out))
    report["k1"] = dict(shapes=out)
    card = sum(r["launches_per_warm_prove"] * r["ms"] for r in out)
    report["k1"]["card_ms_per_warm_prove"] = card
    line(f"[4 K1] {len(hist)} path shapes, {min(s[0] for s in hist)} to {max(s[0] for s in hist)} "
         f"products per launch, {sum(hist.values())} launches per warm prove: all bitwise equal "
         f"| card time per warm prove (sum of launches x queued ms) {card:.3f} ms")
    for mode, name in enumerate(K1_MODES):
        rows = [r for r in out if r["kind"] == "path" and r["mode"] == mode]
        line(f"[4 K1] {name}: {len(rows)} shapes, "
             f"{sum(r['launches_per_warm_prove'] for r in rows)} launches per warm prove: "
             + ", ".join(f"{r['n']} x {r['nb']} rows ({r['launches_per_warm_prove']})"
                         for r in rows))
    r = out[-1]
    line(f"[4 K1] the checker's shape ({r['n']} products over {r['nb']} coefficient rows): "
         f"bitwise equal | card {r['ms']:.4f} ms | 0 launches per warm prove")
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
        line(f"[4 K1] {n} products, b of a's shape: K1 {row['k1_ms']:.4f} ms "
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

    e = BN254_FR.p - 2
    fc = vecfield.consts(BN254_FR)
    per_prove = report["paths"]["flagship"]["warm"]["launches"]
    if per_prove["K1-pow"] != 1:
        raise AssertionError(f"K1-pow launched {per_prove['K1-pow']} times per warm prove, "
                             f"expected 1 (the one field inversion)")
    hist = {}
    for (n, bits), calls in _warm(report)["K1-pow"].items():
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
        line(f"[4 K1-pow] {r['kind']} n={r['n']}: bitwise equal | card {r['ms']:.4f} ms for a "
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

    fc = vecfield.consts(BN254_FR)
    per_prove = report["paths"]["flagship"]["warm"]["launches"]
    hist = _warm(report)["K1-prefix"]
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
        line(f"[4 K1-prefix] path rows={r['rows']} n={r['n']} reverse={r['reverse']}: bitwise "
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
    line(f"[4 K1-prefix] launches per warm prove: K1 mont_mul {per_prove['K1']}, K1-pow "
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


def k2_indexed_times(shapes) -> list:
    """K2 reading its affine points in place through a bucket sort's
    permutation (``cuda_g1.IndexedRows``), as the MSM's bucket scan runs it,
    at each (kind, m, c) of ``shapes``: m * c / n windows' stable sorts of
    random 8-bit digits over one n-point affine source (n = the largest
    power of two up to 2^15 that divides m * c: the MSM's segment) from
    ``_test_points``, every start the identity. Held bitwise against the
    dense launch on the rows gathered in that order; then ms per call on
    the card alone (``queued_ms``) and paced by the host (``chain_ms``), and
    the dense launch's queued ms on the gathered rows (``dense_ms``)."""
    import math

    import torch

    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec
    from halo2_rsa_tpu_torch.utils.profiling import chain_ms

    fq = g1_vec.FQ
    _, (ax, ay), _ = _test_points(K4_BIG, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = []
    for kind, m, c in shapes:
        n = math.gcd(m * c, 1 << 15)
        digits = torch.randint(0, 256, (m * c // n, n), device="cuda", generator=gen)
        order = torch.sort(digits, dim=1, stable=True)[1].view(m, c, 1)
        rows = cuda_g1.IndexedRows(order, ax[:n], ay[:n])
        dense = (ax[order[..., 0]], ay[order[..., 0]])
        start = g1_vec.identity((m,), device="cuda")
        got = cuda_g1.point_scan_mixed(fq, start, rows)
        err = _max_abs_err(got, cuda_g1.point_scan_mixed(fq, start, dense))
        if err:
            raise AssertionError(f"K2 through a permutation at {m} rows x C {c} differs from "
                                 f"the dense launch on the gathered rows")
        del got
        indexed = lambda q: (cuda_g1.point_scan_mixed(fq, start, rows), q)[1]  # noqa: E731
        gathered = lambda q: (cuda_g1.point_scan_mixed(fq, start, dense), q)[1]  # noqa: E731
        out.append(dict(kind=kind, m=m, c=c, source=n, max_abs_err=err,
                        ms=queued_ms(indexed, start[0], K2_ITERS),
                        host_paced_ms=chain_ms(indexed, start[0], K2_ITERS),
                        dense_ms=queued_ms(gathered, start[0], K2_ITERS)))
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
    """[4 NTT] The NTT at every (polys, log_n, direction) one flagship warm
    prove calls it with, and at the same calls at k=18's sizes (log_n +
    NTT_K18_SHIFT): each bitwise against the torch loop, its time per NTT
    and per stage on the card alone beside its bytes bound, and the loop's
    time; log_n launches a call."""
    hist = _warm(report)["NTT"]
    want = sum(calls * n for (_, n, _), calls in hist.items())
    launched = report["paths"]["flagship"]["warm"]["launches"]["NTT"]
    if launched != want:
        raise AssertionError(f"the NTT launched {launched} times per warm prove, {want} stages "
                             f"expected")
    shapes = [("path", *k) for k in sorted(hist)]
    shapes += [("k18", p, n + NTT_K18_SHIFT, inv) for _, p, n, inv in shapes]
    out = ntt_times(shapes)
    for r in out:
        r["calls_per_warm_prove"] = hist[r["polys"], r["log_n"] - NTT_K18_SHIFT * (r["kind"] == "k18"),
                                         r["inverse"]]
        line(f"[4 NTT] {r['kind']} {r['polys']} x 2^{r['log_n']} "
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
    line(f"[4 NTT] {len(hist)} path shapes, {sum(hist.values())} calls and {want} launches per "
         f"warm prove | card time per warm prove (sum of calls x queued ms): flagship "
         f"{card['path']:.3f} ms, the same calls at k=18's sizes {card['k18']:.3f} ms")


def phase_k2(report, kernels):
    """K2 at the path's shapes and at 2^16 points with C = 1
    (``k2_times``), and at the path's shapes again in the path's form, its
    rows read through a sort's permutation (``k2_indexed_times``)."""
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    hist = _warm(report)["K2"]
    shapes = [("path", m, c) for m, c in sorted(hist, reverse=True)] + [("parity", K4_BIG, 1)]
    start, rows = k2_inputs(max(m for _, m, _ in shapes), max(c for _, _, c in shapes))
    out = k2_times(lambda s, r: lambda: cuda_g1.point_scan_mixed(fq, s, r), shapes, start, rows,
                   plain=lambda s, r: cuda_g1.point_scan_mixed_plain(fq, s, r))
    for r in out:
        r["launches_per_warm_prove"] = hist.get((r["m"], r["c"]), 0)
        line(f"[4 K2] {r['kind']} m={r['m']} C={r['c']}: bitwise equal | card {r['ms']:.4f} ms "
             f"({r['ms'] / r['c'] * 1e3:.2f} us per add step), host-paced "
             f"{r['host_paced_ms']:.4f} ms"
             + (f", plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
             + f" | {r['launches_per_warm_prove']} launches per warm prove")
    # the path's form: the bucket scan's points read through the sort's
    # permutation; a path shape's ms (the bounds' and the rank's) is that
    # form's, beside the dense launch's (dense_ms)
    indexed = {(r["m"], r["c"]): r for r in k2_indexed_times(
        [s_ for s_ in shapes if s_[0] == "path"])}
    for r in out:
        if r["kind"] != "path":
            continue
        ind = indexed[r["m"], r["c"]]
        line(f"[4 K2] indexed m={r['m']} C={r['c']} from {ind['source']} points: bitwise equal "
             f"to the dense launch on the gathered rows | card {ind['ms']:.4f} ms (dense "
             f"{ind['dense_ms']:.4f} ms on the same rows), host-paced "
             f"{ind['host_paced_ms']:.4f} ms")
        r.update(dense_ms=r["ms"], ms=ind["ms"], host_paced_ms=ind["host_paced_ms"],
                 source=ind["source"])
    report["k2"] = dict(shapes=out)
    # the kernels line's K2 row: the path's largest shape
    row = max((r for r in out if r["kind"] == "path"), key=lambda r: r["m"])
    kernels["K2"].update(
        ms=row["ms"], host_paced_ms=row["host_paced_ms"], plain_ms=row["plain_ms"],
        max_abs_err=max([kernels["K2"]["max_abs_err"]] + [r["max_abs_err"] for r in out]),
        shape=f"{row['m']} rows x C {row['c']} read through a stable sort's order from "
              f"{row['source']} points (the bucket scan of one pipeline of the flagship's "
              f"largest msm_many call)",
    )


def _row_fields(kernel, row) -> dict:
    """A kernels-line row's times from one shape's timing (every shape's
    error is 0, or its timing raised)."""
    return dict(ms=row["ms"], host_paced_ms=row["host_paced_ms"], plain_ms=row["plain_ms"],
                max_abs_err=max(kernel["max_abs_err"], row["max_abs_err"]))


def phase_k3(report, kernels):
    """K3 at the path's shapes and at 2^16 points (``k3_times``), and its
    row scans at theirs (``k3_scan_times``)."""
    import torch

    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    hist = {n: k for (n,), k in _warm(report)["K3"].items()}
    shapes = [("path", n) for n in sorted(hist, reverse=True)] + [("parity", K4_BIG)]
    out = k3_times(lambda p, q: cuda_g1.point_add(fq, p, q),
                   lambda p, q: cuda_g1.point_add_plain(fq, p, q), shapes, k4_points())
    for r in out:
        r["launches_per_warm_prove"] = hist.get(r["n"], 0) if r["kind"] == "path" else 0
        line(f"[4 K3] {r['kind']} n={r['n']}: bitwise equal | card {r['ms']:.4f} ms, host-paced "
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
    hist = _warm(report)["K3-scan"]
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
        line(f"[4 K3-scan] path rows={r['rows']} L={r['len']} tree={r['tree']}: bitwise equal | "
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
    hist = _warm(report)["K3-splice"]
    shapes = [("path", *k) for k in sorted(hist, reverse=True)]
    rows, b, npad, nchunks = shapes[0][1:]
    out = k3_splice_times(lambda w, i, e: lambda: cuda_g1.bucket_splice(fq, w, i, e), shapes,
                          k3_splice_inputs(rows, b, npad, nchunks),
                          plain=lambda w, i, e: cuda_g1.bucket_splice_plain(fq, w, i, e))
    for r in out:
        r["launches_per_warm_prove"] = hist[r["rows"], r["buckets"], r["npad"], r["nchunks"]]
        line(f"[4 K3-splice] path rows={r['rows']} buckets={r['buckets']} npad={r['npad']} "
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
    per_shape = _warm(report)["K4"]
    shapes = [("path", n, reps) for n, reps in sorted(per_shape)] + \
        [("parity", K4_BIG, 1), ("parity", K4_BIG, 8)]
    out = k4_times(lambda p, reps: cuda_g1.point_double(fq, p, reps),
                   lambda p, reps: cuda_g1.point_double_plain(fq, p, reps), shapes, k4_points())
    for r in out:
        r["launches_per_warm_prove"] = per_shape.get((r["n"], r["reps"]), 0)
        line(f"[4 K4] {r['kind']} n={r['n']} reps={r['reps']}: bitwise equal | card "
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
              f"largest msm_many call)",
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
    line(f"[5 P1] all 7 bodies bitwise equal to their plain versions at (16, 2^{P1_LOG_N}), "
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
        line(f"[5 P1] {body:10s}: {r['ms']:.4f} ms  {r['tops']:6.2f} T ops/s  "
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
    line(f"[5 P1] launches in the timed run: {launches} | queued on the card: " + ", ".join(
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
    line(f"[6 P2] (b') and (d') for T in {mont_layout.THREADS} bitwise equal to their plain "
         f"versions at 2^{P2_LOG_N} products (bn254_fr)")

    for key in mont_layout.LAUNCHES:
        mont_layout.LAUNCHES[key] = 0
    res = mont_layout.run(P2_LOG_N, P2_ITERS, device="cuda")  # raises unless all equal K1
    launches = dict(mont_layout.LAUNCHES)
    for name, r in res["variants"].items():
        line(f"[6 P2] {name:6s}: {r['ms']:9.4f} ms  {r['mel_s']:9.1f} M el/s  "
             f"{r['gb_s']:7.1f} GB/s = {r['gb_s'] / (HBM_BYTES_S / 1e9) * 100:5.1f} % of 3.35 TB/s")
    line("[6 P2] (a), (b'), (c) and every (d') bitwise equal over all products; launches "
         f"in the timed run: {launches}")
    report["p2"] = res
    for key, count in launches.items():
        if count == 0:
            raise AssertionError(f"P2 {key} was never launched by its timed run")
    # the kernels line's times: queued behind a spin kernel (the timed run's
    # chains, paced by the host, are kept as host_paced_ms)
    q_lm = queued_ms(cases["P2-lm"][0], at, QUEUED_ITERS)
    q_staged = queued_ms(cases[f"P2-staged-{P2_THREADS}"][0], a, QUEUED_ITERS)
    line(f"[6 P2] queued on the card: b' {q_lm:.4f} ms, d'{P2_THREADS} {q_staged:.4f} ms")
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
    and its instructions over the pipes' and issue's rates (phase 7's
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
    line(f"[7 bounds] per pipe {PIPE_LANES_PER_SM} x {sms} SMs x {mhz:.0f} MHz = "
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
        line(f"[7 bounds] {key}: {k['ms']:.4f} ms vs bound {k['bound_ms']:.4f} ms "
             f"({k['bound_by']}; bytes {sum(mem):.4f}, pipes/issue {sum(ops):.4f}; int at P1's "
             f"rate {p1_rate_ms:.4f}) = {k['bound_ms'] / k['ms'] * 100:.1f} % of bound")
    empty = report["empty_launch"]["ms"]
    line("[7 bounds] K3 SASS per add (the whole kernel: load, add, canonicalise, store): FMA "
         "pipe {fma}, ALU pipe {alu}, issued {issued}".format(**sass["K3"])
         + "; K3-splice per bucket (three adds): FMA pipe {fma}, ALU pipe {alu}, issued "
           "{issued}".format(**sass["K3-splice"]))
    for key, step in (("K2", "add"), ("K4", "doubling")):
        line(f"[7 bounds] {key} SASS per {step} (its loop body): FMA pipe {{fma}}, ALU pipe "
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
                line(f"[7 bounds] {key} {r['kind']} {dims(r)}: {r['ms']:.4f} ms vs bound "
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
        line(f"[7 bounds] K1 path, {1 << max(b - 1, 0)}-{1 << b} products per launch: "
             f"{bk['shapes']} shapes, {bk['launches']} launches per warm prove, "
             f"{bk['ms']:.4f} ms (sum of launches x queued ms) vs bound {bk['bound_ms']:.6f} ms "
             f"= {bk['bound_ms'] / bk['ms'] * 100:.1f} % of bound")
    k1 = report["k1"]
    line(f"[7 bounds] K1 over its path shapes: {k1['card_ms_per_warm_prove']:.4f} ms of card time "
         f"per warm prove, rank {rank['K1']:.4f} ms (bound {k1['card_ms_per_warm_prove'] - rank['K1']:.4f} "
         f"ms); at the 2^20 parity shape {kernels['K1']['ms']:.4f} ms vs bound "
         f"{kernels['K1']['bound_ms']:.4f} ms")
    family = {"K1": k1["card_ms_per_warm_prove"]}
    for key in ("K1-pow", "K1-prefix"):
        family[key] = sum(r.get("calls_per_warm_prove", r["launches_per_warm_prove"]) * r["ms"]
                          for r in report[key.lower().replace("-", "_")]["shapes"])
    report["k1_family_card_ms_per_warm_prove"] = family
    line("[7 bounds] K1's kernels, card ms per warm prove (sum of launches or calls x queued ms): "
         + ", ".join(f"{k_} {v:.4f}" for k_, v in family.items())
         + f"; {sum(family.values()):.4f} in all")
    report["rank_ms_per_warm_prove"] = rank
    line("[7 bounds] rank, launches per warm prove x (ms - bound ms): " + ", ".join(
        f"{k_} {v:.2f} ms" for k_, v in rank.items()))


def phase_path_times(report, kernels):
    """[8 paths] One zk-email warm prove's shapes (phase 3's ``warm``),
    timed on the card alone: the NTT at each (``ntt_times``, beside its
    bytes bound), K1 at each (``k1_times``, beside ``shape_bound``), and K2
    and the row scans at each that the flagship's warm prove does not launch
    (phase 4 times those it does). Then K1 at the flagship replay's largest
    shape and K1-pow at its inversion (its replay step's), the kernels
    line's ``K1-replay`` and ``K1-pow-replay`` rows."""
    import torch

    from halo2_rsa_tpu_torch.fields import cuda_mont, vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    tag = "[8 paths]"
    zk = report["paths"]["zkemail"]
    out = zk["times"] = {}
    whist = {key: {tuple(c[:-1]): c[-1] for c in v} for key, v in zk["warm"]["calls"].items()}
    rows = ntt_times([("k20", *s_) for s_ in sorted(whist["NTT"])])
    for r in rows:
        r["calls_per_warm_prove"] = whist["NTT"][r["polys"], r["log_n"], r["inverse"]]
        line(f"{tag} zk-email NTT {r['polys']} x 2^{r['log_n']} "
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
        line(f"{tag} zk-email K1 {r['n']} x {r['nb']} rows ({K1_MODES[r['mode']]}; "
             f"{r['launches_per_warm_prove']} a warm prove): card {r['ms']:.4f} ms vs bound "
             f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = {r['bound_ms'] / r['ms'] * 100:.1f} %")
    out["k1"] = rows
    card = {"NTT": sum(r["calls_per_warm_prove"] * r["ms"] for r in out["ntt"]),
            "K1": sum(r["launches_per_warm_prove"] * r["ms"] for r in out["k1"])}
    out["card_ms_per_warm_prove"] = card
    line(f"{tag} zk-email card time per warm prove (sum of launches x queued ms): NTT "
         f"{card['NTT']:.3f} ms, K1 {card['K1']:.3f} ms")

    fq = g1_vec.FQ
    flag = _warm(report)
    new = {key: sorted(s_ for s_ in whist[key] if s_ not in flag[key]) for key in ("K2", "K3-scan")}
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
    line(f"{tag} zk-email warm-prove shapes the flagship's does not launch, timed: K2 "
         + (", ".join(f"m={r['m']} C={r['c']} {r['ms']:.4f} ms ({whist['K2'][r['m'], r['c']]} "
                      f"a warm prove)" for r in out["k2"]) or "none")
         + " | K3-scan "
         + (", ".join(f"rows={r['rows']} L={r['len']} tree={r['tree']} {r['ms']:.4f} ms "
                      f"({whist['K3-scan'][r['rows'], r['len'], r['tree']]} a warm prove)"
                      for r in out["k3_scan"]) or "none")
         + f" | {report['device']['smi']}")

    # K1 and K1-pow at the flagship replay's largest shapes
    step = report["paths"]["flagship_replay"]["steps"]["replay"]
    e = BN254_FR.p - 2
    sass = report["sass"]
    n, nb, mode = max((tuple(c[:-1]) for c in step["calls"]["K1"]), key=lambda s_: s_[0])
    row = k1_times(lambda x, y: vecfield.mont_mul(fc, x, y), [("replay", n, nb, mode)],
                   plain=lambda x, y: cuda_mont.mont_mul_plain(
                       fc, *[t.contiguous() for t in torch.broadcast_tensors(x, y)]))[0]
    row.update(shape_bound(report, *_k1_part(sass, row)))
    kernels["K1-replay"] = dict(
        name="mont_mul", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", launches=step["launches"]["K1"],
        max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None, timing="queued",
        shape=f"{n} products, {nb} rows of b ({K1_MODES[mode]}): the flagship replay's largest "
              f"(batch {REPLAY_BATCH}); launches per generate")
    pn = max(c[0] for c in step["calls"]["K1-pow"])
    prow = k1_pow_times(lambda x: cuda_mont.mont_pow(fc, x, e), [("replay", pn)],
                        plain=lambda x: cuda_mont.mont_pow_plain(fc, x, e))[0]
    prow.update(shape_bound(report, *_pow_part(sass, prow)))
    kernels["K1-pow-replay"] = dict(
        name="mont_pow", route="cuda", source="halo2_rsa_tpu_torch/csrc/mont_pow.cu",
        replaces="halo2_rsa_tpu/fields/pallas_mont.py:112", launches=step["launches"]["K1-pow"],
        max_abs_err=prow["max_abs_err"], ms=prow["ms"], plain_ms=prow["plain_ms"],
        bound_ms=prow["bound_ms"], bound_by=prow["bound_by"], library_ms=None, timing="queued",
        shape=f"{pn} elements, e = p - 2 over BN254 Fr (the flagship replay's inv0 group at "
              f"batch {REPLAY_BATCH}); launches per generate")
    report["replay_times"] = dict(k1=row, k1_pow=prow)
    for key in ("K1-replay", "K1-pow-replay"):
        k = kernels[key]
        line(f"{tag} {key}: {k['shape']}: card {k['ms']:.4f} ms vs bound "
             f"{k['bound_ms']:.4f} ms ({k['bound_by']}) = {k['bound_ms'] / k['ms'] * 100:.1f} % "
             f"of bound, plain {k['plain_ms']:.1f} ms, {k['launches']} launches per generate")


# ---------------------------------------------------------------------------
# Phase 9: multi-rank
# ---------------------------------------------------------------------------

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
    """[9 multirank] The port's multi-rank path (``parallel``) on this
    card: two gloo ranks (the dry run, the flagship mesh-proven from its
    saved keys, config #1's sharded checks), then one NCCL rank (the
    flagship again). Every rank is a process of ``parallel.spawn``; a rank's
    failure or timeout raises here. ``flagship`` and ``config1`` are their
    ``hold_path`` results."""
    import shutil
    import tempfile

    import numpy as np

    from halo2_rsa_tpu_torch import entry
    from halo2_rsa_tpu_torch.circuit import checker
    from halo2_rsa_tpu_torch.parallel import launch, ranks
    from halo2_rsa_tpu_torch.utils import serialization as ser

    smi = report["device"]["smi"]
    single = report["paths"]["flagship"]
    out = {}

    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(2, "gloo")
    out["dryrun"] = dict(dry, seconds=time.perf_counter() - t0)
    if dry["skipped"]:
        raise AssertionError(f"dryrun_multichip(2, 'gloo') skipped {dry['skipped']}")
    line(f"[9 multirank] dryrun_multichip(2, 'gloo') on one card, every section run, "
         f"{out['dryrun']['seconds']:.1f} s: " + ", ".join(
             f"{k} {v:.2f} s" for k, v in dry["sections"].items()) + f" | {smi}")

    b = flagship["built"]
    srs, pk, vk, _ = flagship["keys"]
    keys_dir = os.path.join(HERE, ".keys")
    os.makedirs(keys_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=keys_dir)
    try:
        paths = {"srs": os.path.join(d, "srs.npz"), "pk": os.path.join(d, "pk.npz"),
                 "vk": os.path.join(d, "vk.json")}
        ser.save_srs(srs, paths["srs"])
        ser.save_pk(pk, paths["pk"])
        ser.save_vk(vk, paths["vk"])
        witness = checker.witness_limbs(b.builders[0])
        want_sha = single["proof_sha256"]
        runs = {}
        for label, world, backend in (("gloo x2", 2, "gloo"), ("nccl x1", 1, "nccl")):
            res = launch.spawn(ranks.prove_from_keys, world, backend, timeout=900,
                               args=(paths, witness, b.pubs, b.seed, 1))
            runs[label] = [{k: v for k, v in r.items() if k != "proof"} for r in res]
            for rank, r in enumerate(res):
                if r["sha256"] != want_sha or len(r["proof"]) != 2272:
                    raise AssertionError(f"{label} rank {rank}: proof sha256 {r['sha256']} "
                                         f"({len(r['proof'])} B), the single device's {want_sha}")
                if not (r["verified"] and r["wrong_pub_rejected"]):
                    raise AssertionError(f"{label} rank {rank}: verified {r['verified']}, "
                                         f"wrong public input rejected {r['wrong_pub_rejected']}")
                if any(r["fallbacks"].values()):
                    raise AssertionError(f"{label} rank {rank}: local fallbacks {r['fallbacks']}")
                zero = [k for k, v in r["launches"].items() if not v]
                if zero:
                    raise AssertionError(f"{label} rank {rank}: {zero} never launched in a warm prove")
                one_dev = single["warm"]["calls"]
                for key, tree, tails in (("K2", None, None), ("K3-scan", 0, False)):
                    got = _scan_work(r["shapes"][key], tree, tails)
                    one = _scan_work(one_dev[key], tree, tails)
                    if got * world != one:
                        raise AssertionError(f"{label} rank {rank}: {key} work {got} is not 1/"
                                             f"{world} of the single device's {one}")
                got = _scan_work(r["shapes"]["K3-scan"], 0, True)
                one = _scan_work(one_dev["K3-scan"], 0, True)
                if got != one or not one:
                    raise AssertionError(f"{label} rank {rank}: the blinding tails' row scans "
                                         f"{got}, not the single device's {one}")
                coll = " ".join(f"{k} {v['calls']} calls {v['bytes']} B ({v['staged_bytes']} B "
                                f"staged)" for k, v in r["collectives"].items())
                line(f"[9 multirank] {label} rank {rank}: launches per warm prove "
                     + ", ".join(f"{k}={v}" for k, v in r["launches"].items())
                     + f" | collectives per warm prove: {coll}")
        out["flagship"] = runs
    finally:
        shutil.rmtree(d, ignore_errors=True)
    g = runs["gloo x2"][0]["shapes"]
    one_dev = single["warm"]["calls"]
    line(f"[9 multirank] flagship k=15 mesh-proven by 2 gloo ranks on one card: sha256 "
         f"{want_sha} on both ranks = the single device's proof (random.Random({b.seed})), "
         f"2272 B, verified, wrong public input rejected; 1 NCCL rank (its collectives over one "
         f"rank are trivial): the same bytes | per rank K2 work {_scan_work(g['K2'])} = 1/2 of "
         f"{_scan_work(one_dev['K2'])} row-points, K3 chunk-total scans "
         f"{_scan_work(g['K3-scan'], 0, False)} = 1/2, the tails' row scans "
         f"{_scan_work(g['K3-scan'], 0, True)} in full, bucket-reduce scans "
         f"{_scan_work(g['K3-scan'], 1)} (single device {_scan_work(one_dev['K3-scan'], 1)}) | "
         f"{smi}")

    plan = [((2, 1), "sharded"), ((1, 2), "sharded"), ((2, 1), "wire")]
    c1 = config1["built"]
    w4 = np.stack([checker.witness_limbs(x) for x in c1.builders[:4]])
    res = launch.spawn(ranks.sharded_check_counts, 2, "gloo", timeout=900, args=(
        c1.compiled, w4, CHECK_BATCH, config1["bad"], plan))
    want = [sum(config1["bad_counts"][i]) for i in sorted(config1["bad"])]
    for rank, r in enumerate(res):
        for (shape, kind), v in r.items():
            if v["valid"].shape != (CHECK_BATCH,) or v["valid"].any():
                raise AssertionError(f"config #1 {kind} {shape} rank {rank}: violations "
                                     f"{v['valid'].nonzero()}")
            if v["bad"].tolist() != want:
                raise AssertionError(f"config #1 {kind} {shape} rank {rank}: corrupted counts "
                                     f"{v['bad'].tolist()}, phase 3's {want}")
    out["config1"] = dict(corrupted_counts=want, plan=[[list(s), k] for s, k in plan])
    line(f"[9 multirank] config #1 (batch {CHECK_BATCH}) on 2 gloo ranks, ShardedChecker (2, 1) "
         f"and (1, 2), WireShardedChecker (2, 1): every instance 0 violations, the six corrupted "
         f"instances' counts {want} equal phase 3's (gate + lookup) | {smi}")
    report["multirank"] = out


def main() -> int:
    sys.path.insert(0, HERE)
    report: dict = {}
    kernels = kernel_rows()
    t_all = time.perf_counter()
    phase_device(report)
    phase_build(report)
    held = collections.defaultdict(set)  # {kernel: shapes} held bitwise so far
    kept = {}  # phase 9's inputs and the entries whose keys later ones prove with
    for cfg in CONFIGS:
        res = hold_path(report, cfg, held, kept[cfg.keys_from] if cfg.keys_from else None)
        if cfg.keys or cfg.name == "config1":
            kept[cfg.name] = res
    flag = report["paths"]["flagship"]
    for key in KERNELS:
        kernels[key].update(launches=flag["launches"][key],
                            launches_per_warm_prove=flag["warm"]["launches"][key])
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
    phase_path_times(report, kernels)
    phase_multirank(report, kept["flagship"], kept["config1"])
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

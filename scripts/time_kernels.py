#!/usr/bin/env python3
"""Time K1 (the field layer's Montgomery products), K2 (the bucket scan's
mixed add), K3 (the complete add) or K4 (the Horner combine's doubling) of
``halo2_rsa_tpu_torch`` in another checkout at the shapes ``chip_smoke.py``
recorded, so that two commits can be compared inside one run on the same
card.

    python3 chip_smoke.py                                  # records the shapes
    python3 scripts/time_kernels.py --kernel k1|k2|k3|k4 [--root DIR]

``--root`` is the checkout to time (default: this one); its kernels build
inside it. The shapes are read from ``chiprun_out/chip_smoke.json`` (phase
4). ``k2`` runs ``chip_smoke.k2_times`` on that checkout's wrappers (a
checkout without ``point_scan_mixed`` runs its K2 as C single adds on inputs
sliced beforehand), then times ``msm_many`` at the flagship's four shapes (P
= 2, 5, 7 and 11 polys over 2^15 affine SRS points, ``z_one``; wall time
with a sync). Every prefix and MSM result is hashed, and each hash must
equal that of every earlier line of the same kernel and shape in
``chiprun_out/time_kernels.jsonl``: the checkouts compared agree bit for
bit. ``k3`` runs ``chip_smoke.k3_times`` at K3's recorded shapes and 2^16
points, ``chip_smoke.k3_scan_times`` at the recorded shapes of its row scans
(``msm._bucket_reduce`` for a scan with its halving tree; a checkout without
``point_scan`` runs its scans round by round) and ``chip_smoke.k3_splice_times``
at the bucket splice's (a checkout without ``bucket_splice`` runs the gathers,
adds and selects of its ``msm._bucket_sums``), then the same ``msm_many``
timings. ``k4`` runs
``chip_smoke.k4_times``. ``k1`` times the checkout's ``vecfield.inv`` at
K1-pow's recorded shapes (one element: the field inversion, one K1-pow
launch or one K1 launch per product) and its ``vecfield.prefix_mul`` at
K1-prefix's (``chip_smoke.k1_prefix_times``; a checkout without
``reverse`` takes a suffix product as batch_inv_nz did, flipped, scanned and
flipped back) and its ``vecfield.mont_mul`` at K1's (``chip_smoke.k1_times``:
the operands of each recorded broadcast pattern, which a checkout that
materialises them copies first). Whole proofs are timed by the benchmark
(``benchmark/run.py``), not here. One JSON line goes to stdout and is
appended to that file.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "chiprun_out")
OUT = os.path.join(OUT_DIR, "time_kernels.jsonl")
MSM_POLYS = (2, 5, 7, 11)  # the flagship's four msm_many calls per prove
MSM_LOG_N = 15
MSM_RUNS = 5


def k2_rows(smoke, recorded) -> tuple:
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    shapes = [(r["kind"], r["m"], r["c"]) for r in recorded["k2"]["shapes"]]
    # a checkout from before the scan runs C launches; this goes once no
    # checkout to compare lacks point_scan_mixed
    one_launch = hasattr(cuda_g1, "point_scan_mixed")
    if one_launch:
        def make(s, r):
            return lambda: cuda_g1.point_scan_mixed(fq, s, r)
    else:
        def make(s, r):
            cols = [tuple(t[:, j].contiguous() for t in r) for j in range(r[0].shape[1])]

            def call():
                acc, out = s, []
                for col in cols:
                    acc = cuda_g1.point_add_mixed(fq, acc, col)
                    out.append(acc)
                return out

            return call

    start, rows = smoke.k2_inputs(max(m for _, m, _ in shapes), max(c for _, _, c in shapes))
    return smoke.k2_times(make, shapes, start, rows), one_launch


def msm_rows(smoke) -> list:
    import numpy as np
    import torch

    from halo2_rsa_tpu_torch.prover import kzg, msm

    n = 1 << MSM_LOG_N
    points = kzg.setup(n, tau=777, device="cuda").g1_powers
    limbs = np.random.default_rng(23).integers(0, 1 << 32, size=(max(MSM_POLYS), n, 8),
                                               dtype=np.uint64)
    limbs[..., 7] >>= 4  # below 2^252 < r: standard-form Fr scalars
    scalars = torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to("cuda")
    out = []
    for p in MSM_POLYS:
        sc = scalars[:p]
        res = msm.msm_many(sc, points, z_one=True)
        runs = []
        for _ in range(MSM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            msm.msm_many(sc, points, z_one=True)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        out.append(dict(kind="msm", p=p, n=n, min_s=min(runs), mean_s=sum(runs) / len(runs),
                        runs_s=runs, digest=smoke._digest(res)))
    return out


def k3_rows(smoke, recorded) -> list:
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    shapes = [(r["kind"], r["n"]) for r in recorded["k3"]["shapes"]]
    return smoke.k3_times(lambda p, q: cuda_g1.point_add(fq, p, q), None, shapes,
                          smoke.k4_points())


def k3_scan_rows(smoke, recorded) -> list:
    import torch

    from halo2_rsa_tpu_torch.prover import g1_vec, msm

    shapes = [(r["kind"], r["rows"], r["len"], r["tree"]) for r in recorded["k3_scan"]["shapes"]]
    if hasattr(g1_vec, "point_scan"):
        scan = g1_vec.point_scan
    else:  # a checkout from before the scan kernel: one K3 launch per round
        def scan(s):
            return msm._hs_point_scan(s, s[0].shape[-2])

    def make(s, tree):
        if not tree:
            return lambda: scan(s)
        # _bucket_reduce scans buckets b >= 1 from the last: the row reversed
        # behind a bucket 0 it skips
        buckets = tuple(torch.cat([c[:, :1], c.flip(1)], dim=1) for c in s)
        return lambda: msm._bucket_reduce(buckets)

    rows = smoke.k3_scan_inputs(max(m for _, m, _, _ in shapes), max(n for _, _, n, _ in shapes))
    return smoke.k3_scan_times(make, shapes, rows)


def _splice_by_gathers(g1_vec, within, incl, ends):
    """The bucket splice as ``msm._bucket_sums`` made it before the splice
    kernel: two gathers of prefixes, their adds and selects, a negation and
    the difference, on the checkout's ``g1_vec``."""
    import torch

    w, b = ends.shape
    dev = ends.device
    c = within[0].shape[1] // incl[0].shape[1]
    excl = tuple(torch.cat([i1, t[:, :-1]], dim=1)
                 for t, i1 in zip(incl, g1_vec.identity((w, 1), device=dev)))
    prev = torch.cat([torch.full((w, 1), -1, dtype=ends.dtype, device=dev), ends[:, :-1]], dim=1)

    def gather_pts(idx):
        cl = idx.clamp(min=0)
        wpts = tuple(torch.gather(t, 1, cl[..., None].expand(-1, -1, 8)) for t in within)
        opts = tuple(torch.gather(t, 1, (cl // c)[..., None].expand(-1, -1, 8)) for t in excl)
        pts = g1_vec.point_add(wpts, opts)
        return g1_vec.point_select(idx >= 0, pts, g1_vec.identity((w, b), device=dev))

    return g1_vec.point_add(gather_pts(ends), g1_vec.point_neg(gather_pts(prev)))


def k3_splice_rows(smoke, recorded) -> list:
    from halo2_rsa_tpu_torch.prover import g1_vec

    shapes = [(r["kind"], r["rows"], r["buckets"], r["npad"], r["nchunks"])
              for r in recorded["k3_splice"]["shapes"]]
    if hasattr(g1_vec, "bucket_splice"):
        def make(w, i, e):
            return lambda: g1_vec.bucket_splice(w, i, e)
    else:  # a checkout from before the splice kernel
        def make(w, i, e):
            return lambda: _splice_by_gathers(g1_vec, w, i, e)
    return smoke.k3_splice_times(make, shapes, smoke.k3_splice_inputs(*shapes[0][1:]))


def k4_rows(smoke, recorded) -> list:
    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    fq = g1_vec.FQ
    shapes = [(r["kind"], r["n"], r["reps"]) for r in recorded["k4"]["shapes"]]
    return smoke.k4_times(lambda p, reps: cuda_g1.point_double(fq, p, reps),
                          lambda p, reps: cuda_g1.point_double_plain(fq, p, reps),
                          shapes, smoke.k4_points())


def k1_rows(smoke, recorded) -> list:
    from halo2_rsa_tpu_torch.fields import vecfield
    from halo2_rsa_tpu_torch.fields.field import BN254_FR

    fc = vecfield.consts(BN254_FR)
    shapes = [(r["kind"], r["n"]) for r in recorded["k1_pow"]["shapes"] if r["kind"] == "path"]
    rows = smoke.k1_pow_times(lambda x: vecfield.inv(fc, x), shapes)
    for r in rows:
        r["op"] = "inv"
    one_call = "reverse" in inspect.signature(vecfield.prefix_mul).parameters

    def prefix(x, rev):
        if not rev:
            return vecfield.prefix_mul(fc, x)
        if one_call:
            return vecfield.prefix_mul(fc, x, reverse=True)
        # a checkout from before K1-prefix: batch_inv_nz's suffix product
        return vecfield.prefix_mul(fc, x.flip(-2)).flip(-2)

    shapes = [(r["kind"], r["rows"], r["n"], r["reverse"]) for r in recorded["k1_prefix"]["shapes"]]
    scans = smoke.k1_prefix_times(prefix, shapes)
    for r in scans:
        r["op"] = "prefix"
    shapes = [(r["kind"], r["n"], r["nb"], r["mode"]) for r in recorded["k1"]["shapes"]
              if r["kind"] == "path"]
    muls = smoke.k1_times(lambda x, y: vecfield.mont_mul(fc, x, y), shapes)
    for r in muls:
        r["op"] = "mul"
    return rows + scans + muls


def _mismatches(kernel: str, rows: list) -> list:
    """Shapes whose hash differs from an earlier line's in the output file."""
    if not os.path.exists(OUT):
        return []
    seen = {}
    with open(OUT) as fh:
        for text in fh:
            rec = json.loads(text)
            if rec["kernel"] == kernel:
                for r in rec["shapes"]:
                    if "digest" in r:
                        seen.setdefault(_key(r), set()).add(r["digest"])
    return [_key(r) for r in rows
            if "digest" in r and seen.get(_key(r), {r["digest"]}) != {r["digest"]}]


def _key(r) -> str:
    return " ".join(f"{k}={r[k]}" for k in ("op", "kind", "m", "c", "p", "n", "nb", "mode", "rows",
                                            "len", "tree", "reverse", "buckets", "npad",
                                            "nchunks") if k in r)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k4"), required=True)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke  # this checkout's, imported before --root's package is on the path

    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    with open(os.path.join(OUT_DIR, "chip_smoke.json")) as fh:
        recorded = json.load(fh)
    one_launch = None  # K2: whether the checkout's scan is one launch
    if args.kernel == "k1":
        rows = k1_rows(chip_smoke, recorded)
    elif args.kernel == "k2":
        rows, one_launch = k2_rows(chip_smoke, recorded)
        rows += msm_rows(chip_smoke)
    elif args.kernel == "k3":
        rows = (k3_rows(chip_smoke, recorded) + k3_scan_rows(chip_smoke, recorded)
                + k3_splice_rows(chip_smoke, recorded) + msm_rows(chip_smoke))
    else:
        rows = k4_rows(chip_smoke, recorded)
    bad = _mismatches(args.kernel, rows)
    text = json.dumps(dict(
        kernel=args.kernel, root=os.path.relpath(root, HERE), card=torch.cuda.get_device_name(0),
        smi=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip(),
        one_launch=one_launch, shapes=rows))
    print(text, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(OUT, "a") as fh:
        fh.write(text + "\n")
    if bad:
        raise SystemExit(f"time_kernels: results differ from an earlier checkout's at {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

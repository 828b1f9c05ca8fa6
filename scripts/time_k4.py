#!/usr/bin/env python3
"""Time K4, the point doubling kernel of ``halo2_rsa_tpu_torch``, of another
checkout at the shapes ``chip_smoke.py`` timed it at, so that two commits can
be compared inside one run on the same card.

    python3 chip_smoke.py                       # records the shapes
    python3 scripts/time_k4.py [--root DIR]     # DIR: the checkout to time

The shapes are read from ``chiprun_out/chip_smoke.json`` (phase 6: the
flagship's Horner windows and 2^16 points with 1 and 8 doublings); the
measurement is ``chip_smoke.k4_times`` run on the wrappers of ``--root``'s
package (default: this checkout), whose kernels build inside it. One JSON
line goes to stdout and is appended to ``chiprun_out/time_k4.jsonl``.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "chiprun_out")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, HERE)
    import chip_smoke  # this checkout's, imported before --root's package is on the path

    sys.path.insert(0, root)
    import torch

    from halo2_rsa_tpu_torch.prover import cuda_g1, g1_vec

    if not torch.cuda.is_available():
        raise SystemExit("time_k4: no CUDA device")
    with open(os.path.join(OUT_DIR, "chip_smoke.json")) as fh:
        shapes = [(r["kind"], r["n"], r["reps"]) for r in json.load(fh)["k4"]["shapes"]]
    fq = g1_vec.FQ
    # a checkout from before K4 took `reps` doubles a window as `reps`
    # launches; this goes once no checkout to compare lacks `reps`
    has_reps = "reps" in inspect.signature(cuda_g1.point_double).parameters

    def window(kern):
        if has_reps:
            return lambda p, reps: kern(fq, p, reps)

        def step(p, reps):
            for _ in range(reps):
                p = kern(fq, p)
            return p

        return step

    rows = chip_smoke.k4_times(window(cuda_g1.point_double), window(cuda_g1.point_double_plain),
                               shapes, chip_smoke.k4_points())
    text = json.dumps(dict(
        root=os.path.relpath(root, HERE), card=torch.cuda.get_device_name(0),
        smi=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip(),
        one_launch_per_window=has_reps, shapes=rows))
    print(text, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "time_k4.jsonl"), "a") as fh:
        fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

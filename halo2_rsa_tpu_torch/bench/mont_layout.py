"""P2: K1's time on three memory layouts — the two layout kernels'
wrappers, their plain versions, their launch counters and the probe's
timed run.

Counterpart of ``scripts/bench_mont_layout.py`` (the Pallas kernel built by
``build_bm``, body ``_kernel_bm``, and the script's variants (a)-(d)). The
kernels (``csrc/mont_layout.cu``) compute K1's Montgomery product a·b·2⁻²⁵⁶
mod p on other layouts than K1's own:

- :func:`mont_mul_lm` (b′): limb-major ``(8, N)`` int32 tensors, limb j of
  element i at ``[j, i]``; every warp load is coalesced.
- :func:`mont_mul_staged` (d′): K1's element-major ``(N, 8)`` tensors,
  staged through shared memory by blocks of ``threads`` threads with
  16-byte loads (the script's in-kernel transpose).

On a CUDA tensor each launches its kernel; on a CPU tensor it runs its plain
version, which is :func:`..fields.cuda_mont.mont_mul_plain` after the
layout change. :func:`run` times (a) K1 through ``cuda_mont.mont_mul``, (b′),
(c) the plain version (the counterpart of the script's XLA limb graph) and
(d′) for each ``threads``, and raises unless every variant is bitwise equal
to (a) over all of its inputs.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..fields import cuda_mont, vecfield
from ..fields.cuda_mont import LIMBS, check_cuda_int32, check_kernel_args, check_launch, p_arg
from ..fields.field import BN254_FR
from ..utils.profiling import chain_ms

THREADS = (128, 256, 512)  # the staged kernel's block sizes (script: 2048/4096/8192 rows)
LAUNCHES = {"mont_mul_lm": 0, "mont_mul_staged": 0}
BYTES_PER_PRODUCT = 3 * 4 * LIMBS  # a and b read once, the product written once


def mont_mul_lm_plain(fc, at: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """(b′) in plain torch ops; same contract as :func:`mont_mul_lm`."""
    return cuda_mont.mont_mul_plain(fc, at.t(), bt.t()).t().contiguous()


def mont_mul_staged_plain(fc, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(d′) in plain torch ops; same contract as :func:`mont_mul_staged`."""
    return cuda_mont.mont_mul_plain(fc, a, b)


def mont_mul_lm(fc, at: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Montgomery product over two limb-major ``(8, N)`` int32 tensors.

    CUDA tensor: launches (b′) on the current stream (one thread per
    element). CPU tensor: :func:`mont_mul_lm_plain`."""
    if at.device.type == "cpu":
        return mont_mul_lm_plain(fc, at, bt)
    check_cuda_int32(at, bt)
    if at.dim() != 2 or at.shape[0] != LIMBS:
        raise ValueError(f"kernel argument of shape {tuple(at.shape)}, expected (8, N)")
    from ..utils.cuda_build import library

    out = torch.empty_like(at)
    stream = torch.cuda.current_stream(at.device).cuda_stream
    err = library().h2r_mont_mul_lm(
        at.data_ptr(), bt.data_ptr(), out.data_ptr(), at.shape[1], p_arg(fc), fc.n0inv32, stream
    )
    check_launch(err, "h2r_mont_mul_lm")
    LAUNCHES["mont_mul_lm"] += 1
    return out


def mont_mul_staged(fc, a: torch.Tensor, b: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """Montgomery product over two element-major ``(..., 8)`` int32 tensors
    of one shape, as K1 takes them.

    CUDA tensor: launches (d′) with blocks of ``threads`` (one of
    :data:`THREADS`) on the current stream. CPU tensor:
    :func:`mont_mul_staged_plain`."""
    if threads not in THREADS:
        raise ValueError(f"threads={threads}: the kernel is built for {THREADS}")
    if a.device.type == "cpu":
        return mont_mul_staged_plain(fc, a, b)
    check_kernel_args(a, b)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("kernel arguments must be 16-byte aligned")
    from ..utils.cuda_build import library

    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = library().h2r_mont_mul_staged(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // LIMBS, p_arg(fc), fc.n0inv32,
        threads, stream,
    )
    check_launch(err, "h2r_mont_mul_staged")
    LAUNCHES["mont_mul_staged"] += 1
    return out


def random_elements(fc, n: int, seed: int, device) -> torch.Tensor:
    """n canonical field elements as an (n, 8) int32 tensor: random 32-bit
    limbs from numpy's generator, the top limb below p's top limb (so every
    value is < p)."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, (n, LIMBS), dtype=np.uint64)
    limbs[:, -1] = rng.integers(0, fc.field.p >> (32 * (LIMBS - 1)), n, dtype=np.uint64)
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(device)


def run(log_n: int = 20, iters: int = 10, device="cuda") -> dict:
    """Time a chain of ``iters`` BN254 Fr products per variant (each output
    is the next call's a; b is fixed), as the script does; then check every
    variant against (a) over all 2^log_n products and raise on any
    difference. Returns ms, M el/s and GB/s (96 B per product) per variant,
    with the device it ran on."""
    fc = vecfield.consts(BN254_FR)
    n = 1 << log_n
    a = random_elements(fc, n, 0, device)
    b = random_elements(fc, n, 1, device)
    at, bt = a.t().contiguous(), b.t().contiguous()
    steps = {
        "a": (lambda x: cuda_mont.mont_mul(fc, x, b), a),
        "b'": (lambda x: mont_mul_lm(fc, x, bt), at),
        "c": (lambda x: cuda_mont.mont_mul_plain(fc, x, b), a),
    }
    for t in THREADS:
        steps[f"d'{t}"] = (lambda x, t=t: mont_mul_staged(fc, x, b, t), a)
    variants = {}
    for name, (step, x0) in steps.items():
        ms = chain_ms(step, x0, iters)
        variants[name] = dict(
            ms=ms, mel_s=n / ms / 1e3, gb_s=n * BYTES_PER_PRODUCT / ms / 1e6
        )
    want = cuda_mont.mont_mul(fc, a, b)
    outs = {"b'": mont_mul_lm(fc, at, bt).t(), "c": cuda_mont.mont_mul_plain(fc, a, b)}
    for t in THREADS:
        outs[f"d'{t}"] = mont_mul_staged(fc, a, b, t)
    for name, got in outs.items():
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=-1).sum())
            raise AssertionError(f"P2 variant {name} differs from K1 on {bad} of {n} products")
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return dict(device=kind, field=BN254_FR.name, log_n=log_n, iters=iters, variants=variants)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_n", type=int, nargs="?", default=20)
    ap.add_argument("iters", type=int, nargs="?", default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.log_n, args.iters, args.device)
    for name, r in res["variants"].items():
        print(f"{name:6s} (N=2^{args.log_n}): {r['ms']:8.3f} ms  {r['mel_s']:8.1f} M el/s  "
              f"{r['gb_s']:7.1f} GB/s", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

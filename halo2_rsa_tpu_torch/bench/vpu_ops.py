"""P1: the sustained integer rate of K1's op mix — the kernel's wrapper, its
plain PyTorch version, its launch counter and the probe's timed run.

Counterpart of ``scripts/bench_vpu_ops.py`` (the Pallas kernel built by
``_mk``, bodies ``body_mul`` .. ``body_split_ilp``). The kernel
(``csrc/int_ops.cu``) runs one of seven chains of uint32 operations, REPS
deep with 2^32 wraparound, once per lane of a ``(16, N)`` array:

==========  ========================================================  =====
body        one rep                                                   ops
==========  ========================================================  =====
mul         ``x = x * y``                                             1
mad         ``x = x * y + y``                                         2
split-acc   ``p = x * y; t += p & 0xFFFF; u += p >> 16; x += u``      6
add         ``x = x + y``                                             1
mul-ilp4    four independent ``* y`` chains, REPS // 4 deep           1
add-ilp4    four independent ``+ y`` chains, REPS // 4 deep           1
split-ilp2  two independent CIOS-step chains, REPS // 2 deep          6
==========  ========================================================  =====

"ops" is the script's own accounting per rep (``bench_vpu_ops.py:141-156``).

:func:`int_ops` takes two int32 tensors of one shape (the bit pattern is
the uint32 lane). On a CUDA tensor it launches the kernel; on a CPU tensor
it runs :func:`int_ops_plain`, which computes in int64 lanes and splits
every 32 x 32-bit product into 16-bit halves (the full product would
overflow int64).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..fields.cuda_mont import check_cuda_int32, check_launch
from ..utils.profiling import chain_ms

BODIES = {
    "mul": 1, "mad": 2, "split-acc": 6, "add": 1,
    "mul-ilp4": 1, "add-ilp4": 1, "split-ilp2": 6,
}
BODY_IDS = {name: i for i, name in enumerate(BODIES)}  # csrc/int_ops.cu's enum Body
REPS_BUILT = (8, 64)  # the REPS the kernel is instantiated for (tests, the script's default)
LAUNCHES = {"int_ops": 0}

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y mod 2^32 on int64 lanes holding uint32 values."""
    xl, xh = x & _M16, x >> 16
    yl, yh = y & _M16, y >> 16
    return (xl * yl + (((xh * yl + xl * yh) & _M16) << 16)) & _M32


def _add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x + y) & _M32


def _body_plain(name: str, x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    if name == "mul":
        for _ in range(reps):
            x = _mul(x, y)
        return x
    if name == "mad":
        for _ in range(reps):
            x = _add(_mul(x, y), y)
        return x
    if name == "split-acc":
        t = torch.zeros_like(x)
        u = torch.zeros_like(x)
        for _ in range(reps):
            p = _mul(x, y)
            t = _add(t, p & _M16)
            u = _add(u, p >> 16)
            x = _add(x, u)
        return _add(t, x)
    if name == "add":
        for _ in range(reps):
            x = _add(x, y)
        return x
    if name in ("mul-ilp4", "add-ilp4"):
        step = _mul if name == "mul-ilp4" else _add
        a, b, c, d = x, _add(x, y), _add(_add(x, y), y), _mul(x, y)
        for _ in range(reps // 4):
            a, b, c, d = step(a, y), step(b, y), step(c, y), step(d, y)
        return _add(_add(_add(a, b), c), d)
    # split-ilp2 (the caller has checked the name)
    t0 = torch.zeros_like(x)
    u0 = torch.zeros_like(x)
    t1, u1 = _add(x, y), _mul(x, y)
    for _ in range(reps // 2):
        p0 = _mul(x, y)
        t0 = _add(t0, p0 & _M16)
        u0 = _add(u0, p0 >> 16)
        p1 = _mul(_add(x, u0), y)
        t1 = _add(t1, p1 & _M16)
        u1 = _add(u1, p1 >> 16)
    return _add(_add(t0, t1), u1)


def int_ops_plain(body: str, x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    """The body's chain in plain torch ops; same contract as :func:`int_ops`."""
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; expected one of {list(BODIES)}")
    u = _body_plain(body, x.to(torch.int64) & _M32, y.to(torch.int64) & _M32, reps)
    return u.to(torch.int32)


def int_ops(body: str, x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    """``body`` REPS deep on every lane of two int32 tensors of one shape.

    CUDA tensor: launches P1 on the current stream (one thread per lane;
    ``reps`` must be one of :data:`REPS_BUILT`). CPU tensor:
    :func:`int_ops_plain`."""
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; expected one of {list(BODIES)}")
    if x.device.type == "cpu":
        return int_ops_plain(body, x, y, reps)
    if reps not in REPS_BUILT:
        raise ValueError(f"reps={reps}: the kernel is built for {REPS_BUILT}")
    check_cuda_int32(x, y)
    from ..utils.cuda_build import library

    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().h2r_int_ops(
        BODY_IDS[body], reps, x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), stream
    )
    check_launch(err, "h2r_int_ops")
    LAUNCHES["int_ops"] += 1
    return out


def inputs(log_n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's operands: x in [0, 2^16), y in [1, 2^16), (16, 2^log_n),
    from numpy's generator seeded 0."""
    rng = np.random.default_rng(0)
    shape = (16, 1 << log_n)
    x = rng.integers(0, 1 << 16, shape, dtype=np.uint32).view(np.int32)
    y = rng.integers(1, 1 << 16, shape, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def run(log_n: int = 20, reps: int = 64, iters: int = 8, device="cuda") -> dict:
    """Time a chain of ``iters`` calls of each body (each call's output is
    the next one's x), as the script does. Returns, per body, ms per call,
    T ops/s by the script's accounting and T body-steps/s, with the device
    it ran on."""
    x, y = inputs(log_n, device)
    lanes = x.numel()
    out = {}
    for name, ops_per_rep in BODIES.items():
        ms = chain_ms(lambda z, name=name: int_ops(name, z, y, reps), x, iters)
        s = ms / 1e3
        out[name] = dict(
            ms=ms, tops=lanes * reps * ops_per_rep / s / 1e12, tsteps=lanes * reps / s / 1e12
        )
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return dict(device=kind, log_n=log_n, reps=reps, iters=iters, bodies=out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_n", type=int, nargs="?", default=20)
    ap.add_argument("reps", type=int, nargs="?", default=64)
    ap.add_argument("iters", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.log_n, args.reps, args.iters, args.device)
    for name, r in res["bodies"].items():
        print(f"{name:10s}: {r['ms']:8.3f} ms  {r['tops']:6.2f} T ops/s "
              f"({r['tsteps']:5.2f} T {name}-steps/s)", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

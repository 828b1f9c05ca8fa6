"""The shape of every hand-written kernel call, read by pass-through wrappers
around the program's kernel wrappers (a copy of ``chip_smoke._calls_of``'s
shape table; K1-pow keeps its exponent whole, since its work depends on the
exponent's bits). The shapes feed ``harness.work``."""

from __future__ import annotations

import collections

# (module, function) -> (kernel, shape of the call)
_SHAPES = {
    ("cuda_mont", "mont_mul"): ("K1", lambda fc, a, b, bcast=None: (
        _points(a), _points(b), (None, "cycle", "repeat").index(bcast))),
    ("cuda_mont", "mont_pow"): ("K1-pow", lambda fc, a, e: (_points(a), int(e))),
    ("cuda_mont", "mont_prefix"): ("K1-prefix", lambda fc, vals, reverse=False: (
        _rows(vals), vals.shape[-2], int(reverse))),
    ("cuda_g1", "point_scan_mixed"): ("K2", lambda fc, p1, pts: (
        _points(p1[0]), pts[0].shape[-2])),
    ("cuda_g1", "point_add_mixed"): ("K2", lambda fc, p1, p2: (_points(p1[0]), 1)),
    ("cuda_g1", "point_add"): ("K3", lambda fc, p1, p2: (_points(p1[0]),)),
    ("cuda_g1", "point_scan"): ("K3-scan", lambda fc, ps: (_rows(ps[0]), ps[0].shape[-2], 0)),
    ("cuda_g1", "point_scan_sum"): ("K3-scan", lambda fc, ps: (
        _rows(ps[0]), ps[0].shape[-2], 1)),
    ("cuda_g1", "bucket_splice"): ("K3-splice", lambda fc, within, incl, ends: (
        ends.shape[0], ends.shape[1], within[0].shape[1], incl[0].shape[1])),
    ("cuda_g1", "point_double"): ("K4", lambda fc, p, reps=1: (_points(p[0]), reps)),
}

FAMILY = {"K1": "k1", "K1-pow": "k1", "K1-prefix": "k1", "K2": "g1", "K3": "g1",
          "K3-scan": "g1", "K3-splice": "g1", "K4": "g1"}


def _points(t) -> int:
    return t.numel() // t.shape[-1]


def _is_cuda(x) -> bool:
    return (x[0] if isinstance(x, tuple) else x).is_cuda


def _rows(t) -> int:
    return _points(t) // t.shape[-2]


class Recorder:
    """Counts calls by (kernel, shape) while ``active``; installed for the
    life of the process, so that code that looks the wrappers up by module
    attribute finds the recording ones."""

    def __init__(self):
        from halo2_rsa_tpu_torch.fields import cuda_mont
        from halo2_rsa_tpu_torch.prover import cuda_g1

        self.modules = {"cuda_mont": cuda_mont, "cuda_g1": cuda_g1}
        self.calls = collections.Counter()
        self.active = False
        for (mod, fn), (kernel, shape) in _SHAPES.items():
            setattr(self.modules[mod], fn, self._wrap(getattr(self.modules[mod], fn), kernel,
                                                       shape))

    def _wrap(self, real, kernel, shape):
        def wrapped(*args, **kw):
            if self.active and _is_cuda(args[1]):
                self.calls[(kernel, shape(*args, **kw))] += 1
            return real(*args, **kw)

        return wrapped

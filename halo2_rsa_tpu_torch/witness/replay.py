"""Batched witness generation: one synthesis compiled into a vectorized
replay program (BASELINE.json config #1 — "witness gen for thousands of
mul_mod instances vectorized").

Counterpart of ``halo2_rsa_tpu/witness/replay.py``. The reference (and
halo2 generally) re-runs gadget synthesis per instance — cell-at-a-time
host code. Here synthesis happens once; every cell records *provenance*
(``Builder.prov``), and this module compiles the provenance DAG into:

* a handful of host-evaluated big-integer macro-ops per instance (the q/r
  witnessing divmods of mul_mod — microseconds of Python each), and
* a levelized, fully vectorized device program for all scalar cells: each
  level executes one gather + batched field op over every instance at once.

Field values are carried in *standard* (non-Montgomery) limb form, the
port's ``(..., 8)`` int32 layout of 32-bit limbs, so that shift/mask
provenance is plain bit arithmetic; products re-enter Montgomery form
transiently (two ``vecfield.mont_mul``: K1 on a CUDA tensor, its plain
version on a CPU tensor). A group's constant rows, ``(G, 8)`` against the
gathered ``(B, G, 8)`` operands, reach K1 as broadcast rows read in place.

Inverse-witness cells (is_zero hints) are dataflow leaves, so they are all
batched into a single Fermat inversion at the end (one K1-pow launch on the
card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..circuit.builder import Builder
from ..fields import vecfield
from ..fields.cuda_mont import LIMBS, to_int32, u64
from ..utils.profiling import span

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class _Group:
    kind: str
    dst: np.ndarray  # (G,) int32 cell indices
    srcs: list  # list of (G,) int32 arrays
    consts: list  # list of (G, 8) int32 arrays (op-specific)
    meta: list  # op-specific int arrays


class WitnessProgram:
    def __init__(self, builder: Builder):
        self.field = builder.field
        self.fc = vecfield.consts(builder.field)
        self.num_cells = builder.num_witness
        self.prov = list(builder.prov)
        self.bigops = list(builder.bigops)
        self.input_idx = [i for i, p in enumerate(self.prov) if p and p[0] == "in"]
        opaque = [i for i, p in enumerate(self.prov) if p is None]
        if opaque:
            raise ValueError(
                f"{len(opaque)} cells lack provenance (first: {opaque[:5]}); "
                "this circuit cannot be replayed"
            )
        self._big_cells = [
            i for i, p in enumerate(self.prov) if p[0] in ("bigq", "bigr", "bigsub")
        ]
        self._programs: dict = {}  # torch.device -> the device program's tensors
        self._compile()

    # ------------------------------------------------------------------
    # compilation: levelize + group
    # ------------------------------------------------------------------

    _DEPS = {
        "in": (),
        "const": (),
        "bigq": (),
        "bigr": (),
        "bigsub": (),
        "lin": (1, 2),
        "linc": (1, 2, 3, 4),
        "full": (1, 2),
        "mul2": (1, 2, 3, 4),
        "mul3": (1, 2, 3),
        "sel": (1, 2, 3),
        "inv0": (1,),
        "eqz": (1,),
        "shrmask": (1,),
    }

    def _compile(self):
        prov = self.prov
        n = self.num_cells
        level = np.zeros(n, np.int64)
        for i, p in enumerate(prov):
            kind = p[0]
            if kind == "inv0":
                level[i] = -1  # deferred to the final batch inversion
                continue
            deps = [p[d] for d in self._DEPS[kind]]
            if deps:
                level[i] = 1 + max(level[d] for d in deps)
        max_level = int(level.max())

        # constants (static witness entries, same for every instance)
        const_idx = []
        const_vals = []
        for i, p in enumerate(prov):
            if p[0] == "const":
                const_idx.append(i)
                const_vals.append(p[1])
        self.const_idx = np.asarray(const_idx, np.int32)
        self.const_limbs = vecfield.from_ints_np(self.fc, const_vals, mont=False)

        # group non-leaf ops by (level, kind); inv0 in one terminal group
        buckets: dict[tuple, list] = {}
        for i, p in enumerate(prov):
            kind = p[0]
            if kind in ("in", "const", "bigq", "bigr", "bigsub"):
                continue
            key = (int(level[i]) if kind != "inv0" else max_level + 1, kind)
            buckets.setdefault(key, []).append(i)

        groups = []
        for (lv, kind), cells in sorted(buckets.items()):
            dst = np.asarray(cells, np.int32)
            ps = [prov[i] for i in cells]
            if kind == "lin":
                srcs = [np.asarray([p[1] for p in ps], np.int32),
                        np.asarray([p[2] for p in ps], np.int32)]
                k0 = vecfield.from_ints_np(self.fc, [p[3] for p in ps], mont=False)
                k1 = vecfield.from_ints_np(self.fc, [p[4] % self.field.p for p in ps], mont=True)
                k2 = vecfield.from_ints_np(self.fc, [p[5] % self.field.p for p in ps], mont=True)
                groups.append(_Group(kind, dst, srcs, [k0, k1, k2], []))
            elif kind == "linc":
                srcs = [np.asarray([p[j] for p in ps], np.int32) for j in (1, 2, 3, 4)]
                ks = [vecfield.from_ints_np(self.fc, [p[5] for p in ps], mont=False)]
                for j in (6, 7, 8, 9):
                    ks.append(
                        vecfield.from_ints_np(
                            self.fc, [p[j] % self.field.p for p in ps], mont=True
                        )
                    )
                groups.append(_Group(kind, dst, srcs, ks, []))
            elif kind == "mul2":
                srcs = [np.asarray([p[j] for p in ps], np.int32) for j in (1, 2, 3, 4)]
                groups.append(_Group(kind, dst, srcs, [], []))
            elif kind == "full":
                srcs = [np.asarray([p[1] for p in ps], np.int32),
                        np.asarray([p[2] for p in ps], np.int32)]
                k0 = vecfield.from_ints_np(self.fc, [p[3] for p in ps], mont=False)
                k1 = vecfield.from_ints_np(self.fc, [p[4] % self.field.p for p in ps], mont=True)
                k2 = vecfield.from_ints_np(self.fc, [p[5] % self.field.p for p in ps], mont=True)
                # k3 stored as k3*R^2 so (a.b)R^{-1} * k3R^2 * R^{-1} = k3 a b
                k3r2 = [
                    (p[6] * self.fc.field.r2) % self.field.p for p in ps
                ]
                k3 = vecfield.from_ints_np(self.fc, k3r2, mont=False)
                groups.append(_Group(kind, dst, srcs, [k0, k1, k2, k3], []))
            elif kind == "mul3":
                srcs = [np.asarray([p[j] for p in ps], np.int32) for j in (1, 2, 3)]
                groups.append(_Group(kind, dst, srcs, [], []))
            elif kind == "sel":
                srcs = [np.asarray([p[j] for p in ps], np.int32) for j in (1, 2, 3)]
                groups.append(_Group(kind, dst, srcs, [], []))
            elif kind == "eqz":
                srcs = [np.asarray([p[1] for p in ps], np.int32)]
                groups.append(_Group(kind, dst, srcs, [], []))
            elif kind == "inv0":
                srcs = [np.asarray([p[1] for p in ps], np.int32)]
                groups.append(_Group(kind, dst, srcs, [], []))
            elif kind == "shrmask":
                srcs = [np.asarray([p[1] for p in ps], np.int32)]
                shift = np.asarray([p[2] for p in ps], np.int32)
                mask = np.asarray([p[3] for p in ps], np.int32)  # 0 = none
                groups.append(_Group(kind, dst, srcs, [], [shift, mask]))
            else:  # pragma: no cover
                raise AssertionError(kind)
        self.groups = groups

    # ------------------------------------------------------------------
    # host: big-op evaluation per instance
    # ------------------------------------------------------------------

    def _host_cell_val(self, i, memo, inputs, bigvals):
        stack = [i]
        prov = self.prov
        p_mod = self.field.p
        while stack:
            j = stack[-1]
            if j in memo:
                stack.pop()
                continue
            p = prov[j]
            kind = p[0]
            if kind == "in":
                memo[j] = inputs[j]
                stack.pop()
                continue
            if kind == "const":
                memo[j] = p[1]
                stack.pop()
                continue
            if kind in ("bigq", "bigr", "bigsub"):
                memo[j] = bigvals[j]
                stack.pop()
                continue
            deps = [p[d] for d in self._DEPS[kind]]
            missing = [d for d in deps if d not in memo]
            if missing:
                stack.extend(missing)
                continue
            vals = [memo[d] for d in deps]
            if kind == "lin":
                memo[j] = (p[3] + p[4] * vals[0] + p[5] * vals[1]) % p_mod
            elif kind == "linc":
                memo[j] = (
                    p[5] + p[6] * vals[0] + p[7] * vals[1] + p[8] * vals[2]
                    + p[9] * vals[3]
                ) % p_mod
            elif kind == "mul2":
                memo[j] = (vals[0] * vals[1] + vals[2] * vals[3]) % p_mod
            elif kind == "full":
                memo[j] = (
                    p[3] + p[4] * vals[0] + p[5] * vals[1] + p[6] * vals[0] * vals[1]
                ) % p_mod
            elif kind == "mul3":
                memo[j] = (vals[0] * vals[1] + vals[2]) % p_mod
            elif kind == "sel":
                memo[j] = vals[1] if vals[0] == 1 else vals[2]
            elif kind == "inv0":
                memo[j] = pow(vals[0], -1, p_mod) if vals[0] else 0
            elif kind == "eqz":
                memo[j] = 1 if vals[0] == 0 else 0
            elif kind == "shrmask":
                v = vals[0] >> p[2]
                if p[3]:
                    v &= (1 << p[3]) - 1
                memo[j] = v
            else:  # pragma: no cover
                raise AssertionError(kind)
            stack.pop()
        return memo[i]

    def _host_bigops(self, inputs: dict) -> dict:
        """Evaluate all big macro-ops for one instance.

        Returns {cell_idx: value} for every big-output cell."""
        memo: dict[int, int] = {}
        bigvals: dict[int, int] = {}
        results: list[tuple] = [None] * len(self.bigops)

        # big-output cells grouped by op
        out_cells: dict[int, list] = {}
        for i in self._big_cells:
            p = self.prov[i]
            out_cells.setdefault(p[1], []).append((i, p))

        def compose(cells, w):
            x = 0
            for c in reversed(cells):
                x = (x << w) | self._host_cell_val(c, memo, inputs, bigvals)
            return x

        for op_id, op in enumerate(self.bigops):
            if op[0] == "divmod":
                _, a_cells, b_cells, n_cells, w = op
                a = compose(a_cells, w)
                b = compose(b_cells, w) if b_cells is not None else 1
                nv = compose(n_cells, w)
                q, r = divmod(a * b, nv)
                results[op_id] = ("divmod", q, r, w)
            elif op[0] == "sub":
                _, a_cells, b_cells, w = op
                a = compose(a_cells, w)
                b = compose(b_cells, w)
                assert a >= b
                results[op_id] = ("sub", a - b, None, w)
            else:  # pragma: no cover
                raise AssertionError(op)
            # fill this op's output cells so later ops can consume them
            for i, p in out_cells.get(op_id, []):
                kind, _, j = p
                _, q, r, w = results[op_id]
                if kind == "bigq":
                    v = (q >> (w * j)) & ((1 << w) - 1)
                elif kind == "bigr":
                    v = (r >> (w * j)) & ((1 << w) - 1)
                else:  # bigsub
                    v = (q >> (w * j)) & ((1 << w) - 1)
                bigvals[i] = v
        return bigvals

    # ------------------------------------------------------------------
    # device replay
    # ------------------------------------------------------------------

    def _device_program(self, device) -> dict:
        """The program's index arrays and constant rows as tensors on
        ``device`` (int64 indices, (G, 8) int32 rows), built once per
        device. A shrmask group carries, per cell, the source limbs of each
        output limb and the one above it (LIMBS: a zero limb past the top),
        the bit shift within a limb, and a (G, 8) mask of the bits kept."""
        prog = self._programs.get(device)
        if prog is not None:
            return prog

        def idx(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        def limbs(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        j = np.arange(LIMBS)[None, :]
        groups = []
        for g in self.groups:
            meta = []
            if g.kind == "shrmask":
                shift, mask = (m.astype(np.int64) for m in g.meta)
                src = j + (shift // 32)[:, None]
                qm, rm = (mask // 32)[:, None], (mask % 32)[:, None]
                keep = np.where(j < qm, _M32, np.where(j == qm, (1 << rm) - 1, 0))
                keep = np.where(mask[:, None] == 0, _M32, keep)
                meta = [idx(np.minimum(src, LIMBS)), idx(np.minimum(src + 1, LIMBS)),
                        idx((shift % 32)[:, None]), idx(keep)]
            groups.append((g.kind, idx(g.dst), [idx(s) for s in g.srcs],
                           [limbs(c) for c in g.consts], meta))
        prog = dict(
            const_idx=idx(self.const_idx),
            const_limbs=limbs(self.const_limbs.reshape(-1, LIMBS)),
            input_idx=idx(self.input_idx),
            big_idx=idx(self._big_cells),
            groups=groups,
        )
        self._programs[device] = prog
        return prog

    def run(self, inputs: torch.Tensor, bigvals: torch.Tensor) -> torch.Tensor:
        """The device program (the JAX module's ``_run_jit``), eagerly on the
        device of ``inputs``: (B, n_in, 8) input limbs and (B, n_big, 8)
        big-op limbs, standard form -> the (B, num_cells, 8) standard-form
        witness limbs on that device. A span ``replay.run`` holds one span
        ``replay.<kind>`` a group."""
        groups = len(self._device_program(inputs.device)["groups"])
        with span("replay.run", groups=groups, batch=inputs.shape[0]):
            return self._run(inputs, bigvals)

    def _run(self, inputs: torch.Tensor, bigvals: torch.Tensor) -> torch.Tensor:
        fc = self.fc
        dev = inputs.device
        prog = self._device_program(dev)
        r2 = fc.tensor("r2_limbs", dev)
        one = fc.tensor("one_std", dev)

        def mulmod_std(a, b):
            # standard-form product: ((a*b)R^-1) * R^2 * R^-1
            return vecfield.mont_mul(fc, vecfield.mont_mul(fc, a, b), r2)

        batch = inputs.shape[0]
        w = torch.zeros((batch, self.num_cells, LIMBS), dtype=torch.int32, device=dev)
        w[:, prog["const_idx"]] = prog["const_limbs"]
        w[:, prog["input_idx"]] = inputs
        if bigvals.shape[1]:
            w[:, prog["big_idx"]] = bigvals
        for kind, dst, srcs, consts, meta in prog["groups"]:
            with span("replay." + kind):
                ws = [w.index_select(1, s) for s in srcs]  # (B, G, 8) each
                if kind == "lin":
                    a, b = ws
                    k0, k1, k2 = consts
                    v = vecfield.add(
                        fc,
                        k0,
                        vecfield.add(
                            fc,
                            vecfield.mont_mul(fc, k1, a),
                            vecfield.mont_mul(fc, k2, b),
                        ),
                    )
                elif kind == "full":
                    a, b = ws
                    k0, k1, k2, k3 = consts
                    ab = vecfield.mont_mul(fc, a, b)  # abR^-1
                    v = vecfield.add(
                        fc,
                        k0,
                        vecfield.add(
                            fc,
                            vecfield.add(
                                fc,
                                vecfield.mont_mul(fc, k1, a),
                                vecfield.mont_mul(fc, k2, b),
                            ),
                            vecfield.mont_mul(fc, ab, k3),
                        ),
                    )
                elif kind == "linc":
                    v = consts[0]
                    for km, a in zip(consts[1:], ws):
                        v = vecfield.add(fc, v, vecfield.mont_mul(fc, km, a))
                elif kind == "mul2":
                    v = vecfield.add(fc, mulmod_std(ws[0], ws[1]), mulmod_std(ws[2], ws[3]))
                elif kind == "mul3":
                    v = vecfield.add(fc, mulmod_std(ws[0], ws[1]), ws[2])
                elif kind == "sel":
                    cond = ~vecfield.is_zero(ws[0])
                    v = torch.where(cond[..., None], ws[1], ws[2])
                elif kind == "eqz":
                    z = vecfield.is_zero(ws[0])
                    v = torch.where(z[..., None], one, 0)
                elif kind == "inv0":
                    # 0 -> 0: K1-pow's 0^(p-2) is 0
                    inv_m = vecfield.inv(fc, vecfield.to_mont(fc, ws[0]))
                    v = vecfield.from_mont(fc, inv_m)
                elif kind == "shrmask":
                    # limb j of a >> shift is (a_{j+ls} >> bs) | (a_{j+ls+1} << (32 - bs))
                    # (32-bit limbs widened to int64; at bs = 0 the upper limb's
                    # bits land above bit 31 and the mask drops them)
                    take0, take1, bs, keep = meta
                    a = torch.nn.functional.pad(u64(ws[0]), (0, 1))  # (B, G, 9), limb 8 zero
                    v0 = torch.gather(a, 2, take0.expand(batch, -1, -1))
                    v1 = torch.gather(a, 2, take1.expand(batch, -1, -1))
                    v = to_int32(((v0 >> bs) | (v1 << (32 - bs))) & keep)
                else:  # pragma: no cover
                    raise AssertionError(kind)
                w.index_copy_(1, dst, v)
        return w

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def host_inputs(self, instances: list[dict]) -> tuple[np.ndarray, np.ndarray]:
        """The host half of :meth:`generate`: each instance's input limbs and
        its big macro-ops evaluated in Python, as (B, n_in, 8) and
        (B, n_big, 8) int32 standard-form limb arrays (span
        ``replay.host_inputs``)."""
        b = len(instances)
        inputs = np.zeros((b, len(self.input_idx), LIMBS), np.int32)
        bigvals = np.zeros((b, len(self._big_cells), LIMBS), np.int32)
        with span("replay.host_inputs", instances=b):
            for bi, inst in enumerate(instances):
                assert set(inst.keys()) == set(self.input_idx), "input cells mismatch"
                inputs[bi] = _int_limbs([inst[c] for c in self.input_idx])
                bv = self._host_bigops(inst)
                bigvals[bi] = _int_limbs([bv[c] for c in self._big_cells])
        return inputs, bigvals

    def generate(self, instances: list[dict], device="cuda") -> np.ndarray:
        """Generate witnesses for a batch on ``device``.

        ``instances``: per instance a dict {input_cell_idx: int value}.
        Returns (B, num_cells, 8) int32 standard-form witness limbs, the
        layout of ``checker.witness_limbs`` (``vecfield.limbs_to_ref`` gives
        the JAX package's (B, num_cells, 16) uint32). The span
        ``replay.generate`` holds ``replay.host_inputs``, ``replay.copy_in``,
        ``replay.run`` and ``replay.copy_out``."""
        b = len(instances)
        with span("replay.generate", instances=b):
            inputs, bigvals = self.host_inputs(instances)
            with span("replay.copy_in", bytes=inputs.nbytes + bigvals.nbytes):
                inputs = torch.from_numpy(inputs).to(device)
                bigvals = torch.from_numpy(bigvals).to(device)
            w = self.run(inputs, bigvals)
            with span("replay.copy_out", bytes=w.numel() * w.element_size()):
                return w.cpu().numpy()


def _int_limbs(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> (len, 8) int32 limbs (little-endian
    32-bit limbs; the int32 bit pattern is the uint32 limb)."""
    buf = b"".join(int(x).to_bytes(4 * LIMBS, "little") for x in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, LIMBS).view(np.int32).copy()

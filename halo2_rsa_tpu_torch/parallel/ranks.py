"""Rank bodies of the multi-rank runs.

Each body is ``fn(rank, world, device, *args)`` for :func:`.launch.spawn`:
importable by name (so a rank imports the port and nothing else — no JAX,
no test module), SPMD (every rank calls the same collectives in the same
order), and it returns host values (numpy arrays, bytes, dicts). Inputs
arrive as numpy arrays. The CPU tests, ``entry.dryrun_multichip``, the card
gate ``chip_smoke.py`` (its multi-rank phase) and ``parallel.scaling`` run
these same bodies.
"""

from __future__ import annotations

import collections
import hashlib
import os
import random
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import entry, golden
from ..bigint import BigIntChip
from ..circuit import Builder, checker
from ..fields import BN254_FR, cuda_mont, vecfield
from ..prover import cuda_g1, curve, g1_vec, kzg, plonk
from ..prover import msm as msm_mod
from ..prover import ntt as ntt_mod
from ..utils import serialization as ser
from . import comm
from .comm import make_mesh
from .mesh_prove import MeshKernels
from .sharded_checker import ShardedChecker, WireShardedChecker
from .sharded_msm import make_sharded_msm
from .sharded_ntt import (
    _four_step_block, column_block, gather_natural, held_to_columns, intt_sharded, ntt_sharded,
)


def _t(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _points_np(p) -> np.ndarray:
    return np.stack([_np(c) for c in p])


def _counts() -> dict:
    return {kind: dict(c) for kind, c in comm.COLLECTIVES.items()}


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def collective_inputs(seed: int, tag: int, d: int, pos: int) -> dict:
    """The inputs of the ``pos``-th rank of a group of ``d`` in
    :func:`collectives` (``tag`` tells the groups apart): a (3, 8) int32
    tensor to gather, (d, 2, 8) to exchange, rows (pos + j) % 3 for the
    j-th rank to exchange unevenly, and (5,) int64 to sum."""
    rng = np.random.default_rng([seed, tag, d, pos])

    def limbs(*shape):
        return rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)

    send = [(pos + j) % 3 for j in range(d)]
    return dict(gather=limbs(3, 8), a2a=limbs(d, 2, 8), a2av=limbs(sum(send), 8), send=send,
                reduce=rng.integers(-(1 << 40), 1 << 40, (5,), dtype=np.int64))


def collectives(rank: int, world: int, device: str, seed: int) -> dict:
    """Every collective of :mod:`.comm` over the axis of a 1-D mesh and
    both axes of a (2, world/2) mesh, on :func:`collective_inputs`."""
    out = {}
    meshes = [("1d", make_mesh((world,), ("rows",), device=device))]
    if world % 2 == 0:
        meshes.append(("2d", make_mesh((2, world // 2), ("data", "rows"), device=device)))
    for tag, (name, mesh) in enumerate(meshes):
        for axis in mesh.axis_names:
            d, pos = mesh.shape[axis], mesh.coords[axis]
            x = collective_inputs(seed, tag, d, pos)
            recv = [(s + pos) % 3 for s in range(d)]
            out[name, axis] = dict(
                gather=_np(comm.all_gather(mesh, axis, _t(x["gather"], device))),
                a2a=_np(comm.all_to_all(mesh, axis, _t(x["a2a"], device))),
                a2av=_np(comm.all_to_all_v(mesh, axis, _t(x["a2av"], device), x["send"], recv)),
                reduce=_np(comm.all_reduce_sum(mesh, axis, _t(x["reduce"], device))),
            )
    out["counts"] = _counts()
    return out


def stall(rank: int, world: int, device: str, bad: int, how: str) -> None:
    """Rank ``bad`` raises (``how="raise"``) or never returns
    (``how="hang"``) while the others wait for it in a barrier: the run
    :func:`.launch.spawn` must end with an error within its deadline."""
    if rank == bad:
        if how == "raise":
            raise RuntimeError(f"rank {bad} stops here")
        threading.Event().wait()
    dist.barrier()


# ---------------------------------------------------------------------------
# sharded NTT, MSM, checkers and prove
# ---------------------------------------------------------------------------


def ntt_cases(rank: int, world: int, device: str, cases: list) -> dict:
    """cases: (name, log_n, x (N, 8) or (P, N, 8) Montgomery limbs, mesh
    shape, axis names, axis) -> {name: (ntt_sharded(x), intt_sharded(x),
    intt_sharded(ntt_sharded(x)), x back from the forward four-step's
    blocks through ``held_to_columns`` and the inverse four-step)}: round
    3's path between its two transforms."""
    meshes, out = {}, {}
    for name, log_n, x, shape, names, axis in cases:
        if (shape, names) not in meshes:
            meshes[shape, names] = make_mesh(shape, names, device=device)
        mesh = meshes[shape, names]
        xt = _t(x, device)
        fwd = ntt_sharded(xt, log_n, mesh, axis)
        xb = xt if xt.dim() == 3 else xt[None]
        held = _four_step_block(column_block(xb, log_n, mesh, axis), log_n, False, mesh, axis)
        cols = held_to_columns(held.reshape(xb.shape[0], -1, xb.shape[-1]), log_n, mesh, axis)
        back = gather_natural(_four_step_block(cols, log_n, True, mesh, axis), log_n, mesh, axis)
        out[name] = (_np(fwd), _np(intt_sharded(xt, log_n, mesh, axis)),
                     _np(intt_sharded(fwd, log_n, mesh, axis)), _np(back.reshape(xt.shape)))
    return out


def msm_cases(rank: int, world: int, device: str, cases: list) -> dict:
    """cases: (name, kind, scalars, points (3, N, 8), z_one, seg): kind
    "sharded" runs ``make_sharded_msm`` on (N, 8) standard-form scalars and
    returns its (3, 8) coordinates; kind "many" runs
    ``MeshKernels.msm_many`` on (P, N, 8) scalars, with ``msm._SEG`` set to
    ``seg`` when given, and returns (3, P, 8) and the fallbacks taken.
    Over a 1-D mesh of every rank."""
    mesh = make_mesh((world,), ("rows",), device=device)
    out = {}
    for name, kind, scalars, points, z_one, seg in cases:
        sc = _t(scalars, device)
        pts = tuple(_t(c, device) for c in points)
        if kind == "sharded":
            out[name] = _points_np(make_sharded_msm(mesh)(sc, pts))
            continue
        kern = MeshKernels(mesh)
        saved = msm_mod._SEG
        msm_mod._SEG = seg or saved
        try:
            res = kern.msm_many(sc, pts, z_one)
        finally:
            msm_mod._SEG = saved
        out[name] = (_points_np(res), dict(kern.fallbacks))
    return out


def checker_cases(rank: int, world: int, device: str, compiled, shapes: list,
                  batches: list) -> dict:
    """ShardedChecker and WireShardedChecker counts of each (B, W, 8)
    witness batch on each (data, rows) mesh shape: {(shape, kind): [counts
    per batch]}."""
    out = {}
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "rows"), device=device)
        sc = ShardedChecker(compiled, mesh)
        wc = WireShardedChecker(compiled, mesh)
        out[tuple(shape), "sharded"] = [sc.check(sc.shard_witness(w)) for w in batches]
        out[tuple(shape), "wire"] = [wc.check(wc.route(w)) for w in batches]
    return out


def prove_golden(rank: int, world: int, device: str, names: list) -> dict:
    """Each golden case (``golden.CASES``) set up, keyed and proven with
    ``MeshKernels`` over a 1-D mesh of every rank, with the case's tau and
    rng seed: {name: dict(proof, verified, wrong_pub_rejected, fallbacks,
    collectives)}."""
    mesh = make_mesh((world,), ("rows",), device=device)
    out = {}
    for name in names:
        meta = golden.CASES[name]
        b, pubs = golden.build_circuit(name)
        srs = kzg.setup(meta["srs_n"], tau=meta["tau"], device=device)
        pk, vk = plonk.keygen(checker.compile_circuit(b), srs, k=meta["k"])
        kern = MeshKernels(mesh)
        comm.reset_counts()
        proof = plonk.prove(pk, b.values, pubs, rng=random.Random(meta["seed"]), kern=kern)
        counts = _counts()
        out[name] = dict(
            proof=proof, collectives=counts, fallbacks=dict(kern.fallbacks),
            verified=plonk.verify(vk, proof, pubs, device=device),
            wrong_pub_rejected=not plonk.verify(vk, proof, [pubs[0] + 1], device=device),
        )
    return out


# ---------------------------------------------------------------------------
# the multi-rank dry run (entry.dryrun_multichip)
# ---------------------------------------------------------------------------


def _pow_mod_128(seed: int):
    """``__graft_entry__.py``'s section-1 circuit: x^65537 mod n, 128 bits."""
    bits = 128
    r = random.Random(seed)
    n_v = 0
    while n_v.bit_length() != bits:
        n_v = r.getrandbits(bits)
    x_v = r.getrandbits(bits) % n_v
    b = Builder(BN254_FR)
    chip = BigIntChip(b, 64, bits)
    x = chip.assign_integer(x_v)
    n = chip.assign_integer(n_v)
    chip.assert_in_field(x, n)
    powed = chip.pow_mod_fixed_exp(x, 65537, n)
    chip.assert_equal_fresh(powed, chip.assign_integer(pow(x_v, 65537, n_v)))
    return b


def _mul_mod_256():
    """Section 5's circuit: a 256-bit ``mul_mod`` from random.Random(99), its
    first result limb public."""
    bits = 256
    r = random.Random(99)
    n_v = 0
    while n_v.bit_length() != bits:
        n_v = r.getrandbits(bits)
    a_v, c_v = r.getrandbits(bits) % n_v, r.getrandbits(bits) % n_v
    b = Builder(BN254_FR)
    chip = BigIntChip(b, 64, bits)
    res = chip.mul_mod(chip.assign_integer(a_v), chip.assign_integer(c_v),
                       chip.assign_integer(n_v))
    chip.assert_equal_fresh(res, chip.assign_integer(a_v * c_v % n_v))
    b.expose_public(res.limbs[0])
    return b


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dryrun(rank: int, world: int, device: str, budget_s: float) -> dict:
    """``entry.dryrun_multichip``'s sections on this rank (the same circuits
    and seeds as ``__graft_entry__.py``); returns {"sections": {name:
    seconds}, "skipped": [names]}."""
    t0 = time.time()
    report = {"sections": {}, "skipped": []}

    def mark(stage: str) -> None:
        if rank == 0:
            print(f"[dryrun {time.time() - t0:7.1f}s] {stage}", file=sys.stderr, flush=True)

    def over_budget(stage: str, est_s: float) -> bool:
        """True (on every rank alike) when the stage's cold-cost estimate
        does not fit in the remaining budget; prints the notice."""
        want = torch.tensor([int(time.time() - t0 + est_s > budget_s)], device=device)
        if not int(comm.all_reduce_sum(mesh_all, "rows", want)):
            return False
        mark(f"SKIPPING '{stage}': est. {est_s:.0f}s cold cost exceeds the remaining "
             f"{budget_s - (time.time() - t0):.0f}s of {budget_s:.0f}s")
        report["skipped"].append(stage)
        return True

    class section:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            mark(self.name)
            _sync(device)
            self.t = time.time()

        def __exit__(self, *exc):
            _sync(device)
            report["sections"][self.name] = time.time() - self.t

    mark("start")
    mesh_all = make_mesh((world,), ("rows",), device=device)
    d = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh((d, world // d), ("data", "rows"), device=device)
    fr = vecfield.consts(BN254_FR)
    rng = random.Random(0)

    with section("s1 sharded-checker"):
        builders = [_pow_mod_128(s) for s in range(2 * d)]
        compiled = checker.compile_circuit(builders[0])
        w = np.stack([checker.witness_limbs(b) for b in builders])
        sc = ShardedChecker(compiled, mesh)
        viol = sc.check(sc.shard_witness(w))
        assert viol.shape == (2 * d,) and not viol.any(), f"sharded check found violations: {viol}"

    with section("s2 wire-checker"):
        wc = WireShardedChecker(compiled, mesh)
        assert (wc.check(wc.route(w)) == viol).all(), "wire-sharded checker disagrees"

    with section("s3 ntt four-step"):
        log_n = max(6, 2 * max(0, (world - 1).bit_length()))
        x = vecfield.from_ints(fr, [rng.randrange(BN254_FR.p) for _ in range(1 << log_n)],
                               device=device)
        got = ntt_sharded(x, log_n, mesh_all)
        assert torch.equal(got, ntt_mod.ntt(x, log_n)), "sharded NTT mismatch"
        assert torch.equal(intt_sharded(got, log_n, mesh_all), x), "sharded iNTT round trip"

    with section("s4a msm small sharded"):
        scalars = [rng.randrange(curve.R) for _ in range(2 * world)]
        points = [curve.g1_mul(curve.G1_GEN, i + 1) for i in range(2 * world)]
        res = make_sharded_msm(mesh_all)(vecfield.from_ints(fr, scalars, mont=False, device=device),
                                         g1_vec.points_to_device(points, device=device))
        got = g1_vec.points_from_device(tuple(c[None] for c in res))[0]
        assert got == msm_mod.msm_host(scalars, points), "sharded MSM mismatch"

    if not over_budget("s4b msm seam parity", 90):
        with section("s4b msm seam parity"):
            # msm._SEG scaled to 2^10: the mesh MSM's segment rules at 1/8 the
            # work; the oracle sums the tiled scalars per base point
            n_big, n_base = 1 << 11, 64
            saved = msm_mod._SEG
            msm_mod._SEG = 1 << 10
            try:
                base = [curve.g1_mul(curve.G1_GEN, i + 1) for i in range(n_base)]
                pts_big = tuple(c.repeat(n_big // n_base, 1)
                                for c in g1_vec.points_to_device(base, device=device))
                sc16 = np.random.default_rng(0).integers(0, 1 << 16, (2, n_big, 16),
                                                         dtype=np.uint32)
                sc_np = vecfield.limbs_from_ref(sc16)
                got = g1_vec.points_from_device(
                    MeshKernels(mesh_all).msm_many(_t(sc_np, device), pts_big))
                for p in range(2):
                    ints = vecfield.to_ints(fr, sc_np[p], mont=False)
                    comb = [sum(ints[j::n_base]) % curve.R for j in range(n_base)]
                    assert got[p] == msm_mod.msm_host(comb, base), f"seam msm poly {p} mismatch"
            finally:
                msm_mod._SEG = saved

    if over_budget("s5 mesh-prove (two whole-prover runs)", 300):
        report["skipped"].append("s2b flagship wire check")
        mark("done (s5/s2b skipped)")
        return report
    with section("s5 mesh-prove"):
        b9 = _mul_mod_256()
        compiled9 = checker.compile_circuit(b9)
        k9 = max(plonk.min_k(compiled9), 9)
        keys_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".keys", "torch")
        # rank 0 generates the keys (or loads them), then every other rank loads them
        for turn in (0, 1):
            if (rank == 0) == (turn == 0):
                _, pk9, vk9, loaded = ser.load_or_keygen(compiled9, k9, keys_dir, tau=777,
                                                     device=device)
            # a barrier: NCCL returns before the sum exists; the host waits for it
            int(comm.all_reduce_sum(mesh_all, "rows", torch.zeros(1, device=device)))
        mark(f"s5 mesh-prove: k={k9}, keys loaded_from_disk={loaded}")
        pub9 = [b9.values[b9.instance[0]]]
        proof_local = plonk.prove(pk9, b9.values, pub9, rng=random.Random(5))
        proof_mesh = plonk.prove(pk9, b9.values, pub9, rng=random.Random(5),
                                 kern=MeshKernels(mesh_all))
        assert proof_mesh == proof_local, "mesh prove bytes differ"
        assert plonk.verify(vk9, proof_mesh, pub9, device=device), "mesh proof does not verify"

    if not over_budget("s2b flagship wire check", 120):
        with section("s2b flagship wire check"):
            compiled_f, w_f = entry.build_flagship(msg_len=8)
            wc_f = WireShardedChecker(compiled_f, mesh)
            viol_f = wc_f.check(wc_f.route(np.broadcast_to(w_f, (2 * d,) + w_f.shape)))
            assert not viol_f.any(), "flagship wire-sharded check failed"
    mark("done")
    return report


# ---------------------------------------------------------------------------
# The flagship proven from saved keys, and config #1 on the sharded checkers
# (chip_smoke.py's multi-rank phase; prove_from_keys also parallel.scaling)
# ---------------------------------------------------------------------------


def launch_counts() -> dict:
    """K1-K4's launch counters of this rank, by kernels-line row."""
    return {
        "K1": cuda_mont.LAUNCHES["mont_mul"],
        "K1-pow": cuda_mont.LAUNCHES["mont_pow"],
        "K1-prefix": cuda_mont.LAUNCHES["mont_prefix"],
        "K2": cuda_g1.LAUNCHES["g1_add_mixed"],
        "K3": cuda_g1.LAUNCHES["g1_add"],
        "K3-scan": cuda_g1.LAUNCHES["g1_scan"],
        "K3-splice": cuda_g1.LAUNCHES["g1_splice"],
        "K4": cuda_g1.LAUNCHES["g1_double"],
    }


def _scan_shapes(run) -> dict:
    """The shapes of every K2 call (rows, C; rows read through a
    permutation, ``cuda_g1.IndexedRows``, have C as ``order.shape[-2]``) and
    K3-scan call (rows, L, 1 with the halving tree else 0) over ``run()``, as
    [[shape..., calls]]."""
    calls = {"K2": collections.Counter(), "K3-scan": collections.Counter()}
    real = {name: getattr(cuda_g1, name) for name in ("point_scan_mixed", "point_scan",
                                                      "point_scan_sum")}

    def rows(t):
        return t.numel() // t.shape[-1] // t.shape[-2]

    def scan_mixed(fc, p1, pts):
        calls["K2"][p1[0].numel() // p1[0].shape[-1], pts[0].shape[-2]] += 1
        return real["point_scan_mixed"](fc, p1, pts)

    def scan(fc, ps):
        calls["K3-scan"][rows(ps[0]), ps[0].shape[-2], 0] += 1
        return real["point_scan"](fc, ps)

    def scan_sum(fc, ps):
        calls["K3-scan"][rows(ps[0]), ps[0].shape[-2], 1] += 1
        return real["point_scan_sum"](fc, ps)

    cuda_g1.point_scan_mixed, cuda_g1.point_scan, cuda_g1.point_scan_sum = (
        scan_mixed, scan, scan_sum)
    try:
        run()
    finally:
        for name, fn in real.items():
            setattr(cuda_g1, name, fn)
    return {key: [[*shape, n] for shape, n in sorted(c.items())] for key, c in calls.items()}


def prove_from_keys(rank: int, world: int, device: str, paths: dict, witness, pubs: list,
                    seed: int, warm: int) -> dict:
    """The keys saved at ``paths`` (srs, pk, vk) loaded on this rank's
    device, then one cold and ``warm`` warm proves with ``MeshKernels`` over
    a 1-D mesh of every rank, each from ``random.Random(seed)`` (all must
    give the same bytes), the launch counts and collectives of the last warm
    prove, the K2 / K3-scan shapes of one more, and verify (and a wrong
    public input rejected)."""
    t0 = time.perf_counter()
    srs = ser.load_srs(paths["srs"], device)
    pk = ser.load_pk(paths["pk"], srs)
    vk = ser.load_vk(paths["vk"])
    _sync(device)
    out = dict(load_s=time.perf_counter() - t0)
    kern = MeshKernels(make_mesh((world,), ("rows",), device=device))

    def prove():
        return plonk.prove(pk, witness, pubs, rng=random.Random(seed), kern=kern)

    def timed():
        _sync(device)
        t = time.perf_counter()
        proof = prove()
        _sync(device)
        return proof, time.perf_counter() - t

    proof, out["cold_s"] = timed()
    out["warm_s"] = []
    for _ in range(warm):
        before = launch_counts()
        comm.reset_counts()
        again, dt = timed()
        if again != proof:
            raise AssertionError(f"rank {rank}: a warm proof differs from the cold one")
        out["warm_s"].append(dt)
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    out["collectives"] = _counts()
    out["shapes"] = _scan_shapes(prove)
    out["fallbacks"] = dict(kern.fallbacks)
    bad = list(pubs)
    bad[0] += 1
    out.update(proof=proof, sha256=hashlib.sha256(proof).hexdigest(),
               verified=plonk.verify(vk, proof, pubs, device=device),
               wrong_pub_rejected=not plonk.verify(vk, proof, bad, device=device))
    return out


def sharded_check_counts(rank: int, world: int, device: str, compiled, w_base, batch: int,
                         bad: dict, plan: list) -> dict:
    """A batch of ``batch`` witnesses (``w_base`` tiled) and a copy with the
    instances of ``bad`` ({instance: (W, 8) witness}) replaced, checked by
    each (mesh shape, "sharded" | "wire") of ``plan``: {(shape, kind):
    dict(valid=the batch's violation counts, bad=the bad instances')}."""
    w = np.tile(w_base, (batch // len(w_base), 1, 1))
    wbad = w.copy()
    for inst, vals in bad.items():
        wbad[inst] = vals
    out = {}
    for shape, kind in plan:
        mesh = make_mesh(shape, ("data", "rows"), device=device)
        chk = (ShardedChecker if kind == "sharded" else WireShardedChecker)(compiled, mesh)
        prep = chk.shard_witness if kind == "sharded" else chk.route
        out[tuple(shape), kind] = dict(valid=chk.check(prep(w)),
                                       bad=chk.check(prep(wbad))[sorted(bad)])
    return out

#!/usr/bin/env python3
"""Time the port's RSA PKCS#1 v1.5 verification prove on one CUDA card.

The PyTorch port's counterpart of ``scripts/time_flagship_prove.py``, with
the same arguments, message rng and k rule. Without ``--sha`` the circuit
verifies a signature on a pre-hashed 32-byte message (halo2-rsa's enabled
bench, ``benches/bench.rs:369-377``: 1024-bit key, k=15). With ``--sha
MSG_LEN`` it also computes the SHA-256 of a MSG_LEN-byte message in the
circuit, as halo2-rsa's other bench configs (``benches/bench.rs:349-367``):
RSA-1024 with 64 B or 128 B (k=17), RSA-2048 with 128 B (k=18). Public
inputs are n's limbs followed by the digest's limbs (SHA disabled) or bytes.

Phases: build and compile the circuit; ``Pkcs1v15Circuit.check()`` on the
card (it must pass); keys through ``utils.serialization.load_or_keygen``
(generated and saved on the first run, loaded after; set-up and keygen are
timed apart when generated); one cold and three warm proves
(``utils.profiling.Phases``); verify, and a wrong public input rejected.
The signature comes from ``pipelines.sign_fixture`` with ``random.Random(7)``.

Usage: python3 scripts/time_torch_flagship.py [bits] [--sha MSG_LEN]
       [--keys DIR] [--json out.json]
(keys default to ``.keys/torch`` in the checkout). One JSON line on stdout
names the card and its power limit; progress goes to stderr. Needs a CUDA
card: without one it exits non-zero.
"""

import hashlib
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM_PROVES = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    opts = {"--json": None, "--sha": None, "--keys": os.path.join(HERE, ".keys", "torch")}
    rest = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            rest.append(a)
    bits = int(rest[0]) if rest else 1024
    sha = int(opts["--sha"]) if opts["--sha"] is not None else None
    return bits, sha, opts["--keys"], opts["--json"]


def build(bits: int, sha_len):
    """The configuration's circuit, compiled, and its k (the JAX script's
    rule); the message from ``random.Random(7)``."""
    from halo2_rsa_tpu_torch.pipelines import Pkcs1v15Circuit, sign_fixture

    rng = random.Random(7)
    msg = bytes(rng.randrange(256) for _ in range(sha_len if sha_len else 32))
    n, sig = sign_fixture(bits, msg, rng=random.Random(7))
    if sha_len is not None:
        circ = Pkcs1v15Circuit.build(bits, n, sig, msg=msg)
    else:
        digest = hashlib.sha256(msg).digest()
        circ = Pkcs1v15Circuit.build(bits, n, sig, hashed_msg=int.from_bytes(digest, "big"))
    compiled = circ.compile()
    k = max(compiled.num_gates + len(compiled.instance_idx),
            compiled.num_witness // 5 + 1).bit_length()
    return circ, compiled, k


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def timed_calls(mod, name: str, times: dict):
    """Wrap ``mod.name`` so that each call's seconds (synchronised on the
    card) land in ``times[name]``; returns a function that unwraps it."""
    import torch

    real = getattr(mod, name)

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, real)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        log("time_torch_flagship: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    from halo2_rsa_tpu_torch.prover import kzg, plonk
    from halo2_rsa_tpu_torch.utils import serialization
    from halo2_rsa_tpu_torch.utils.profiling import Phases

    bits, sha_len, keys_dir, json_out = parse(sys.argv[1:])
    res = {}
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    circ, compiled, k = build(bits, sha_len)
    res["build_compile_s"] = time.perf_counter() - t0
    res.update(k=k, gates=int(compiled.num_gates), witness_cells=int(compiled.num_witness),
               lookups=int(compiled.num_lookups))
    log(f"build+compile {res['build_compile_s']:.2f} s: {res['gates']} gates, "
        f"{res['witness_cells']} witness cells, {res['lookups']} lookups, k={k}")

    t0 = time.perf_counter()
    check = circ.check()
    torch.cuda.synchronize()
    res["check_s"] = time.perf_counter() - t0
    if not check["ok"]:
        raise AssertionError(f"the circuit's constraint check failed: {check}")
    log(f"check on the card {res['check_s']:.3f} s: {check}")

    times = {}
    undo = [timed_calls(kzg, "setup", times), timed_calls(plonk, "keygen", times)]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srs, pk, vk, loaded = serialization.load_or_keygen(compiled, k, keys_dir, tau=777)
        torch.cuda.synchronize()
        res["keys_s"] = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    fp = serialization.circuit_fingerprint(compiled)
    res.update(keys_loaded=loaded, srs_setup_s=times.get("setup"), keygen_s=times.get("keygen"),
               peak_mem_keys_bytes=torch.cuda.max_memory_allocated(), key_file_bytes={
                   name: os.path.getsize(os.path.join(keys_dir, name))
                   for name in (f"srs_k{k}_t777.npz", f"{fp}_k{k}_pk.npz")})
    log(f"keys {'loaded' if loaded else 'generated and saved'} in {res['keys_s']:.2f} s "
        f"(set-up {res['srs_setup_s']}, keygen {res['keygen_s']})")

    pub = circ.public_inputs

    def prove():
        ph = Phases()
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = plonk.prove(pk, circ.builder.values, pub, phases=ph)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t, ph.report()["phases_s"]

    torch.cuda.reset_peak_memory_stats()
    proof, res["prove_cold_s"], res["phases_cold"] = prove()
    log(f"cold prove {res['prove_cold_s']:.3f} s, {len(proof)} B")
    warm = [prove() for _ in range(WARM_PROVES)]
    res["prove_warm_s"] = [w[1] for w in warm]
    res["phases_warm"] = [w[2] for w in warm]
    res["peak_mem_prove_bytes"] = torch.cuda.max_memory_allocated()
    log(f"warm proves {['%.3f' % w for w in res['prove_warm_s']]} s")

    t0 = time.perf_counter()
    ok = plonk.verify(vk, proof, pub)
    res["verify_s"] = time.perf_counter() - t0
    bad = list(pub)
    bad[0] += 1
    res["wrong_input_rejected"] = not plonk.verify(vk, proof, bad)
    res["proof_bytes"] = len(proof)
    if not ok:
        raise AssertionError("the proof does not verify")
    if not res["wrong_input_rejected"]:
        raise AssertionError("verify accepted a wrong public input")
    log(f"verify {res['verify_s']:.3f} s ok, wrong public input rejected")

    config = (f"pkcs1v15_rsa{bits}_sha{sha_len}B_k{k}" if sha_len is not None
              else f"pkcs1v15_rsa{bits}_sha_disabled_k{k}")
    result = dict(config=config, device=torch.cuda.get_device_name(0), smi=smi(), **res)
    print(json.dumps(result), flush=True)
    if json_out:
        with open(json_out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

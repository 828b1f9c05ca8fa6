"""Full PKCS#1 v1.5 + SHA-256 verification circuit, 2048-bit key.

Counterpart of ``examples/rsa_example.py`` (parity with halo2-rsa's
``examples/rsa_example.rs``): an RSA-2048 key and a signature of a
128-byte message, both from ``random.Random(0)`` (``pipelines.sign_fixture``
is plain Python), the hash-then-verify circuit synthesized with its public
inputs (32 modulus limbs ++ 32 digest bytes), and the constraint check.
With ``--prove`` it also runs SRS set-up, keygen, prove and verify. With
``--max-len N`` SHA-256 runs in its dynamic-length mode: one circuit, hence
one key, for every message of at most N bytes (zk-email's header check uses
N = 1024); the message's length stays private.

Usage: python3 -m halo2_rsa_tpu_torch.examples.rsa_example [--prove] [--max-len N]
"""

import random
import sys
import time

import torch

from ..pipelines import Pkcs1v15Circuit, sign_fixture


def main(argv=None, device="cuda") -> None:
    argv = sys.argv[1:] if argv is None else argv
    max_len = int(argv[argv.index("--max-len") + 1]) if "--max-len" in argv else None
    torch.empty(0, device=device)  # a device that cannot run raises before the work
    bits = 2048
    rng = random.Random(0)
    msg = bytes(rng.randrange(256) for _ in range(128))
    print(f"generating RSA-{bits} keypair + signature...")
    n, sig = sign_fixture(bits, msg, rng=rng)

    t0 = time.perf_counter()
    circ = Pkcs1v15Circuit.build(bits, n, sig, msg=msg, max_len=max_len)
    print(f"synthesized in {time.perf_counter() - t0:.1f}s: {circ.builder.stats()}")

    t0 = time.perf_counter()
    report = circ.check(device=device)
    print(f"constraint check in {time.perf_counter() - t0:.1f}s: {report}")
    assert report["ok"], "verification circuit must be satisfied"

    if "--prove" in argv:
        from ..prover import kzg, plonk

        # with --max-len the key is made from the witness-free circuit: the
        # same trace as every message of at most max_len bytes
        compiled = (circ if max_len is None else
                    Pkcs1v15Circuit.without_witness(bits, max_len=max_len)).compile()
        k = max(compiled.num_gates, compiled.num_witness // 5 + 1).bit_length()
        print(f"k={k}: SRS setup + keygen...")
        t0 = time.perf_counter()
        srs = kzg.setup((1 << k) + plonk.BLIND, tau=None, device=device)
        pk, vk = plonk.keygen(compiled, srs, k=k)
        print(f"  {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        proof = plonk.prove(pk, circ.builder.values, circ.public_inputs)
        print(f"proved in {time.perf_counter() - t0:.1f}s ({len(proof)} bytes)")
        t0 = time.perf_counter()
        assert plonk.verify(vk, proof, circ.public_inputs, device=device)
        print(f"verified in {time.perf_counter() - t0:.1f}s")
    print("OK")


if __name__ == "__main__":
    main()

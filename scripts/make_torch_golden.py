#!/usr/bin/env python
"""Write the golden proofs that the PyTorch port is held against.

Runs the JAX package once on the CPU and writes, for each case of
``halo2_rsa_tpu_torch.golden.CASES``, ``tests/data/torch_golden_<name>.bin``
(the proof bytes) and ``.json`` (k, SRS size, tau, rng seed, public inputs
and the verifying-key commitments).

Usage: JAX_PLATFORMS=cpu python scripts/make_torch_golden.py [name ...]
(a few minutes per case on a CPU: the JAX prover compiles every graph).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import hashlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import time  # noqa: E402


def make(name: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from halo2_rsa_tpu.bigint import BigIntChip
    from halo2_rsa_tpu.circuit import Builder, MainGate, RangeChip, checker
    from halo2_rsa_tpu.fields import BN254_FR
    from halo2_rsa_tpu.prover import kzg, plonk
    from halo2_rsa_tpu_torch import golden

    case = golden.CASES[name]
    t0 = time.perf_counter()
    b, pubs = golden.build_circuit(
        name,
        dict(Builder=Builder, MainGate=MainGate, RangeChip=RangeChip, BigIntChip=BigIntChip,
             field=BN254_FR),
    )
    compiled = checker.compile_circuit(b)
    srs = kzg.setup(case["srs_n"], tau=case["tau"])
    pk, vk = plonk.keygen(compiled, srs, k=case["k"])
    proof = plonk.prove(pk, b.values, pubs, rng=random.Random(case["seed"]))
    assert plonk.verify(vk, proof, pubs)
    assert not plonk.verify(vk, proof, [pubs[0] + 1] + pubs[1:])
    meta = dict(
        name=name,
        **case,
        public_inputs=[str(p) for p in pubs],
        proof_len=len(proof),
        proof_sha256=hashlib.sha256(proof).hexdigest(),
        vk=dict(
            fixed_commitments=golden.points_to_json(vk.fixed_commitments),
            sigma_commitments=golden.points_to_json(vk.sigma_commitments),
            table_commitments=golden.points_to_json(vk.table_commitments),
            pub_rows=[int(r) for r in vk.pub_rows],
            lookup_bits=[int(x) for x in vk.lookup_bits],
        ),
    )
    os.makedirs(golden.DATA_DIR, exist_ok=True)
    base = os.path.join(golden.DATA_DIR, f"torch_golden_{name}")
    with open(base + ".bin", "wb") as f:
        f.write(proof)
    with open(base + ".json", "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(f"{name}: {len(proof)} B proof, {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    from halo2_rsa_tpu_torch import golden as _g

    for case_name in sys.argv[1:] or list(_g.CASES):
        make(case_name)

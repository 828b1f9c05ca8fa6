#!/usr/bin/env python3
"""Time where a key save goes on one CUDA card: the array conversion against
the npz write, with and without zlib.

Builds one configuration as ``scripts/time_torch_flagship.py`` does (same
arguments, message rng and k rule), generates its SRS and keys on the card,
then, for the SRS and the pk: the seconds of ``serialization._srs_arrays`` /
``_pk_arrays`` (limbs into the reference layout, card to host), of writing
those arrays with ``np.savez_compressed`` and with ``np.savez``, each
file's size, and the seconds of ``load_srs`` + ``load_pk`` from each pair of
files (their extended-coset rebuild included). The arrays read back from the
two writers must be equal. Files go under ``.keys/`` in the checkout and are
removed.

Usage: python3 scripts/time_key_save.py [bits] [--sha MSG_LEN]
One JSON line on stdout names the card and its power limit; progress goes to
stderr. Needs a CUDA card: without one it exits non-zero.
"""

import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))

from time_torch_flagship import build, log, parse, smi  # noqa: E402

WRITERS = ("savez_compressed", "savez")


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("time_key_save: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    from halo2_rsa_tpu_torch.prover import kzg, plonk
    from halo2_rsa_tpu_torch.utils import serialization as ser

    bits, sha_len, _, _ = parse(sys.argv[1:])
    _, compiled, k = build(bits, sha_len)
    srs = kzg.setup((1 << k) + plonk.BLIND, tau=777)
    pk, _ = plonk.keygen(compiled, srs, k=k)
    torch.cuda.synchronize()
    res = dict(bits=bits, sha=sha_len, k=k, arrays_s={}, write_s={}, file_bytes={}, load_s={})

    arrays = {}
    for name, fn, key in (("srs", ser._srs_arrays, srs), ("pk", ser._pk_arrays, pk)):
        t0 = time.perf_counter()
        arrays[name] = fn(key)
        res["arrays_s"][name] = time.perf_counter() - t0
    keys_dir = os.path.join(HERE, ".keys")
    os.makedirs(keys_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="time_key_save_", dir=keys_dir)
    try:
        for writer in WRITERS:
            for name in ("srs", "pk"):
                path = os.path.join(d, f"{writer}_{name}.npz")
                t0 = time.perf_counter()
                getattr(np, writer)(path, **arrays[name])
                res["write_s"][f"{writer}/{name}"] = time.perf_counter() - t0
                res["file_bytes"][f"{writer}/{name}"] = os.path.getsize(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srs2 = ser.load_srs(os.path.join(d, f"{writer}_srs.npz"))
            ser.load_pk(os.path.join(d, f"{writer}_pk.npz"), srs2)
            torch.cuda.synchronize()
            res["load_s"][writer] = time.perf_counter() - t0
            log(f"{writer}: write srs {res['write_s'][writer + '/srs']:.3f} s, pk "
                f"{res['write_s'][writer + '/pk']:.3f} s; load {res['load_s'][writer]:.3f} s")
        for name in ("srs", "pk"):
            a, b = (np.load(os.path.join(d, f"{w}_{name}.npz")) for w in WRITERS)
            if a.files != b.files or any(not np.array_equal(a[f], b[f]) for f in a.files):
                raise AssertionError(f"the {name} arrays read back differ between the writers")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["array_bytes"] = {name: sum(np.asarray(v).nbytes for v in arrs.values())
                          for name, arrs in arrays.items()}
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), smi=smi(), **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

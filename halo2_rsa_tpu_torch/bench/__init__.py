"""Probes of the card, each with its kernel's wrapper and plain version.

- :mod:`.vpu_ops` (P1): sustained integer rate of K1's op mix.
- :mod:`.mont_layout` (P2): K1's time on three memory layouts.

Run either as a module (``python -m halo2_rsa_tpu_torch.bench.vpu_ops``);
both take ``--device cpu`` to run their plain versions on the host.
"""

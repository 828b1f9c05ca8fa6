"""Runnable examples of the port (``python3 -m halo2_rsa_tpu_torch.examples.<name>``)."""

"""A frozen copy of the port's host synthesis (``halo2_rsa_tpu_torch``'s
``circuit/builder.py``, ``main_gate.py``, ``range_chip.py``, ``bigint/``,
``rsa/``, ``sha256/``, ``fields/field.py`` and ``pipelines.Pkcs1v15Circuit``),
taken unchanged apart from this package's own ``__init__`` files. Plain
Python: it is the benchmark's definition of each configuration's circuit.
"""

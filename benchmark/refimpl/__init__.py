"""The benchmark's plain reference: what decides whether a run's answers are
correct. It imports nothing of the program under test (``halo2_rsa_tpu_torch``)
and nothing of the JAX package; ``harness.guard`` checks that on every run.

* ``synth``: a frozen copy of the port's host synthesis (builder, gadgets,
  the PKCS#1 v1.5 circuit), so that a later change to the program cannot move
  the circuit that answers are judged against.
* ``plonk``: the verifying key worked out again from the circuit and the SRS's
  tau, and a verifier that checks the KZG openings with that tau in place of a
  pairing (the same equation, read in G1).
* ``checks``: gate and lookup violation counts in Python integers.
"""

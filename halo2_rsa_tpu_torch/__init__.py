"""halo2_rsa_tpu_torch — the PyTorch/CUDA port of ``halo2_rsa_tpu``.

The same zero-knowledge RSA-verification prover, held bit for bit against
the JAX package: field elements are canonical Montgomery values (R = 2^256)
stored as ``(..., 8)`` int32 tensors of little-endian 32-bit limbs, and
every proof equals the JAX package's for the same blinding rng.

Layer map (one module per module of the JAX package):
  fields/   — host field constants (carried), vectorized Montgomery math
              (``vecfield``) and the mont_mul CUDA kernel (``cuda_mont``)
  circuit/  — trace builder and gadgets (carried), circuit compilation
  bigint/, rsa/, sha256/ — the circuit gadgets (carried)
  prover/   — curve/transcript (carried), G1 points and their CUDA kernels,
              NTT, MSM, KZG, PLONK keygen/prove/verify
  utils/    — phase timers, the kernels' build
  bench/    — the probes: integer op rates (``vpu_ops``) and K1's memory
              layouts (``mont_layout``)
  csrc/     — the hand-written CUDA sources for sm_90a
  convert   — state carried across from the JAX package (numpy in)

A CUDA tensor runs the kernels; a CPU tensor runs each kernel's plain
PyTorch version. Entry points that make tensors (``kzg.setup``,
``plonk.verify``, ``msm.run_msm``, ``convert.*``, ``vecfield.from_ints``,
...) put them on the card unless the caller passes ``device="cpu"``.
Nothing here imports JAX.
"""

__version__ = "0.1.0"

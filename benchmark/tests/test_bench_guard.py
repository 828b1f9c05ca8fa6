"""The import guard: names compared whole before the first dot; the
reference imports nothing of the program or the JAX side."""

from __future__ import annotations

import os

from harness import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_whole_top_level_names():
    assert guard.forbidden_modules(["halo2_rsa_tpu_torch", "halo2_rsa_tpu_torch.prover",
                                    "jax_like", "numpy"]) == []
    assert guard.forbidden_modules(["halo2_rsa_tpu.prover", "jax.numpy", "flax",
                                    "jaxlib"]) == ["flax", "halo2_rsa_tpu", "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_imports(os.path.join(BENCH, "refimpl")) == []


def test_an_import_of_the_program_is_found(tmp_path):
    (tmp_path / "a.py").write_text("import os\nfrom halo2_rsa_tpu_torch.prover import plonk\n")
    (tmp_path / "b.py").write_text("from . import a\nimport jax.numpy as jnp\n")
    assert guard.reference_imports(str(tmp_path)) == [("a.py", "halo2_rsa_tpu_torch"),
                                                      ("b.py", "jax")]

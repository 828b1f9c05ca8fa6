"""What a run may not load: the JAX package and JAX itself. Names are compared
whole, by the part before the first dot, since the port's package name
(``halo2_rsa_tpu_torch``) begins with the JAX package's (``halo2_rsa_tpu``)."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "halo2_rsa_tpu"})
PROGRAM = "halo2_rsa_tpu_torch"


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def imported_tops(path: str) -> set:
    """Top-level module names that a source file imports (relative imports
    excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def reference_imports(ref_dir: str) -> list:
    """(file, name) for every import of the program or the JAX side in the
    reference's sources."""
    bad = []
    for base, _, files in os.walk(ref_dir):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(base, fn)
                for top in sorted(imported_tops(path) & (FORBIDDEN | {PROGRAM})):
                    bad.append((os.path.relpath(path, ref_dir), top))
    return bad

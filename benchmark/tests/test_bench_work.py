"""The roofline's work counts against hand-worked cases, and their
independence from how a kernel is written."""

from __future__ import annotations

import os
import sys

import pytest

from harness import guard, peaks, work

HERE = os.path.dirname(os.path.abspath(__file__))


def test_montgomery_product():
    assert work.MONT == 136  # 8 x 8 for a * b, 8 x 8 + 8 for the reduction


@pytest.mark.parametrize("kernel,shape,want", [
    # K1: 10 products, b of a's rows: read 2 x 10 x 32, write 10 x 32
    ("K1", (10, 10, 0), (960, 1360)),
    # K1 broadcast: b's 2 distinct rows read once
    ("K1", (10, 2, 1), (704, 1360)),
    # K1-pow, e = 5 = 0b101: 2 squarings + 1 multiplication per element
    ("K1-pow", (4, 5), (256, 4 * 3 * 136)),
    ("K1-pow", (4, 1), (256, 0)),
    # K1-prefix: 2 rows of 6 -> 5 products a row
    ("K1-prefix", (2, 6, 0), (768, 2 * 5 * 136)),
    # K2: 3 start points, rows of 4 affine points, every prefix out
    ("K2", (3, 4), (3 * (96 + 4 * (64 + 96)), 3 * 4 * 11 * 136)),
    # K3: 5 complete additions
    ("K3", (5,), (5 * 288, 5 * 12 * 136)),
    # K3-scan: rows of 8, 7 additions; with the tree 7 more and one point out
    ("K3-scan", (2, 8, 0), (2 * 96 * 16, 2 * 7 * 12 * 136)),
    ("K3-scan", (2, 8, 1), (2 * 96 * 9, 2 * 14 * 12 * 136)),
    # K3-splice: 1 row, 4 buckets over 16 padded points in 2 chunks
    ("K3-splice", (1, 4, 16, 2), (4 * 96 + 2 * 96 + 4 * 8 + 4 * 96, 7 * 12 * 136)),
    # K4: 3 points, 8 doublings each, 6 M + 2 S a doubling
    ("K4", (3, 8), (576, 3 * 8 * 8 * 136)),
])
def test_hand_worked(kernel, shape, want):
    assert work.WORK[kernel](*shape) == want


def test_bound_takes_the_larger():
    peak = peaks.peak("NVIDIA H100 80GB HBM3")
    assert peak["products_per_s"] == pytest.approx(64 * 132 * 1.98e9)
    nbytes, prods = work.k1(1 << 20, 1 << 20, 0)
    assert work.bound_s("K1", (1 << 20, 1 << 20, 0), peak) == pytest.approx(
        max(nbytes / 3.35e12, prods / peak["products_per_s"]))


def test_counts_depend_on_shapes_only(monkeypatch):
    """work.py reads no source and imports nothing but the standard library;
    with the program's package made unimportable the counts are unchanged."""
    tops = guard.imported_tops(os.path.join(os.path.dirname(HERE), "harness", "work.py"))
    assert tops <= {"__future__"}
    before = {k: f(*s) for k, f, s in [("K1", work.k1, (7, 7, 0)), ("K4", work.k4, (3, 2))]}
    monkeypatch.setitem(sys.modules, "halo2_rsa_tpu_torch", None)
    import importlib

    fresh = importlib.reload(work)
    assert {"K1": fresh.k1(7, 7, 0), "K4": fresh.k4(3, 2)} == before

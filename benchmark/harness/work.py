"""The work a hand-written kernel's call needs, from its shapes alone: bytes
moved and 32-bit limb products. The counts do not depend on how a kernel is
written, so a roofline share built on them moves only when the time does.

Derivations (BN254; Fr and Fq elements are 8 limbs of 32 bits, 32 bytes):

* One Montgomery product (CIOS over 8 limbs): 8^2 products for a * b and
  8^2 + 8 for the reduction, ``MONT = 2 * 8**2 + 8 = 136`` limb products.
* A projective G1 point is 3 coordinates, 96 bytes; an affine one 64 bytes.
* Point operations count the field products of Renes-Costello-Batina 2015
  for a = 0: complete addition (Algorithm 7) 12 M, mixed addition
  (Algorithm 8) 11 M, doubling (Algorithm 9) 6 M + 2 S = 8. Their
  multiplications by 3b are left out: 3b = 9 is a small constant.
* Bytes: each input read once, each output written once, a broadcast
  operand's distinct rows once.

Shapes are the ones ``harness.recorder`` writes per call:

* K1 ``mont_mul``: (products n, rows of b nb, broadcast mode).
* K1-pow ``mont_pow``: (elements n, exponent e): square-and-multiply needs
  bits(e) - 1 squarings and popcount(e) - 1 multiplications per element.
* K1-prefix ``mont_prefix``: (rows, n, reversed): n - 1 products a row.
* K2 ``point_scan_mixed``: (start points rows, row length C): rows * C mixed
  additions; start points projective in, affine rows in, every prefix out.
* K3 ``point_add``: (points,): one complete addition each.
* K3-scan ``point_scan`` / ``point_scan_sum``: (rows, L, tree): an inclusive
  scan needs L - 1 additions a row whatever algorithm runs it, and the tree
  that sums the scanned row L - 1 more; out L points a row, or one.
* K3-splice ``bucket_splice``: (rows, buckets B, npad, nchunks): each bucket's
  end is spliced to its chunk's prefix (B additions) and each bucket is the
  difference of two neighbouring ends (B - 1 additions); in B gathered
  points (at most npad), the chunk totals and B int64 ends, out B points.
* K4 ``point_double``: (points, doublings): that many doublings each.
"""

from __future__ import annotations

LIMBS = 8
ELEM = 4 * LIMBS  # bytes of one field element
MONT = 2 * LIMBS * LIMBS + LIMBS  # limb products of one Montgomery product
PROJ, AFF = 3 * ELEM, 2 * ELEM
ADD, MADD, DBL = 12, 11, 8  # field products per RCB15 add / mixed add / doubling


def k1(n: int, nb: int, mode: int) -> tuple:
    return ELEM * (2 * n + nb), n * MONT


def k1_pow(n: int, e: int) -> tuple:
    prods = (e.bit_length() - 1) + (bin(e).count("1") - 1) if e > 1 else 0
    return 2 * ELEM * n, n * prods * MONT


def k1_prefix(rows: int, n: int, reverse: int) -> tuple:
    return 2 * ELEM * rows * n, rows * max(n - 1, 0) * MONT


def k2(rows: int, c: int) -> tuple:
    return rows * (PROJ + c * (AFF + PROJ)), rows * c * MADD * MONT


def k3(points: int) -> tuple:
    return 3 * PROJ * points, points * ADD * MONT


def k3_scan(rows: int, length: int, tree: int) -> tuple:
    adds = (length - 1) * (2 if tree else 1)
    out = 1 if tree else length
    return PROJ * rows * (length + out), rows * adds * ADD * MONT


def k3_splice(rows: int, buckets: int, npad: int, nchunks: int) -> tuple:
    nbytes = rows * (PROJ * min(buckets, npad) + PROJ * nchunks + 8 * buckets + PROJ * buckets)
    return nbytes, rows * (2 * buckets - 1) * ADD * MONT


def k4(points: int, reps: int) -> tuple:
    return 2 * PROJ * points, points * reps * DBL * MONT


WORK = {"K1": k1, "K1-pow": k1_pow, "K1-prefix": k1_prefix, "K2": k2, "K3": k3,
        "K3-scan": k3_scan, "K3-splice": k3_splice, "K4": k4}


def bound_s(kernel: str, shape: tuple, peak: dict) -> float:
    """The least time the card could take for one call: the larger of its
    bytes over the memory rate and its limb products over the integer rate."""
    nbytes, prods = WORK[kernel](*shape)
    return max(nbytes / peak["bytes_per_s"], prods / peak["products_per_s"])

// What the BN254 G1 kernels on the lazy core share: 16-byte loads and
// canonical stores of 8-limb values, the identity, and K3's complete
// projective add, RCB15 algorithm 7 (a = 0, b3 = 9, 12 Montgomery products),
// on fq_lazy.cuh. K3 (g1.cu) runs the add once per thread, the row scans
// (g1_rows.cu) once per round; K2 (g1_scan.cu) uses the loads and stores.
//
// Every value stays in [0, 2q) between steps and is brought to [0, q) by
// one canon() at its store; residues mod q are unique, so the stored
// coordinates equal the canonical formula's (the plain version's and the
// Pallas kernel's) bit for bit.
#pragma once

#include "fq_lazy.cuh"

// R mod q: the Y of the identity (0 : 1 : 0) in Montgomery form
__device__ __forceinline__ uint32_t fq_one(int j) {
  constexpr uint32_t k[fq::N] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
  return k[j];
}

__device__ __forceinline__ void set_identity(uint32_t x[fq::N], uint32_t y[fq::N],
                                             uint32_t z[fq::N]) {
#pragma unroll
  for (int j = 0; j < fq::N; ++j) x[j] = 0, y[j] = fq_one(j), z[j] = 0;
}

// Element i of an array of 8-limb values, as two 16-byte accesses (the
// wrappers require 16-byte aligned tensors).
__device__ __forceinline__ void load8(const uint32_t* __restrict__ p, long long i,
                                      uint32_t r[fq::N]) {
  const uint4* s = reinterpret_cast<const uint4*>(p) + 2 * i;
  uint4 a = s[0], b = s[1];
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w, r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

// Stores a in [0, 2q) as its canonical residue.
__device__ __forceinline__ void store8_canon(uint32_t* __restrict__ p, long long i,
                                             const uint32_t a[fq::N]) {
  uint32_t r[fq::N];
#pragma unroll
  for (int j = 0; j < fq::N; ++j) r[j] = a[j];
  fq::canon(r);
  uint4* d = reinterpret_cast<uint4*>(p) + 2 * i;
  d[0] = make_uint4(r[0], r[1], r[2], r[3]);
  d[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// (x, y, z) += (x2, y2, z2) in place, both operands in [0, 2q): the steps of
// RCB15 algorithm 7 as in the Pallas kernel (pallas_g1.py:_point_add_kernel),
// 3 X1X2 and the two products by b3 = 9 as shifts and adds (mul_small).
__device__ __forceinline__ void add_lazy(uint32_t x[fq::N], uint32_t y[fq::N], uint32_t z[fq::N],
                                         const uint32_t x2[fq::N], const uint32_t y2[fq::N],
                                         const uint32_t z2[fq::N]) {
  uint32_t t0[fq::N], t1[fq::N], t2[fq::N], t3[fq::N], t4[fq::N], t5[fq::N], u[fq::N],
      v[fq::N];
  fq::mul(x, x2, t0);
  fq::mul(y, y2, t1);
  fq::mul(z, z2, t2);
  fq::add(x, y, u);
  fq::add(x2, y2, v);
  fq::mul(u, v, t3);
  fq::add(t0, t1, u);
  fq::sub(t3, u, t3);  // X1Y2 + X2Y1
  fq::add(y, z, u);
  fq::add(y2, z2, v);
  fq::mul(u, v, t4);
  fq::add(t1, t2, u);
  fq::sub(t4, u, t4);  // Y1Z2 + Y2Z1
  fq::add(x, z, u);
  fq::add(x2, z2, v);
  fq::mul(u, v, t5);
  fq::add(t0, t2, u);
  fq::sub(t5, u, t5);  // X1Z2 + X2Z1
  uint32_t trip0[fq::N], z3t[fq::N];
  fq::mul_small<3>(t0, trip0);  // 3 X1X2
  fq::mul_small<9>(t2, t2);     // b3 Z1Z2
  fq::add(t1, t2, z3t);
  fq::sub(t1, t2, t1);
  fq::mul_small<9>(t5, t5);  // b3 (X1Z2 + X2Z1)
  uint32_t m0[fq::N], m1[fq::N];
  fq::mul(t4, t5, m0);
  fq::mul(t3, t1, m1);
  fq::sub(m1, m0, x);  // X3
  fq::mul(t5, trip0, m0);
  fq::mul(t1, z3t, m1);
  fq::add(m1, m0, y);  // Y3
  fq::mul(trip0, t3, m0);
  fq::mul(z3t, t4, m1);
  fq::add(m1, m0, z);  // Z3
}

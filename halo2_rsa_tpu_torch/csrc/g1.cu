// K3: BN254 G1 point addition, Renes-Costello-Batina 2015 algorithm 7
// (complete projective add, 12 muls) for a = 0, b3 = 3 * b = 9, projective
// (X, Y, Z) over Fq in Montgomery form, one thread per point; replaces
// halo2_rsa_tpu/prover/pallas_g1.py:_point_add_kernel. (K2, the mixed add, is
// g1_scan.cu; K4, the doubling, is g1_double.cu.)
//
// The formula is written step for step as in the Pallas kernel, and every
// field operation returns the canonical residue, so the projective outputs
// equal the TPU kernel's bit for bit.
//
// What bounds it on an H100: a point add reads 6 and writes 3 coordinates
// (32 bytes each, ~290 bytes) and runs 12 Montgomery products plus ~20
// modular adds (~4,000 integer instructions), so it is bound by integer
// issue, not memory. The Pallas kernel kept every intermediate in VMEM; here
// every intermediate lives in registers of the one thread that owns the
// point (no shared memory, no inter-thread traffic). Register pressure (a
// dozen live 8-limb temporaries) is the design's limit on occupancy.
#include <cuda_runtime.h>

#include "field.cuh"

__global__ void h2r_g1_add_kernel(const uint32_t* __restrict__ x1p, const uint32_t* __restrict__ y1p,
                                  const uint32_t* __restrict__ z1p, const uint32_t* __restrict__ x2p,
                                  const uint32_t* __restrict__ y2p, const uint32_t* __restrict__ z2p,
                                  uint32_t* __restrict__ x3p, uint32_t* __restrict__ y3p,
                                  uint32_t* __restrict__ z3p, long long n, FieldP f) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x1[H2R_LIMBS], y1[H2R_LIMBS], z1[H2R_LIMBS];
  uint32_t x2[H2R_LIMBS], y2[H2R_LIMBS], z2[H2R_LIMBS];
  fe_load(x1p, i, x1);
  fe_load(y1p, i, y1);
  fe_load(z1p, i, z1);
  fe_load(x2p, i, x2);
  fe_load(y2p, i, y2);
  fe_load(z2p, i, z2);
  uint32_t t0[H2R_LIMBS], t1[H2R_LIMBS], t2[H2R_LIMBS], t3[H2R_LIMBS], t4[H2R_LIMBS],
      t5[H2R_LIMBS], u[H2R_LIMBS], v[H2R_LIMBS];
  fe_mul(x1, x2, t0, f);
  fe_mul(y1, y2, t1, f);
  fe_mul(z1, z2, t2, f);
  fe_add(x1, y1, u, f);
  fe_add(x2, y2, v, f);
  fe_mul(u, v, t3, f);
  fe_add(t0, t1, u, f);
  fe_sub(t3, u, t3, f);  // X1Y2 + X2Y1
  fe_add(y1, z1, u, f);
  fe_add(y2, z2, v, f);
  fe_mul(u, v, t4, f);
  fe_add(t1, t2, u, f);
  fe_sub(t4, u, t4, f);  // Y1Z2 + Y2Z1
  fe_add(x1, z1, u, f);
  fe_add(x2, z2, v, f);
  fe_mul(u, v, t5, f);
  fe_add(t0, t2, u, f);
  fe_sub(t5, u, t5, f);  // X1Z2 + X2Z1
  uint32_t trip0[H2R_LIMBS], b3z[H2R_LIMBS], z3t[H2R_LIMBS], y3t[H2R_LIMBS];
  fe_add(t0, t0, trip0, f);
  fe_add(trip0, t0, trip0, f);  // 3 X1X2
  fe_mul9(t2, b3z, f);          // b3 Z1Z2
  fe_add(t1, b3z, z3t, f);
  fe_sub(t1, b3z, t1, f);
  fe_mul9(t5, y3t, f);  // b3 (X1Z2 + X2Z1)
  uint32_t m0[H2R_LIMBS], m1[H2R_LIMBS], r[H2R_LIMBS];
  fe_mul(t4, y3t, m0, f);
  fe_mul(t3, t1, m1, f);
  fe_sub(m1, m0, r, f);
  fe_store(x3p, i, r);
  fe_mul(y3t, trip0, m0, f);
  fe_mul(t1, z3t, m1, f);
  fe_add(m1, m0, r, f);
  fe_store(y3p, i, r);
  fe_mul(trip0, t3, m0, f);
  fe_mul(z3t, t4, m1, f);
  fe_add(m1, m0, r, f);
  fe_store(z3p, i, r);
}

namespace {
FieldP make_field(const uint32_t* p_host, uint32_t n0inv) {
  FieldP f;
  for (int j = 0; j < H2R_LIMBS; ++j) f.p[j] = p_host[j];
  f.n0inv = n0inv;
  return f;
}
constexpr int kThreads = 128;
unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }
}  // namespace

extern "C" int h2r_g1_add(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* x3, void* y3, void* z3,
                          long long n, const uint32_t* p_host, uint32_t n0inv, void* stream) {
  if (n <= 0) return 0;
  h2r_g1_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
      make_field(p_host, n0inv));
  return (int)cudaGetLastError();
}

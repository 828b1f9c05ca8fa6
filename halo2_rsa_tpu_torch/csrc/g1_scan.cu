// K2: BN254 G1 mixed addition, Renes-Costello-Batina 2015 algorithm 8 (a = 0,
// b3 = 9, 11 Montgomery products), projective P1 + affine P2 over Fq in
// Montgomery form, run as the MSM's bucket scan runs it: one thread per row,
// `c` adds per launch, every prefix stored.
//
// Replaces halo2_rsa_tpu/prover/pallas_g1.py:_point_add_mixed_kernel. Its one
// caller is the bucket scan of msm._bucket_sums, which adds the C sorted
// affine points of each chunk one after another into a running sum and keeps
// every prefix; the JAX package runs that as a fori_loop of C mixed adds.
// Here one launch covers all rows (windows x chunks): a thread loads its start
// point once, keeps the running sum in registers, loads each affine point
// once and stores each prefix once, in the (rows, C, 8) layout that the
// bucket-boundary gathers read.
//
// The bucket scan's affine points are the segment's points in digit order.
// Given the sort's permutation (`idx`, one int64 source row per step), step k
// of a row reads source point idx[k] of an (N, 8) source in place, so that no
// sorted copy of x and y is gathered into device memory first (the segment's
// 2^15 points, 2 MB, stay in L2; the copy was (rows * C) rows of 32 bytes per
// coordinate). Without it, step k reads row k of a dense (rows * C, 8) copy.
//
// What bounds it on an H100: per add it reads 2 coordinates and writes 3 (160
// bytes) and runs 11 Montgomery products, mostly IMAD.WIDE.U32.X on the FMA
// pipe, so at the prover's widest scan (2^16 rows) it is bound by the FMA
// pipe, and at its narrowest (2^14 rows, about one warp per scheduler) by one
// thread's dependent chain. So the step runs on the lazy core of fq_lazy.cuh
// (values in [0, 2q): no subtract after a product, one after an add, 3X and
// 9Z as shifts and adds), and each prefix is brought to [0, q) by one canon()
// on a copy at its store; residues mod q are unique, so every prefix equals
// the plain version's (and the Pallas kernel's) bit for bit. Coordinates move
// as two 16-byte accesses each.
#include <cuda_runtime.h>

#include "g1_lazy.cuh"

// One mixed add in place, (x, y, z) += (ax, ay), every value in [0, 2q); the
// steps of RCB15 algorithm 8 as in the Pallas kernel.
__device__ __forceinline__ void add_mixed_lazy(uint32_t x[fq::N], uint32_t y[fq::N],
                                               uint32_t z[fq::N], const uint32_t ax[fq::N],
                                               const uint32_t ay[fq::N]) {
  uint32_t t0[fq::N], t1[fq::N], t3[fq::N], t4[fq::N], y3[fq::N], u[fq::N], v[fq::N];
  fq::mul(x, ax, t0);
  fq::mul(y, ay, t1);
  fq::add(ax, ay, u);
  fq::add(x, y, v);
  fq::mul(u, v, t3);
  fq::add(t0, t1, u);
  fq::sub(t3, u, t3);  // X1Y2 + X2Y1
  fq::mul(ay, z, u);
  fq::add(u, y, t4);  // Y1 + Y2Z1
  fq::mul(ax, z, u);
  fq::add(u, x, y3);  // X1 + X2Z1
  uint32_t trip0[fq::N], t2[fq::N], z3t[fq::N];
  fq::mul_small<3>(t0, trip0);  // 3 X1X2
  fq::mul_small<9>(z, t2);      // b3 Z1
  fq::add(t1, t2, z3t);
  fq::sub(t1, t2, t1);
  fq::mul_small<9>(y3, y3);  // b3 (X1 + X2Z1)
  uint32_t m0[fq::N], m1[fq::N];
  fq::mul(t4, y3, m0);
  fq::mul(t3, t1, m1);
  fq::sub(m1, m0, x);  // X3
  fq::mul(y3, trip0, m0);
  fq::mul(t1, z3t, m1);
  fq::add(m1, m0, y);  // Y3
  fq::mul(trip0, t3, m0);
  fq::mul(z3t, t4, m1);
  fq::add(m1, m0, z);  // Z3
}

// Start points (m, 8) per coordinate, prefixes (m, c, 8); affine points
// (m, c, 8), or with `idx` (m * c int64) rows of an (N, 8) source.
__global__ void h2r_g1_scan_mixed_kernel(const uint32_t* __restrict__ x1p,
                                         const uint32_t* __restrict__ y1p,
                                         const uint32_t* __restrict__ z1p,
                                         const uint32_t* __restrict__ x2p,
                                         const uint32_t* __restrict__ y2p,
                                         const long long* __restrict__ idx,
                                         uint32_t* __restrict__ x3p, uint32_t* __restrict__ y3p,
                                         uint32_t* __restrict__ z3p, long long m, int c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t x[fq::N], y[fq::N], z[fq::N], ax[fq::N], ay[fq::N];
  load8(x1p, i, x);
  load8(y1p, i, y);
  load8(z1p, i, z);
  const long long end = (i + 1) * c;
  // source row of step k: idx[k], or k itself
  const long long k0 = i * c;
  long long src = idx ? idx[k0] : k0;
  load8(x2p, src, ax);
  load8(y2p, src, ay);
  src = k0 + 1 < end ? k0 + 1 : k0;
  if (idx) src = idx[src];
#pragma unroll 1
  for (long long k = k0; k < end; ++k) {
    // the next step's point (its source row known a step ahead) and the
    // step after's source row are loaded while this step computes (the
    // last steps load their own again)
    const long long next = k + 1 < end ? k + 1 : k;
    uint32_t nx[fq::N], ny[fq::N];
    load8(x2p, src, nx);
    load8(y2p, src, ny);
    long long after = next + 1 < end ? next + 1 : next;
    if (idx) after = idx[after];
    add_mixed_lazy(x, y, z, ax, ay);
    store8_canon(x3p, k, x);
    store8_canon(y3p, k, y);
    store8_canon(z3p, k, z);
#pragma unroll
    for (int j = 0; j < fq::N; ++j) ax[j] = nx[j], ay[j] = ny[j];
    src = after;
  }
}

// The wrapper (cuda_g1.point_scan_mixed) refuses any field but BN254 Fq,
// whose constants the kernel has built in. `idx` may be null (dense rows).
extern "C" int h2r_g1_scan_mixed(const void* x1, const void* y1, const void* z1, const void* x2,
                                 const void* y2, const void* idx, void* x3, void* y3, void* z3,
                                 long long m, int c, void* stream) {
  if (m <= 0) return 0;
  if (c < 1) return (int)cudaErrorInvalidValue;
  // At the prover's narrowest scan (2^14 rows) 64-thread blocks give each of
  // the 132 SMs work (256 blocks); 128-thread blocks would leave four idle.
  // Either way an SM holds at most four warps there.
  constexpr int threads = 64;
  h2r_g1_scan_mixed_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const long long*)idx, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3,
      m, c);
  return (int)cudaGetLastError();
}

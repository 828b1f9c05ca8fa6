// K4: BN254 G1 point doubling, Renes-Costello-Batina 2015 algorithm 9 (a = 0,
// b3 = 9, 8 Montgomery products), projective (X, Y, Z) over Fq in Montgomery
// form, one thread per point, `reps` doublings per launch.
//
// Replaces halo2_rsa_tpu/prover/pallas_g1.py:_point_double_kernel. Its one
// caller is the MSM's Horner combine, which doubles `window_bits` times per
// window over the P polys of one msm_many call, a handful of points; the JAX
// package runs that as a fori_loop. Here one launch loads a point once,
// doubles it `reps` times in registers and stores once.
//
// What bounds it on an H100: at the prover's shape (a few points) one
// thread's dependent chain and the launch, not throughput, so the design
// shortens the chain: the lazy core of fq_lazy.cuh keeps every value in
// [0, 2q) (no subtract after a product, one after an add), carries ride the
// carry flag of 32-bit PTX chains laid out so that each 32 x 32 -> 64-bit
// product with its carries is one IMAD.WIDE.U32.X, and the small multiples
// 8Y^2, 9Z^2 and 3 (9Z^2) are shifts and adds with one estimated-quotient
// reduction. Every
// coordinate is brought to [0, q) once, at the store; residues mod q are
// unique, so the result equals `reps` canonical doublings (the plain version
// and the Pallas kernel) bit for bit. At 2^16 points it is bound by the FMA
// pipe (the products' multiply-adds).
#include <cuda_runtime.h>

#include "fq_lazy.cuh"

// One doubling in place, every value in [0, 2q).
__device__ __forceinline__ void double_lazy(uint32_t x[fq::N], uint32_t y[fq::N],
                                            uint32_t z[fq::N]) {
  uint32_t t0[fq::N], t1[fq::N], t2[fq::N], xy[fq::N], z3[fq::N], y3[fq::N], u[fq::N],
      r[fq::N];
  fq::mul(y, y, t0);
  fq::mul(y, z, t1);
  fq::mul(z, z, t2);
  fq::mul(x, y, xy);
  fq::mul_small<8>(t0, z3);  // 8 Y^2
  fq::mul_small<9>(t2, t2);  // b3 Z^2
  fq::add(t0, t2, y3);
  fq::mul_small<3>(t2, u);
  fq::sub(t0, u, t0);
  fq::mul(t1, z3, z);  // Z3
  fq::mul(t2, z3, u);
  fq::mul(t0, y3, r);
  fq::add(u, r, y);  // Y3
  fq::mul(t0, xy, r);
  fq::add(r, r, x);  // X3
}

__global__ void h2r_g1_double_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                                     const uint32_t* __restrict__ zp, uint32_t* __restrict__ x3p,
                                     uint32_t* __restrict__ y3p, uint32_t* __restrict__ z3p,
                                     long long n, int reps) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fq::N], y[fq::N], z[fq::N];
#pragma unroll
  for (int j = 0; j < fq::N; ++j) {
    x[j] = xp[i * fq::N + j];
    y[j] = yp[i * fq::N + j];
    z[j] = zp[i * fq::N + j];
  }
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) double_lazy(x, y, z);
  fq::canon(x);
  fq::canon(y);
  fq::canon(z);
#pragma unroll
  for (int j = 0; j < fq::N; ++j) {
    x3p[i * fq::N + j] = x[j];
    y3p[i * fq::N + j] = y[j];
    z3p[i * fq::N + j] = z[j];
  }
}

// The wrapper (cuda_g1.point_double) refuses any field but BN254 Fq, whose
// constants the kernel has built in.
extern "C" int h2r_g1_double(const void* x, const void* y, const void* z, void* x3, void* y3,
                             void* z3, long long n, int reps, void* stream) {
  if (n <= 0) return 0;
  if (reps < 1) return (int)cudaErrorInvalidValue;
  // The Horner combine launches K4 over P <= 32 points: one warp holds them,
  // and the three other warps of a 128-thread block would only be scheduled
  // to exit. Above 32 points the block is 128 threads, as for K2 and K3.
  const int threads = n <= 32 ? 32 : 128;
  h2r_g1_double_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)x3, (uint32_t*)y3,
      (uint32_t*)z3, n, reps);
  return (int)cudaGetLastError();
}

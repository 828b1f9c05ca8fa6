// K3: BN254 G1 point addition, Renes-Costello-Batina 2015 algorithm 7
// (complete projective add, 12 muls) for a = 0, b3 = 3 * b = 9, projective
// (X, Y, Z) over Fq in Montgomery form, one thread per point; replaces
// halo2_rsa_tpu/prover/pallas_g1.py:_point_add_kernel. (K2, the mixed add, is
// g1_scan.cu; K4, the doubling, is g1_double.cu; the MSM's Hillis-Steele
// scans and halving trees of this add are g1_rows.cu.)
//
// What bounds it on an H100: a point add reads 6 and writes 3 coordinates
// (288 bytes) and runs 12 Montgomery products, mostly IMAD.WIDE.U32.X on the
// FMA pipe, so it is bound by operations, not memory. So the add runs on the
// lazy core of fq_lazy.cuh (add_lazy in g1_lazy.cuh: values in [0, 2q), no
// subtract after a product, one after an add, 3 X1X2 and the products by
// b3 = 9 as shifts and adds), every intermediate lives in the registers of
// the thread that owns the point, coordinates move as two 16-byte accesses
// each, and each output is brought to [0, q) by one canon() at its store, so
// it equals the plain version's (and the Pallas kernel's) bit for bit.
#include <cuda_runtime.h>

#include "g1_lazy.cuh"

__global__ void h2r_g1_add_kernel(const uint32_t* __restrict__ x1p, const uint32_t* __restrict__ y1p,
                                  const uint32_t* __restrict__ z1p, const uint32_t* __restrict__ x2p,
                                  const uint32_t* __restrict__ y2p, const uint32_t* __restrict__ z2p,
                                  uint32_t* __restrict__ x3p, uint32_t* __restrict__ y3p,
                                  uint32_t* __restrict__ z3p, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fq::N], y[fq::N], z[fq::N], x2[fq::N], y2[fq::N], z2[fq::N];
  load8(x1p, i, x);
  load8(y1p, i, y);
  load8(z1p, i, z);
  load8(x2p, i, x2);
  load8(y2p, i, y2);
  load8(z2p, i, z2);
  add_lazy(x, y, z, x2, y2, z2);
  store8_canon(x3p, i, x);
  store8_canon(y3p, i, y);
  store8_canon(z3p, i, z);
}

// The wrapper (cuda_g1.point_add) refuses any field but BN254 Fq, whose
// constants the kernel has built in.
extern "C" int h2r_g1_add(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* x3, void* y3, void* z3,
                          long long n, void* stream) {
  if (n <= 0) return 0;
  // the Horner combine's adds run over P <= 32 points: one warp holds them
  const int threads = n <= 32 ? 32 : 128;
  h2r_g1_add_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n);
  return (int)cudaGetLastError();
}

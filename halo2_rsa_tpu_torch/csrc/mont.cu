// K1: batched Montgomery multiplication, out[i] = a[i] * b[i] * 2^-256 mod p.
//
// Replaces halo2_rsa_tpu/fields/pallas_mont.py:_mont_mul_kernel_body (built by
// _build_call), which held the 16-step CIOS over 16-bit limbs in VMEM so that
// a block of products touched HBM once.
//
// What bounds it on an H100: each element reads 64 bytes and writes 32, and
// costs 2 * 64 32x32->64 multiply-adds plus carry handling (~300 integer
// instructions). At 3.35 TB/s that is ~35 G elements/s of memory traffic
// against roughly 60-70 G elements/s of integer issue across 132 SMs, so the
// kernel sits near the memory/integer balance point. The design keeps the
// whole CIOS in registers (one thread per element, no shared memory), which
// is what the TPU kernel's VMEM residency bought; coalesced limb-major
// layouts and vectorised loads are left to later work.
#include <cuda_runtime.h>

#include "field.cuh"

__global__ void h2r_mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                    uint32_t* __restrict__ out, long long n, FieldP f) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[H2R_LIMBS], y[H2R_LIMBS], r[H2R_LIMBS];
  fe_load(a, i, x);
  fe_load(b, i, y);
  fe_mul(x, y, r, f);
  fe_store(out, i, r);
}

extern "C" int h2r_mont_mul(const void* a, const void* b, void* out, long long n,
                            const uint32_t* p_host, uint32_t n0inv, void* stream) {
  if (n <= 0) return 0;
  FieldP f;
  for (int j = 0; j < H2R_LIMBS; ++j) f.p[j] = p_host[j];
  f.n0inv = n0inv;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  h2r_mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, f);
  return (int)cudaGetLastError();
}

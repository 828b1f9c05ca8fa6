// K1-pow: out[i] = a[i]^e for one exponent 0 <= e < 2^256, Montgomery form
// (R = 2^256) in and out; e = 0 gives R mod p, and 0^e = 0 for e > 0.
//
// Replaces the TPU's exponentiation on K1
// (halo2_rsa_tpu/fields/pallas_mont.py:_mont_mul_kernel_body): the JAX
// package's vecfield._pow_bits is one lax.scan over e's bits, two K1 products
// per bit inside one compiled loop. Eagerly, that is one K1 launch per
// product (380 launches for a field inversion, a^(p-2) over BN254 Fr). Here
// the whole square-and-multiply runs in registers on K1's CIOS core
// (fe_mul), one thread per element.
//
// The order of the products is free: each Montgomery product returns the
// unique canonical residue, so left-to-right (e's bits from the top, starting
// at a, one product fewer) gives the bits of the reference's LSB-first
// ladder.
//
// What bounds it on an H100: the prover runs it at n = 1 (the one inversion
// of batch_inv_nz per call). That is one dependent chain of ~380 products on
// one thread, so its floor is the latency of that chain, not bytes (64 per
// element) or issue rate (~0 at n = 1). Nothing in the design can shorten the
// chain; it removes the ~380 launches and their host dispatch.
#include <cuda_runtime.h>

#include "field.cuh"

struct Exponent {
  uint32_t w[H2R_LIMBS];  // little-endian limbs of e
};

__global__ void h2r_mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                                    long long n, Exponent e, int e_bits, FieldP f) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[H2R_LIMBS];
  if (e_bits == 0) {
    fe_mont_one(acc, f);
  } else {
    uint32_t x[H2R_LIMBS];
    fe_load16(a, i, x);
    fe_reduce(x, f);  // a canonical base makes e = 1 canonical too
#pragma unroll
    for (int j = 0; j < H2R_LIMBS; ++j) acc[j] = x[j];
#pragma unroll 1
    for (int b = e_bits - 2; b >= 0; --b) {
      fe_mul(acc, acc, acc, f);
      if ((e.w[b >> 5] >> (b & 31)) & 1u) fe_mul(acc, x, acc, f);
    }
  }
  fe_store16(out, i, acc);
}

extern "C" int h2r_mont_pow(const void* a, void* out, long long n, const uint32_t* e_host,
                            int e_bits, const uint32_t* p_host, uint32_t n0inv, void* stream) {
  if (n <= 0) return 0;
  if (e_bits < 0 || e_bits > 32 * H2R_LIMBS) return (int)cudaErrorInvalidValue;
  Exponent e;
  FieldP f;
  for (int j = 0; j < H2R_LIMBS; ++j) {
    e.w[j] = e_host[j];
    f.p[j] = p_host[j];
  }
  f.n0inv = n0inv;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  h2r_mont_pow_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n, e, e_bits, f);
  return (int)cudaGetLastError();
}

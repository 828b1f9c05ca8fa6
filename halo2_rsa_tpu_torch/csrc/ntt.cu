// NTT: the radix-2 constant-geometry (Pease) transform over BN254 Fr, one
// launch per stage, over a batch of P polys of N = 2^log_n elements.
//
// Replaces no Pallas kernel: the JAX package's NTT
// (halo2_rsa_tpu/prover/ntt.py) is plain jnp, which XLA fuses on the TPU. In
// the port the same stage loop in torch ops cost ~162 launches a stage (a
// field add and a sub, each widened to int64 with two carry passes, a K1
// product, a stack, and above 2^20 the stage's twiddles rebuilt by two
// gathers and one more K1), so this kernel fuses a whole stage:
//
//   s_i = x_i + x_{i+N/2}
//   d_i = (x_i - x_{i+N/2}) * W^{(i >> t) << t}
//   out[2i] = s_i, out[2i+1] = d_i
//
// one thread per butterfly, all in registers. The twiddle is formed in the
// kernel as hi[e >> h] * lo[e & (2^h - 1)] from the two sqrt(N)-row tables
// of prover/ntt.py's _twiddle_tables (at most 2^10 rows each, resident in
// L1/L2): no per-stage twiddle tensor is read or kept. From stage h on, e's
// low h bits are zero and lo[0] = 1, so the twiddle is hi[e >> h] alone.
// The last stage's twiddle is W^0 = 1: it writes each output at its
// bit-reversed position and, for an inverse, scales by N^-1 on the way out,
// so an NTT of 2^log_n is exactly log_n launches.
//
// What bounds it on an H100: a stage reads and writes every element once,
// 2 x 64 bytes a butterfly (537 MB a stage over (4, 2^21) elements, 0.16 ms
// at 3.35 TB/s), against one field add, one sub and one or two CIOS
// products (~500 issued instructions each) a butterfly: near the balance
// point of memory and integer issue, like K1's large launches. So:
// - the element pair moves as four 16-byte vectors, neighbouring threads on
//   neighbouring addresses (the interleaved store is 64 contiguous bytes a
//   thread); the last stage's scattered stores are whole 32-byte sectors;
// - nothing is materialised between the add, the sub and the product (the
//   torch loop wrote and read int64 temporaries eight times the size);
// - the block shrinks from 256 threads as K1's does (h2r_mont_mul_threads),
//   so that the smallest batches still spread over every SM.
// Every output is the canonical residue, so the result is bitwise the torch
// loop's.
#include <cuda_runtime.h>

#include "field.cuh"

struct FieldElem {
  uint32_t v[H2R_LIMBS];
};

extern "C" int h2r_mont_mul_threads(long long n);  // csrc/mont.cu

// stage t of log_n (LAST: t = log_n - 1): thread g is butterfly i = g mod N/2
// of poly g div N/2
template <int LAST>
__global__ void h2r_ntt_stage_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                                     const uint32_t* __restrict__ hi,
                                     const uint32_t* __restrict__ lo, long long butterflies,
                                     int log_n, int t, int h, int scale, FieldElem n_inv,
                                     FieldP f) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= butterflies) return;
  const long long half = 1ll << (log_n - 1);
  const long long base = (g >> (log_n - 1)) << log_n;  // the poly's first element
  const long long i = g & (half - 1);
  uint32_t x[H2R_LIMBS], y[H2R_LIMBS], s[H2R_LIMBS], d[H2R_LIMBS];
  fe_load16(src, base + i, x);
  fe_load16(src, base + i + half, y);
  fe_add(x, y, s, f);
  fe_sub(x, y, d, f);
  if (LAST) {
    if (scale) {
      fe_mul(s, n_inv.v, s, f);
      fe_mul(d, n_inv.v, d, f);
    }
    // Pease index 2i is output rev(2i) = rev_{log_n - 1}(i); 2i + 1 is that + N/2
    const long long r =
        log_n > 1 ? (long long)(__brevll((unsigned long long)i) >> (65 - log_n)) : 0;
    fe_store16(dst, base + r, s);
    fe_store16(dst, base + r + half, d);
  } else {
    const long long e = (i >> t) << t;
    uint32_t w[H2R_LIMBS];
    fe_load16(hi, e >> h, w);
    if (t < h) {
      uint32_t l[H2R_LIMBS];
      fe_load16(lo, e & ((1ll << h) - 1), l);
      fe_mul(w, l, w, f);
    }
    fe_mul(d, w, d, f);
    fe_store16(dst, base + 2 * i, s);
    fe_store16(dst, base + 2 * i + 1, d);
  }
}

// log_n launches over (polys, 2^log_n) elements: stage 0 reads in, the
// stages alternate between out and scratch so that the last writes out
// (scratch unused when log_n == 1). in, out and scratch are distinct;
// inverse selects the scale by n_inv at the last stage (the tables are
// the caller's, for the direction it wants).
extern "C" int h2r_ntt(const void* in, void* out, void* scratch, long long polys, int log_n,
                       int inverse, const void* hi, const void* lo, int h,
                       const uint32_t* n_inv_host, const uint32_t* p_host, uint32_t n0inv,
                       void* stream) {
  if (polys <= 0 || log_n <= 0) return 0;
  if (log_n > 28 || h < 0 || h > log_n) return (int)cudaErrorInvalidValue;
  FieldP f;
  FieldElem n_inv;
  for (int j = 0; j < H2R_LIMBS; ++j) {
    f.p[j] = p_host[j];
    n_inv.v[j] = n_inv_host[j];
  }
  f.n0inv = n0inv;
  const long long butterflies = polys << (log_n - 1);
  const int threads = h2r_mont_mul_threads(butterflies);
  const unsigned blocks = (unsigned)((butterflies + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* ph = (const uint32_t*)hi;
  const uint32_t* pl = (const uint32_t*)lo;
  const uint32_t* src = (const uint32_t*)in;
  for (int t = 0; t < log_n; ++t) {
    uint32_t* dst = (uint32_t*)(((log_n - 1 - t) % 2 == 0) ? out : scratch);
    if (t + 1 < log_n) {
      h2r_ntt_stage_kernel<0><<<blocks, threads, 0, s>>>(src, dst, ph, pl, butterflies, log_n,
                                                         t, h, 0, n_inv, f);
    } else {
      h2r_ntt_stage_kernel<1><<<blocks, threads, 0, s>>>(src, dst, ph, pl, butterflies, log_n,
                                                         t, h, inverse, n_inv, f);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}

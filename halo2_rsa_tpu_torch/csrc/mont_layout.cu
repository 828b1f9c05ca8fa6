// P2: K1 (the Montgomery product of csrc/mont.cu) on two other memory
// layouts, to measure how the layout moves K1's time.
//
// Replaces the Pallas probe of scripts/bench_mont_layout.py (build_bm, body
// _kernel_bm): the TPU kernel took batch-major (N, 16) blocks and transposed
// them in VMEM, because its vector unit wants limb-major rows while the
// prover's arrays are batch-major. On the H100 the two counterparts are:
//
// (b') h2r_mont_mul_lm: limb-major (8, N) data, limb j of element i at
//      j * N + i. Every load and store of a warp is 32 neighbouring 4-byte
//      words (the script's (b), the bare kernel on pre-transposed data).
// (d') h2r_mont_mul_staged<T>: element-major (N, 8) data, K1's own layout,
//      staged through shared memory (the script's _kernel_bm, the transpose
//      inside the kernel). A block of T threads copies its T x 32-byte tiles
//      of a and b with coalesced 16-byte loads into shared memory, each
//      thread computes on its own element there, and the block writes the
//      tile back the same way. T = 128/256/512 stands for the script's
//      2048/4096/8192-row blocks.
//
// K1 itself (one thread per element, eight 4-byte loads 32 bytes apart) is
// variant (a). What bounds all three: 96 bytes of memory traffic per
// product against the CIOS's ~300-400 integer instructions; at 3.35 TB/s
// and 64 integer lanes per SM the two are close, so the layout decides
// whether the loads reach the memory rate.
//
// Shared-memory layout of (d'): a tile holds each element as two 16-byte
// chunks; chunk c of element e sits in slot 2e + (c ^ ((e >> 2) & 1)). A
// 16-byte shared access is served 8 threads at a time; with this swizzle
// both the copy (threads k -> element k / 2, chunk k % 2) and the compute
// (thread e reads its two chunks) touch 8 distinct 16-byte bank groups per
// 8 threads, so neither has bank conflicts (without it, the compute's reads
// would be 2-way conflicted).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

FieldP field_params(const uint32_t* p_host, uint32_t n0inv) {
  FieldP f;
  for (int j = 0; j < H2R_LIMBS; ++j) f.p[j] = p_host[j];
  f.n0inv = n0inv;
  return f;
}

__global__ void h2r_mont_mul_lm_kernel(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       uint32_t* __restrict__ out, long long n, FieldP f) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[H2R_LIMBS], y[H2R_LIMBS], r[H2R_LIMBS];
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) {
    x[j] = a[j * n + i];
    y[j] = b[j * n + i];
  }
  fe_mul(x, y, r, f);
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) out[j * n + i] = r[j];
}

__device__ __forceinline__ int chunk_slot(int e, int c) { return 2 * e + (c ^ ((e >> 2) & 1)); }

template <int T>
__global__ void __launch_bounds__(T)
    h2r_mont_mul_staged_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                               uint4* __restrict__ out, long long n, FieldP f) {
  __shared__ uint4 sa[2 * T];
  __shared__ uint4 sb[2 * T];
  const long long first = (long long)blockIdx.x * T;  // first element of this tile
  const int m = (int)min((long long)T, n - first);     // elements in this tile
  const long long g0 = 2 * first;                      // first 16-byte chunk
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = threadIdx.x + r * T;
    if (k < 2 * m) {
      int s = chunk_slot(k >> 1, k & 1);
      sa[s] = a[g0 + k];
      sb[s] = b[g0 + k];
    }
  }
  __syncthreads();
  const int e = threadIdx.x;
  if (e < m) {
    const int s0 = chunk_slot(e, 0), s1 = chunk_slot(e, 1);
    uint4 a0 = sa[s0], a1 = sa[s1], b0 = sb[s0], b1 = sb[s1];
    uint32_t x[H2R_LIMBS] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    uint32_t y[H2R_LIMBS] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t r[H2R_LIMBS];
    fe_mul(x, y, r, f);
    sa[s0] = make_uint4(r[0], r[1], r[2], r[3]);
    sa[s1] = make_uint4(r[4], r[5], r[6], r[7]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = threadIdx.x + r * T;
    if (k < 2 * m) out[g0 + k] = sa[chunk_slot(k >> 1, k & 1)];
  }
}

template <int T>
cudaError_t launch_staged(const void* a, const void* b, void* out, long long n, FieldP f,
                          cudaStream_t stream) {
  unsigned blocks = (unsigned)((n + T - 1) / T);
  h2r_mont_mul_staged_kernel<T><<<blocks, T, 0, stream>>>((const uint4*)a, (const uint4*)b,
                                                          (uint4*)out, n, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int h2r_mont_mul_lm(const void* a, const void* b, void* out, long long n,
                               const uint32_t* p_host, uint32_t n0inv, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  h2r_mont_mul_lm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, field_params(p_host, n0inv));
  return (int)cudaGetLastError();
}

// threads: 128, 256 or 512 (the wrapper's THREADS); a, b, out 16-byte aligned.
extern "C" int h2r_mont_mul_staged(const void* a, const void* b, void* out, long long n,
                                   const uint32_t* p_host, uint32_t n0inv, int threads,
                                   void* stream) {
  if (n <= 0) return 0;
  FieldP f = field_params(p_host, n0inv);
  auto s = (cudaStream_t)stream;
  switch (threads) {
    case 128: return (int)launch_staged<128>(a, b, out, n, f, s);
    case 256: return (int)launch_staged<256>(a, b, out, n, f, s);
    case 512: return (int)launch_staged<512>(a, b, out, n, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

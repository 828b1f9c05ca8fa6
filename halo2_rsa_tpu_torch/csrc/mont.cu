// K1: batched Montgomery multiplication, out[i] = a[i] * b[j] * 2^-256 mod p,
// where b is either a's shape (j = i) or a broadcast operand read in place,
// given by its distinct rows: repeated over a's leading axes (MODE 1,
// "cycle": j = i mod nb; NTT twiddles over a batch of polys, a constant row,
// the checker's coefficients over a batch of witnesses) or along its row axis
// (MODE 2, "repeat": j = i div (n / nb); a per-poly scale over that poly's
// row).
//
// Replaces halo2_rsa_tpu/fields/pallas_mont.py:_mont_mul_kernel_body (built by
// _build_call), which held the 16-step CIOS over 16-bit limbs in VMEM so that
// a block of products touched HBM once.
//
// What bounds it on an H100: each product reads 64 bytes (32 when b is a
// broadcast row, whose nb rows are read once from HBM and then from cache)
// and writes 32, and costs 2 * 64 32x32->64 multiply-adds plus carry handling
// (~500 issued instructions). At 3.35 TB/s that is ~35 G products/s of memory
// traffic against ~65 G products/s of issue across 132 SMs: the large
// launches sit near the memory/integer balance point, and the small ones
// (16k-33k products) on latency. So:
// - the whole CIOS stays in registers (one thread per product, no shared
//   memory), which is what the TPU kernel's VMEM residency bought;
// - each element moves as two 16-byte vectors (the wrapper checks 16-byte
//   alignment), four times fewer load instructions than eight 4-byte loads;
// - a broadcast operand is indexed, never materialised: the copy a caller
//   would make first writes and reads 32 bytes per product more;
// - the block shrinks from 256 threads to as few as 32 until the launch has a
//   block for every SM, so that 16k products run on all 132 SMs, not 64.
#include <cuda_runtime.h>

#include "field.cuh"

template <int MODE>
__global__ void h2r_mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                    uint32_t* __restrict__ out, long long n, unsigned step,
                                    FieldP f) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // MODE 1: step = nb (rows of b); MODE 2: step = n / nb (products per row)
  const long long j = MODE == 0 ? i : MODE == 1 ? (long long)((unsigned)i % step)
                                                : (long long)((unsigned)i / step);
  uint32_t x[H2R_LIMBS], y[H2R_LIMBS], r[H2R_LIMBS];
  fe_load16(a, i, x);
  fe_load16(b, j, y);
  fe_mul(x, y, r, f);
  fe_store16(out, i, r);
}

// threads per block: 256, halved (down to a warp) while the launch would have
// fewer blocks than the card has SMs
static int block_threads(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  int threads = 256;
  while (threads > 32 && (n + threads - 1) / threads < sms) threads >>= 1;
  return threads;
}

extern "C" int h2r_mont_mul_threads(long long n) { return block_threads(n); }

// mode 0: b has n elements; 1: b has nb, b[i % nb]; 2: b has nb, b[i / (n / nb)]
// (modes 1 and 2 need n < 2^32 and nb dividing n; the wrapper checks)
extern "C" int h2r_mont_mul(const void* a, const void* b, void* out, long long n, long long nb,
                            int mode, const uint32_t* p_host, uint32_t n0inv, void* stream) {
  if (n <= 0) return 0;
  if (mode != 0 && (nb <= 0 || n % nb != 0 || n >= (1ll << 32))) return (int)cudaErrorInvalidValue;
  FieldP f;
  for (int j = 0; j < H2R_LIMBS; ++j) f.p[j] = p_host[j];
  f.n0inv = n0inv;
  const int threads = block_threads(n);
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  if (mode == 0) {
    h2r_mont_mul_kernel<0><<<blocks, threads, 0, s>>>(pa, pb, po, n, 0u, f);
  } else if (mode == 1) {
    h2r_mont_mul_kernel<1><<<blocks, threads, 0, s>>>(pa, pb, po, n, (unsigned)nb, f);
  } else if (mode == 2) {
    h2r_mont_mul_kernel<2><<<blocks, threads, 0, s>>>(pa, pb, po, n, (unsigned)(n / nb), f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K1-prefix: the inclusive prefix product along axis -2 of a contiguous
// (rows, n, 8) tensor of field elements in Montgomery form (R = 2^256), or
// the suffix product (out[i] = vals[i] * ... * vals[n-1]) when reverse is
// set. Every output is canonical.
//
// Replaces the TPU's prefix product on K1
// (halo2_rsa_tpu/fields/pallas_mont.py:_mont_mul_kernel_body): the JAX
// package's vecfield._hs_scan is one fori_loop of ceil(log2 n) Hillis-Steele
// steps, n products each, inside one compiled loop. Eagerly, that is a K1
// launch per step plus a copy to shift the row; here a row takes at most
// three launches and about 3n products:
//   1. h2r_mont_scan_reduce_kernel: each block takes one tile of one row
//      (SCAN_TILE = 512 elements: 128 threads x a run of 4 consecutive
//      elements) and writes its product to the scratch tensor of tile totals;
//   2. h2r_mont_scan_rows_kernel: one block per row scans that row's tile
//      totals in place, a tile of totals at a time with the running product
//      carried from one to the next;
//   3. h2r_mont_scan_tiles_kernel: each block scans its tile again, starting
//      from the product of the tiles before it (the scanned total of the
//      previous tile), and writes every prefix.
// A row of at most SCAN_TILE elements is pass 3 alone, one launch. Inside a
// tile, each thread multiplies its run in registers, the block scans the
// runs' products (warp shuffles, then the four warps' totals through shared
// memory), and each thread walks its run again from its exclusive prefix.
//
// The order of the products is free: each Montgomery product returns the
// unique canonical residue of the product of its inputs, so any grouping of
// a prefix product gives the bits of the reference's Hillis-Steele pairs
// (unlike the G1 scans of g1_rows.cu, whose projective coordinates depend on
// the pairs). A thread past the end of its row holds 1 (R mod p), which
// multiplies nothing away.
//
// What bounds it on an H100: 64 bytes per element (read once, written once)
// against ~n - 1 products of ~500 instructions each; a prefix product is
// issue-bound at every size the prover scans (3 to ~2^21 elements, one or a
// few rows per call). The tile of 512 gives the flagship's rows of 2^15 + 4
// elements 65 blocks per pass and its rows of 2^18 (and the batch inversion's
// ~6 x 2^15) several blocks per SM, while a single tile covers the short rows
// (evaluation powers, fold weights) in one launch. Elements move as two
// 16-byte vectors (the wrapper checks the alignment).
#include <cuda_runtime.h>

#include "field.cuh"

#define SCAN_THREADS 128
#define SCAN_RUN 4
#define SCAN_TILE (SCAN_THREADS * SCAN_RUN)
#define SCAN_WARPS (SCAN_THREADS / 32)

__device__ __forceinline__ void fe_copy(uint32_t d[H2R_LIMBS], const uint32_t s[H2R_LIMBS]) {
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) d[j] = s[j];
}

// acc = acc * v, or acc = v when acc holds nothing yet
__device__ __forceinline__ void fe_mul_into(uint32_t acc[H2R_LIMBS], bool& has,
                                            const uint32_t v[H2R_LIMBS], const FieldP& f) {
  if (has) {
    fe_mul(acc, v, acc, f);
  } else {
    fe_copy(acc, v);
    has = true;
  }
}

// One tile of one row: the logical elements [lo, hi) (hi - lo <= SCAN_TILE)
// of a row of n, logical element k at n - 1 - k when reverse. ``carry`` is the
// product of the logical elements before lo (``has_carry`` false: none).
// With ``out``, every element's inclusive prefix (times carry) is written.
// The tile's total (times carry) lands in ``total`` of the block's last
// thread. Every thread of the block must call it (one barrier inside).
__device__ void scan_tile(const uint32_t* in, uint32_t* out, long long n, bool reverse,
                          long long lo, long long hi, const uint32_t carry[H2R_LIMBS],
                          bool has_carry, uint32_t total[H2R_LIMBS],
                          uint32_t (*sm)[H2R_LIMBS], const FieldP& f) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long k0 = lo + (long long)t * SCAN_RUN;
  const int cnt = (int)max(0ll, min((long long)SCAN_RUN, hi - k0));
  // the product of this thread's run
  uint32_t x[H2R_LIMBS];
  if (cnt > 0) {
    fe_load16(in, reverse ? n - 1 - k0 : k0, x);
    for (int k = 1; k < cnt; ++k) {
      uint32_t v[H2R_LIMBS];
      fe_load16(in, reverse ? n - 1 - (k0 + k) : k0 + k, v);
      fe_mul(x, v, x, f);
    }
  } else {
    fe_mont_one(x, f);
  }
  // inclusive scan of the runs' products within the warp
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t y[H2R_LIMBS];
#pragma unroll
    for (int j = 0; j < H2R_LIMBS; ++j) y[j] = __shfl_up_sync(0xffffffffu, x[j], d);
    if (lane >= d) fe_mul(y, x, x, f);
  }
  uint32_t e[H2R_LIMBS];  // the previous lane's inclusive product
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) e[j] = __shfl_up_sync(0xffffffffu, x[j], 1);
  if (lane == 31) fe_copy(sm[w], x);
  __syncthreads();
  // carry times the totals of the warps before this one
  uint32_t pre[H2R_LIMBS];
  bool has = has_carry;
  if (has) fe_copy(pre, carry);
  for (int u = 0; u < w; ++u) fe_mul_into(pre, has, sm[u], f);
  if (t == SCAN_THREADS - 1) {
    fe_copy(total, x);
    if (has) fe_mul(pre, x, total, f);
  }
  if (out == nullptr) return;
  if (lane > 0) fe_mul_into(pre, has, e, f);
  for (int k = 0; k < cnt; ++k) {
    const long long i = reverse ? n - 1 - (k0 + k) : k0 + k;
    uint32_t v[H2R_LIMBS];
    fe_load16(in, i, v);
    fe_mul_into(pre, has, v, f);
    fe_store16(out, i, pre);
  }
}

// pass 1: the product of each tile -> totals[row * tiles + tile]
__global__ void __launch_bounds__(SCAN_THREADS)
h2r_mont_scan_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ totals,
                            long long n, long long tiles, int reverse, FieldP f) {
  __shared__ uint32_t sm[SCAN_WARPS][H2R_LIMBS];
  const long long row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long lo = tile * SCAN_TILE;
  uint32_t none[H2R_LIMBS], total[H2R_LIMBS];
  scan_tile(in + row * n * H2R_LIMBS, nullptr, n, reverse != 0, lo, min(n, lo + SCAN_TILE), none,
            false, total, sm, f);
  if (threadIdx.x == SCAN_THREADS - 1) fe_store16(totals, blockIdx.x, total);
}

// pass 2: each row of n scanned by one block, a tile at a time (in place
// allowed: a thread reads each of its elements before it writes it)
__global__ void __launch_bounds__(SCAN_THREADS)
h2r_mont_scan_rows_kernel(const uint32_t* in, uint32_t* out, long long n, FieldP f) {
  __shared__ uint32_t sm[SCAN_WARPS + 1][H2R_LIMBS];
  const long long off = (long long)blockIdx.x * n * H2R_LIMBS;
  uint32_t carry[H2R_LIMBS], total[H2R_LIMBS];
  bool has_carry = false;
  for (long long lo = 0; lo < n; lo += SCAN_TILE) {
    scan_tile(in + off, out + off, n, false, lo, min(n, lo + SCAN_TILE), carry, has_carry, total,
              sm, f);
    if (threadIdx.x == SCAN_THREADS - 1) fe_copy(sm[SCAN_WARPS], total);
    __syncthreads();
    fe_copy(carry, sm[SCAN_WARPS]);
    has_carry = true;
  }
}

// pass 3 (alone for a row of one tile): each tile scanned from the scanned
// total of the tile before it
__global__ void __launch_bounds__(SCAN_THREADS)
h2r_mont_scan_tiles_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                           long long n, long long tiles, int reverse,
                           const uint32_t* __restrict__ totals, FieldP f) {
  __shared__ uint32_t sm[SCAN_WARPS][H2R_LIMBS];
  const long long row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long lo = tile * SCAN_TILE;
  uint32_t carry[H2R_LIMBS], total[H2R_LIMBS];
  if (tile > 0) fe_load16(totals, blockIdx.x - 1, carry);
  const long long off = row * n * H2R_LIMBS;
  scan_tile(in + off, out + off, n, reverse != 0, lo, min(n, lo + SCAN_TILE), carry, tile > 0,
            total, sm, f);
}

extern "C" int h2r_mont_prefix_tile() { return SCAN_TILE; }

// scratch: rows x ceil(n / SCAN_TILE) elements (unused, may be null, when a
// row fits in one tile)
extern "C" int h2r_mont_prefix(const void* vals, void* out, long long rows, long long n,
                               int reverse, void* scratch, const uint32_t* p_host, uint32_t n0inv,
                               void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  FieldP f;
  for (int j = 0; j < H2R_LIMBS; ++j) f.p[j] = p_host[j];
  f.n0inv = n0inv;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* in = (const uint32_t*)vals;
  uint32_t* dst = (uint32_t*)out;
  uint32_t* totals = (uint32_t*)scratch;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (tiles > 1) {
    if (totals == nullptr) return (int)cudaErrorInvalidValue;
    h2r_mont_scan_reduce_kernel<<<(unsigned)(rows * tiles), SCAN_THREADS, 0, s>>>(
        in, totals, n, tiles, reverse, f);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    h2r_mont_scan_rows_kernel<<<(unsigned)rows, SCAN_THREADS, 0, s>>>(totals, totals, tiles, f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  h2r_mont_scan_tiles_kernel<<<(unsigned)(rows * tiles), SCAN_THREADS, 0, s>>>(
      in, dst, n, tiles, reverse, totals, f);
  return (int)cudaGetLastError();
}

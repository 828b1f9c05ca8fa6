// K3's bucket-boundary splice: the MSM's bucket sums from its chunked prefix
// scan, one thread per (row, bucket), in one launch. The adds are K3's
// (RCB15 algorithm 7, add_lazy in g1_lazy.cuh); replaces the three rounds of
// halo2_rsa_tpu/prover/pallas_g1.py:_point_add_kernel, and the gathers,
// selects and negation around them, that the JAX package's msm._bucket_sums
// makes for its gather_pts(ends), gather_pts(prev) and their difference.
//
// Row w holds `within` (npad points: the inclusive scan inside each chunk
// of c points) and `incl` (nchunks points: the inclusive scan of the chunk
// totals). The prefix through element i is P(i) = within[i] + excl[i / c],
// where excl[0] is the identity and excl[k] = incl[k - 1], and P(-1) is the
// identity. Bucket b's sum is P(ends[b]) + (-P(ends[b - 1])), ends[-1] = -1,
// in the reference's operand order. The add of excl[0], the identity, runs
// as in the reference (its projective result is not within[i] itself), so
// each stored value, canonicalised once at its store, equals the plain
// version's bit for bit.
//
// What bounds it on an H100: three adds per thread (thousands of
// instructions each, mostly IMAD.WIDE.U32.X on the FMA pipe) against 5
// points read and 1 written, so operations; the reads are gathers of 32-byte
// coordinates at data-dependent places.
#include <cuda_runtime.h>

#include "g1_lazy.cuh"

// P(i) of one row as above, in [0, 2q).
__device__ __forceinline__ void prefix_at(const uint32_t* __restrict__ wx,
                                          const uint32_t* __restrict__ wy,
                                          const uint32_t* __restrict__ wz,
                                          const uint32_t* __restrict__ ix,
                                          const uint32_t* __restrict__ iy,
                                          const uint32_t* __restrict__ iz, long long i, int c,
                                          uint32_t x[fq::N], uint32_t y[fq::N],
                                          uint32_t z[fq::N]) {
  if (i < 0) {
    set_identity(x, y, z);
    return;
  }
  load8(wx, i, x);
  load8(wy, i, y);
  load8(wz, i, z);
  uint32_t ex[fq::N], ey[fq::N], ez[fq::N];
  const long long k = i / c;
  if (k == 0) {
    set_identity(ex, ey, ez);
  } else {
    load8(ix, k - 1, ex);
    load8(iy, k - 1, ey);
    load8(iz, k - 1, ez);
  }
  add_lazy(x, y, z, ex, ey, ez);
}

// within (rows, npad, 8), incl (rows, nchunks, 8) per coordinate, ends
// (rows, buckets) int64 in [-1, npad); out (rows, buckets, 8).
__global__ void h2r_g1_bucket_splice_kernel(
    const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
    const uint32_t* __restrict__ wz, const uint32_t* __restrict__ ix,
    const uint32_t* __restrict__ iy, const uint32_t* __restrict__ iz,
    const long long* __restrict__ ends, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, long long rows, int buckets, long long npad, long long nchunks,
    int c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * buckets) return;
  const long long row = t / buckets, w0 = row * npad, i0 = row * nchunks;
  const int b = (int)(t - row * buckets);
  uint32_t x[fq::N], y[fq::N], z[fq::N], px[fq::N], py[fq::N], pz[fq::N];
  prefix_at(wx + 8 * w0, wy + 8 * w0, wz + 8 * w0, ix + 8 * i0, iy + 8 * i0, iz + 8 * i0,
            ends[t], c, x, y, z);
  prefix_at(wx + 8 * w0, wy + 8 * w0, wz + 8 * w0, ix + 8 * i0, iy + 8 * i0, iz + 8 * i0,
            b ? ends[t - 1] : -1, c, px, py, pz);
  uint32_t zero[fq::N] = {0, 0, 0, 0, 0, 0, 0, 0};
  fq::sub(zero, py, py);  // -P: in [0, 2q) for py in [0, 2q)
  add_lazy(x, y, z, px, py, pz);
  store8_canon(ox, t, x);
  store8_canon(oy, t, y);
  store8_canon(oz, t, z);
}

// The wrapper (cuda_g1.bucket_splice) refuses any field but BN254 Fq, whose
// constants the kernel has built in, and checks the shapes.
extern "C" int h2r_g1_bucket_splice(const void* wx, const void* wy, const void* wz,
                                    const void* ix, const void* iy, const void* iz,
                                    const void* ends, void* ox, void* oy, void* oz,
                                    long long rows, int buckets, long long npad,
                                    long long nchunks, int c, void* stream) {
  if (rows <= 0 || buckets <= 0) return 0;
  if (c < 1 || npad < 1 || nchunks < 1) return (int)cudaErrorInvalidValue;
  constexpr int threads = 128;
  const long long n = rows * buckets;
  h2r_g1_bucket_splice_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                                (cudaStream_t)stream>>>(
      (const uint32_t*)wx, (const uint32_t*)wy, (const uint32_t*)wz, (const uint32_t*)ix,
      (const uint32_t*)iy, (const uint32_t*)iz, (const long long*)ends, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, rows, buckets, npad, nchunks, c);
  return (int)cudaGetLastError();
}

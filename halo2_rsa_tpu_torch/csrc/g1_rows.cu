// K3's row scans: the MSM's Hillis-Steele prefix scans of BN254 G1 points,
// and the suffix scan with its halving tree, each in one launch. The add is
// K3's (RCB15 algorithm 7, add_lazy in g1_lazy.cuh); replaces the rounds of
// halo2_rsa_tpu/prover/pallas_g1.py:_point_add_kernel that the JAX package's
// msm._hs_point_scan and msm._bucket_reduce launch one by one.
//
// A row of len <= 512 points (rows, len, 8 limbs per coordinate) is owned by
// one block, or by a cluster of k = 2, 4 or 8 blocks that read each other's
// shared memory. Thread i owns element i and keeps its running value in
// registers, in [0, 2q). Each round it publishes that value to shared memory;
// after a barrier the active threads read their partner's, and after a second
// barrier they add it:
//   * scan round d = 1, 2, 4, ... < len: element i >= d adds element i - d
//     (acc_i + acc_{i-d}, the operand order of msm._hs_point_scan), the others
//     keep their value (its point_select);
//   * with tree != 0, the scan is padded with the identity (0 : 1 : 0) to
//     msize = the next power of two >= max(len, 2), and each halving round
//     adds acc_i + acc_{i+half} for i < half (msm._bucket_reduce), down to
//     element 0.
// These are the plain version's pairs in its order, so every stored value,
// canonicalised once at its store, equals the plain version's bit for bit (a
// work-efficient scan would associate differently and change the projective
// coordinates, and with them the proof's bytes).
//
// What bounds it on an H100: the adds, thousands of instructions each, mostly
// IMAD.WIDE.U32.X on the FMA pipe; a scan over 512 points makes 4,097 of them
// in 9 dependent rounds, so a row is one thread's add latency per round when
// its SMs are not full. The design keeps values in registers and shared
// memory across rounds (no launch, global write, gather or select between
// them), and a cluster spreads a row over k SMs where the rows alone would
// leave most of the 132 SMs idle.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "g1_lazy.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxLen = 512;

// A block's slice of a row in shared memory: half h of coordinate c of
// element e at s[(2 c + h) T + e], so that a warp's 16-byte accesses are
// contiguous.
__device__ __forceinline__ void put8(uint4* s, int lo, int hi, const uint32_t a[fq::N]) {
  s[lo] = make_uint4(a[0], a[1], a[2], a[3]);
  s[hi] = make_uint4(a[4], a[5], a[6], a[7]);
}

__device__ __forceinline__ void get8(const uint4* s, int lo, int hi, uint32_t a[fq::N]) {
  uint4 p = s[lo], q = s[hi];
  a[0] = p.x, a[1] = p.y, a[2] = p.z, a[3] = p.w, a[4] = q.x, a[5] = q.y, a[6] = q.z, a[7] = q.w;
}

template <int CLUSTERED>
__device__ __forceinline__ void row_sync() {
  if constexpr (CLUSTERED) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// One round: publish (x, y, z); if active, read element j of the row (held
// by block j / T of the cluster) and add it: (x, y, z) += element j.
template <int CLUSTERED>
__device__ __forceinline__ void round_add(uint4* smem, int T, int t, uint32_t x[fq::N],
                                          uint32_t y[fq::N], uint32_t z[fq::N], bool active,
                                          int j) {
  put8(smem, t, T + t, x);
  put8(smem, 2 * T + t, 3 * T + t, y);
  put8(smem, 4 * T + t, 5 * T + t, z);
  row_sync<CLUSTERED>();
  uint32_t px[fq::N], py[fq::N], pz[fq::N];
  if (active) {
    const uint4* s = smem;
    const int owner = j / T, e = j - owner * T;
    if constexpr (CLUSTERED) s = cg::this_cluster().map_shared_rank(smem, (unsigned)owner);
    get8(s, e, T + e, px);
    get8(s, 2 * T + e, 3 * T + e, py);
    get8(s, 4 * T + e, 5 * T + e, pz);
  }
  row_sync<CLUSTERED>();  // every read is done before the next round publishes
  if (active) add_lazy(x, y, z, px, py, pz);
}

// Rows (rows, len, 8) per coordinate in; out (rows, len, 8) when msize == 0,
// else (rows, 8): the halving tree's element 0 over msize elements.
template <int CLUSTERED>
__global__ void __launch_bounds__(kMaxLen, 1)
    h2r_g1_scan_rows_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                            const uint32_t* __restrict__ zp, uint32_t* __restrict__ xo,
                            uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int len,
                            int msize) {
  extern __shared__ uint4 smem[];
  const int T = blockDim.x, t = threadIdx.x;
  int rank = 0, k = 1;
  if constexpr (CLUSTERED) {
    cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    k = (int)cl.num_blocks();
  }
  const long long row = blockIdx.x / k;
  const int i = rank * T + t;
  uint32_t x[fq::N], y[fq::N], z[fq::N];
  if (i < len) {
    load8(xp, row * len + i, x);
    load8(yp, row * len + i, y);
    load8(zp, row * len + i, z);
  } else {
    set_identity(x, y, z);
  }
#pragma unroll 1
  for (int d = 1; d < len; d <<= 1)
    round_add<CLUSTERED>(smem, T, t, x, y, z, i >= d && i < len, i - d);
  if (msize == 0) {
    if (i < len) {
      store8_canon(xo, row * len + i, x);
      store8_canon(yo, row * len + i, y);
      store8_canon(zo, row * len + i, z);
    }
    return;
  }
#pragma unroll 1
  for (int half = msize >> 1; half >= 1; half >>= 1)
    round_add<CLUSTERED>(smem, T, t, x, y, z, i < half, i + half);
  if (i == 0) {
    store8_canon(xo, row, x);
    store8_canon(yo, row, y);
    store8_canon(zo, row, z);
  }
}

// The wrappers (cuda_g1.point_scan, point_scan_sum) refuse any field but
// BN254 Fq, whose constants the kernel has built in, and len > 512.
extern "C" int h2r_g1_scan_rows(const void* x, const void* y, const void* z, void* xo, void* yo,
                                void* zo, long long rows, int len, int tree, int cluster,
                                void* stream) {
  if (rows <= 0) return 0;
  if (len < 1 || len > kMaxLen || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
  int msize = 0;
  if (tree) {
    msize = 2;
    while (msize < len) msize <<= 1;
  }
  const int span = tree ? msize : len;
  const int threads = (span + cluster - 1) / cluster;
  const size_t smem = 6 * sizeof(uint4) * threads;  // 48 KiB at 512 threads
  const uint32_t* in[3] = {(const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z};
  uint32_t* out[3] = {(uint32_t*)xo, (uint32_t*)yo, (uint32_t*)zo};
  if (cluster == 1) {
    h2r_g1_scan_rows_kernel<0><<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
        in[0], in[1], in[2], out[0], out[1], out[2], len, msize);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void (*kernel)(const uint32_t*, const uint32_t*, const uint32_t*, uint32_t*, uint32_t*,
                 uint32_t*, int, int) = h2r_g1_scan_rows_kernel<1>;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, in[0], in[1], in[2], out[0], out[1], out[2],
                                       len, msize);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

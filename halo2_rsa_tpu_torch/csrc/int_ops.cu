// P1: sustained integer issue rate of K1's op mix, out[i] = body(x[i], y[i]).
//
// Replaces the Pallas probe of scripts/bench_vpu_ops.py (_mk, bodies
// body_mul .. body_split_ilp): seven chains of uint32 operations, REPS deep,
// with 2^32 wraparound, over a flat (16 * N) array, one thread per lane.
// Each body computes exactly the script's function, bit for bit.
//
// What bounds it on an H100: each lane reads 8 bytes and writes 4, and runs
// REPS to 6 * REPS dependent integer operations, so at REPS = 64 the integer
// pipes, not memory, set the time. That is the point of the probe: its rate
// is the compute side of K1-K4's bounds.
//
// The trap is the compiler. x = x + y repeated REPS times folds to
// x + REPS * y, four chains of a = a * y share the powers of y, and the split
// bodies hold loop-invariant products that would be hoisted. `asm volatile`
// PTX keeps NVVM from merging, hoisting or dropping a step, but ptxas (PTX to
// SASS) still reassociates: with asm alone, 64 muls in four chains became 31
// integer instructions and 64 adds 35 three-input IADD3s (measured on an
// H100). So each step also takes its own operand z[r] from the kernel's
// parameters, which the launcher fills with zeros: x * y + z[r] is one IMAD
// and x + y + z[r] one IADD3, the function is unchanged, and no two steps can
// be merged or hoisted because neither compiler knows z. REPS is a template
// argument so the chains unroll completely; the built library's SASS is read
// on the card to count each body's integer instructions (ptxas may still
// fuse a shift and an add into one LEA.HI, a mask and an add into an IADD3
// fed by a LOP3).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t op_mul(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t op_mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t op_add(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a + b + z, z = 0 at run time: one IADD3 that no neighbouring step can join
__device__ __forceinline__ uint32_t op_add3(uint32_t a, uint32_t b, uint32_t z) {
  uint32_t r;
  asm volatile("add.u32 %0, %1, %2;\n\tadd.u32 %0, %0, %3;" : "=&r"(r) : "r"(a), "r"(b), "r"(z));
  return r;
}

__device__ __forceinline__ uint32_t op_lo16(uint32_t a) {
  uint32_t r;
  asm volatile("and.b32 %0, %1, 65535;" : "=r"(r) : "r"(a));
  return r;
}

__device__ __forceinline__ uint32_t op_hi16(uint32_t a) {
  uint32_t r;
  asm volatile("shr.u32 %0, %1, 16;" : "=r"(r) : "r"(a));
  return r;
}

// Body ids, in the order of the script's table (bench_vpu_ops.py:141-149).
enum Body { kMul = 0, kMad, kSplit, kAdd, kMulIlp4, kAddIlp4, kSplitIlp2 };

constexpr int kMaxReps = 64;

// One opaque zero per step (see the note at the top), passed by value so it
// lives in the constant bank and costs no instruction to read.
struct Zeros {
  uint32_t z[kMaxReps];
};

template <int BODY, int REPS>
__device__ __forceinline__ uint32_t body(uint32_t x, uint32_t y, const Zeros& zs) {
  static_assert(REPS <= kMaxReps, "one zero per step");
  if constexpr (BODY == kMul) {
#pragma unroll
    for (int r = 0; r < REPS; ++r) x = op_mad(x, y, zs.z[r]);
    return x;
  } else if constexpr (BODY == kMad) {
#pragma unroll
    for (int r = 0; r < REPS; ++r) x = op_mad(x, y, y);
    return x;
  } else if constexpr (BODY == kSplit) {
    uint32_t t = 0, u = 0;
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
      uint32_t p = op_mad(x, y, zs.z[r]);
      t = op_add(t, op_lo16(p));
      u = op_add(u, op_hi16(p));
      x = op_add(x, u);
    }
    return op_add(t, x);
  } else if constexpr (BODY == kAdd) {
#pragma unroll
    for (int r = 0; r < REPS; ++r) x = op_add3(x, y, zs.z[r]);
    return x;
  } else if constexpr (BODY == kMulIlp4 || BODY == kAddIlp4) {
    uint32_t a = x, b = op_add(x, y), c = op_add(op_add(x, y), y), d = op_mul(x, y);
#pragma unroll
    for (int r = 0; r < REPS / 4; ++r) {
      const uint32_t* z = zs.z + 4 * r;
      if constexpr (BODY == kMulIlp4) {
        a = op_mad(a, y, z[0]);
        b = op_mad(b, y, z[1]);
        c = op_mad(c, y, z[2]);
        d = op_mad(d, y, z[3]);
      } else {
        a = op_add3(a, y, z[0]);
        b = op_add3(b, y, z[1]);
        c = op_add3(c, y, z[2]);
        d = op_add3(d, y, z[3]);
      }
    }
    return op_add(op_add(op_add(a, b), c), d);
  } else {  // kSplitIlp2
    uint32_t t0 = 0, u0 = 0, t1 = op_add(x, y), u1 = op_mul(x, y);
#pragma unroll
    for (int r = 0; r < REPS / 2; ++r) {
      uint32_t p0 = op_mad(x, y, zs.z[2 * r]);  // x * y, not hoisted out of the chain
      t0 = op_add(t0, op_lo16(p0));
      u0 = op_add(u0, op_hi16(p0));
      uint32_t p1 = op_mad(op_add(x, u0), y, zs.z[2 * r + 1]);
      t1 = op_add(t1, op_lo16(p1));
      u1 = op_add(u1, op_hi16(p1));
    }
    return op_add(op_add(t0, t1), u1);
  }
}

template <int BODY, int REPS>
__global__ void h2r_int_ops_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                                   uint32_t* __restrict__ out, long long n, const Zeros zs) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = body<BODY, REPS>(x[i], y[i], zs);
}

template <int REPS>
cudaError_t launch_reps(int body_id, const uint32_t* x, const uint32_t* y, uint32_t* out,
                        long long n, cudaStream_t s) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const Zeros zs = {};
  switch (body_id) {
    case kMul: h2r_int_ops_kernel<kMul, REPS><<<blocks, threads, 0, s>>>(x, y, out, n, zs); break;
    case kMad: h2r_int_ops_kernel<kMad, REPS><<<blocks, threads, 0, s>>>(x, y, out, n, zs); break;
    case kSplit:
      h2r_int_ops_kernel<kSplit, REPS><<<blocks, threads, 0, s>>>(x, y, out, n, zs);
      break;
    case kAdd: h2r_int_ops_kernel<kAdd, REPS><<<blocks, threads, 0, s>>>(x, y, out, n, zs); break;
    case kMulIlp4:
      h2r_int_ops_kernel<kMulIlp4, REPS><<<blocks, threads, 0, s>>>(x, y, out, n, zs);
      break;
    case kAddIlp4:
      h2r_int_ops_kernel<kAddIlp4, REPS><<<blocks, threads, 0, s>>>(x, y, out, n, zs);
      break;
    case kSplitIlp2:
      h2r_int_ops_kernel<kSplitIlp2, REPS><<<blocks, threads, 0, s>>>(x, y, out, n, zs);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The REPS values built (the wrapper's REPS_BUILT): any other is refused.
extern "C" int h2r_int_ops(int body_id, int reps, const void* x, const void* y, void* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  auto xs = (const uint32_t*)x;
  auto ys = (const uint32_t*)y;
  auto o = (uint32_t*)out;
  auto s = (cudaStream_t)stream;
  switch (reps) {
    case 8: return (int)launch_reps<8>(body_id, xs, ys, o, n, s);
    case 64: return (int)launch_reps<64>(body_id, xs, ys, o, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

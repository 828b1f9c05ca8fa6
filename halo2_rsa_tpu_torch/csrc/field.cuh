// Shared __device__ field arithmetic over 8 x 32-bit little-endian limbs.
//
// Counterparts of the row helpers of halo2_rsa_tpu/fields/pallas_mont.py
// (_cios_rows, _add_rows, _sub_rows, _cond_sub_rows, _carry_rows) and of
// _mul9_rows in halo2_rsa_tpu/prover/pallas_g1.py. The TPU helpers work on
// 16 x 16-bit limbs because the TPU's vector unit has no 64-bit product;
// Hopper multiplies 32 x 32 -> 64 natively, so here a field element is 8
// limbs held in registers and every carry chain is 8 steps long.
//
// Contract (as on the TPU): every input and output is canonical (< p), in
// Montgomery form with R = 2^256. p < 2^255 is required (BN254 Fr/Fq and the
// Pasta fields all are), so sums of two canonical values fit in 256 bits
// plus one carry bit.
#pragma once

#include <cstdint>

#define H2R_LIMBS 8

struct FieldP {
  uint32_t p[H2R_LIMBS];
  uint32_t n0inv;  // -p^-1 mod 2^32
};

__device__ __forceinline__ void fe_load(const uint32_t* __restrict__ src, long long i,
                                        uint32_t r[H2R_LIMBS]) {
  const uint32_t* s = src + i * H2R_LIMBS;
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) r[j] = s[j];
}

__device__ __forceinline__ void fe_store(uint32_t* __restrict__ dst, long long i,
                                         const uint32_t r[H2R_LIMBS]) {
  uint32_t* d = dst + i * H2R_LIMBS;
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) d[j] = r[j];
}

// t + hi * 2^256 < 2p  ->  (t + hi * 2^256) mod p, in place.
__device__ __forceinline__ void fe_cond_sub(uint32_t t[H2R_LIMBS], uint32_t hi,
                                            const FieldP& f) {
  uint32_t d[H2R_LIMBS];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) {
    uint64_t s = (uint64_t)t[j] - (uint64_t)f.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  bool ge = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) t[j] = ge ? d[j] : t[j];
}

__device__ __forceinline__ void fe_add(const uint32_t a[H2R_LIMBS], const uint32_t b[H2R_LIMBS],
                                       uint32_t r[H2R_LIMBS], const FieldP& f) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) {
    uint64_t s = (uint64_t)a[j] + b[j] + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
  fe_cond_sub(r, (uint32_t)c, f);
}

__device__ __forceinline__ void fe_sub(const uint32_t a[H2R_LIMBS], const uint32_t b[H2R_LIMBS],
                                       uint32_t r[H2R_LIMBS], const FieldP& f) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) {
    uint64_t s = (uint64_t)a[j] - (uint64_t)b[j] - borrow;
    r[j] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  // a < b: add p back (mod 2^256)
  uint32_t mask = 0u - (uint32_t)borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) {
    uint64_t s = (uint64_t)r[j] + (f.p[j] & mask) + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
}

// Montgomery product a * b * 2^-256 mod p: CIOS over 32-bit limbs with
// 64-bit accumulators (each t + a_i * b_j + carry < 2^64), then one
// conditional subtract. Safe when r aliases a or b.
__device__ __forceinline__ void fe_mul(const uint32_t a[H2R_LIMBS], const uint32_t b[H2R_LIMBS],
                                       uint32_t r[H2R_LIMBS], const FieldP& f) {
  uint32_t t[H2R_LIMBS + 2];
#pragma unroll
  for (int j = 0; j < H2R_LIMBS + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < H2R_LIMBS; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < H2R_LIMBS; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a[i] * b[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[H2R_LIMBS] + c;
    t[H2R_LIMBS] = (uint32_t)s;
    t[H2R_LIMBS + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * f.n0inv;
    s = (uint64_t)t[0] + (uint64_t)m * f.p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < H2R_LIMBS; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * f.p[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[H2R_LIMBS] + c;
    t[H2R_LIMBS - 1] = (uint32_t)s;
    t[H2R_LIMBS] = t[H2R_LIMBS + 1] + (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < H2R_LIMBS; ++j) r[j] = t[j];
  fe_cond_sub(r, t[H2R_LIMBS], f);
}

// 9 * a by adds (b3 = 3 * b = 9 on BN254 G1, y^2 = x^3 + 3).
__device__ __forceinline__ void fe_mul9(const uint32_t a[H2R_LIMBS], uint32_t r[H2R_LIMBS],
                                        const FieldP& f) {
  uint32_t d[H2R_LIMBS];
  fe_add(a, a, d, f);  // 2a
  fe_add(d, d, d, f);  // 4a
  fe_add(d, d, d, f);  // 8a
  fe_add(d, a, r, f);
}

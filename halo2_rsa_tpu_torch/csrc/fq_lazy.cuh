// Lazy-reduced BN254 Fq arithmetic over 8 x 32-bit little-endian limbs, for
// the G1 kernels only: K4 (g1_double.cu), K2 (g1_scan.cu) and K3 (g1.cu,
// g1_rows.cu, through g1_lazy.cuh). Values are in Montgomery form (R = 2^256) like
// field.cuh's, but between steps they live in [0, 2q) instead of [0, q), and
// every carry chain is one PTX add.cc/addc, sub.cc/subc or mad.lo.cc/madc.hi.cc
// chain on 32-bit limbs (the carry flag), one asm statement each, instead of
// 64-bit emulation.
//
// Headroom: q < 2^254 (2^256 / q = 5.29), so
//   * a + b < 4q < 2^256 for a, b < 2q: a sum has no carry out, and one
//     conditional subtract of 2q brings it back below 2q;
//   * a Montgomery product of a, b < 2q is (ab + mq) / R < (4q^2 + Rq) / R
//     < 2q because 4q < R, so it needs no final subtract; inside the CIOS
//     loop the running sum stays below 3q + 3q * 2^32 < 2^288, so 9 limbs
//     hold it, and every carry out of limb 8 that a chain drops is zero;
//   * c * a for a < 2q and c <= 9 is below 18q < 2^258; its quotient by q is
//     estimated from bits 226..257 (one multiply-high by a reciprocal), the
//     estimate is never above the true quotient and at most one below, so
//     subtracting it times q lands in [0, 2q) (reduce_small).
// canon() brings a value in [0, 2q) to [0, q) once, before the store.
#pragma once

#include <cstdint>

namespace fq {

constexpr int N = 8;
constexpr uint32_t N0INV = 0xe4866389u;  // -q^-1 mod 2^32
// q >> 226 = 0x0c19139c; floor(2^59 / ((q >> 226) + 1))
constexpr uint32_t QTOP_RECIP = 0xa948e8c0u;

__device__ __forceinline__ uint32_t q(int j) {  // q, little-endian 32-bit limbs
  constexpr uint32_t k[N] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                             0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
  return k[j];
}
__device__ __forceinline__ uint32_t q2(int j) {  // 2q
  constexpr uint32_t k[N] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                             0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
  return k[j];
}
__device__ __forceinline__ uint32_t nq(int j) {  // 2^256 - q
  constexpr uint32_t k[N] = {0x278302b9u, 0xc3df73e9u, 0x978e3572u, 0x687e956eu,
                             0x7e7ea7a2u, 0x47afba49u, 0x1ece5fd6u, 0xcf9bb18du};
  return k[j];
}

// The Montgomery product keeps its running sum in two arrays (the even/odd
// layout of CIOS): `e` holds the products of the even limbs of a, whose low
// and high halves land on limbs (0, 1), (2, 3), ..., and `o` those of the odd
// limbs, one limb up. In each 8-step chain the low and high half of one
// product are neighbours, so ptxas issues each pair as one IMAD.WIDE.U32.X
// (carry in and out); with separate chains for the low and the high halves it
// issued an IMAD and an IADD3.X for every half. After each step the sum is
// divided by 2^32 by letting the arrays swap roles: `o` becomes the array
// that starts at limb 0, and `e`, whose entry 0 is spent, moves down two
// places (to start one limb up) as the next products of the odd limbs are
// added into it (eo_rshift).

// acc[0..7] += x0, x2, x4, x6 (times bi) at limb pairs (0, 1) .. (6, 7); the
// carry out is dropped (the callers' sums leave it zero).
__device__ __forceinline__ void eo_mad(uint32_t acc[N], uint32_t x0, uint32_t x2, uint32_t x4,
                                       uint32_t x6, uint32_t bi) {
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\tmadc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\tmadc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\tmadc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\tmadc.hi.u32 %7, %11, %12, %7;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7])
      : "r"(x0), "r"(x2), "r"(x4), "r"(x6), "r"(bi));
}

// eo_mad with the carry out added into top.
__device__ __forceinline__ void eo_mad_top(uint32_t acc[N], uint32_t& top, uint32_t x0,
                                           uint32_t x2, uint32_t x4, uint32_t x6, uint32_t bi) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\tmadc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\tmadc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\tmadc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\tmadc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
      : "r"(x0), "r"(x2), "r"(x4), "r"(x6), "r"(bi));
}

// acc = x0, x2, x4, x6 times bi at limb pairs (0, 1) .. (6, 7).
__device__ __forceinline__ void eo_mul(uint32_t acc[N], uint32_t x0, uint32_t x2, uint32_t x4,
                                       uint32_t x6, uint32_t bi) {
  asm("mul.lo.u32 %0, %8, %12;\n\tmul.hi.u32 %1, %8, %12;\n\t"
      "mul.lo.u32 %2, %9, %12;\n\tmul.hi.u32 %3, %9, %12;\n\t"
      "mul.lo.u32 %4, %10, %12;\n\tmul.hi.u32 %5, %10, %12;\n\t"
      "mul.lo.u32 %6, %11, %12;\n\tmul.hi.u32 %7, %11, %12;"
      : "=r"(acc[0]), "=r"(acc[1]), "=r"(acc[2]), "=r"(acc[3]), "=r"(acc[4]), "=r"(acc[5]),
        "=r"(acc[6]), "=r"(acc[7])
      : "r"(x0), "r"(x2), "r"(x4), "r"(x6), "r"(bi));
}

// e0 += o[1], carrying into o[0] = o[2] + lo(x1 bi), o[1] = o[3] + hi(x1 bi),
// ..., o[6..7] = x7 bi: o shifts down two limbs while the odd limbs' products
// are added. The top's carry out is dropped (the sum stays below 2^288).
__device__ __forceinline__ void eo_rshift(uint32_t& e0, uint32_t o[N], uint32_t x1, uint32_t x3,
                                          uint32_t x5, uint32_t x7, uint32_t bi) {
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\tmadc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\tmadc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\tmadc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, %14;\n\tmadc.hi.u32 %8, %12, %13, %14;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(x1), "r"(x3), "r"(x5), "r"(x7), "r"(bi), "r"(0u));
}

// Add m q with m = e[0] (-q^-1) mod 2^32, which clears e[0]. The odd chain's
// carry out is zero because the whole sum is below 2^288.
__device__ __forceinline__ void eo_reduce(uint32_t e[N], uint32_t o[N]) {
  uint32_t m = e[0] * N0INV;
  eo_mad(o, q(1), q(3), q(5), q(7), m);
  eo_mad_top(e, o[7], q(0), q(2), q(4), q(6), m);
}

// One CIOS step after the first: the sum / 2^32 (e from limb 0, o[1..7]
// from limb 0 as well) plus a * bi, then reduced; e and o trade roles.
__device__ __forceinline__ void eo_step(uint32_t e[N], uint32_t o[N], const uint32_t a[N],
                                        uint32_t bi) {
  eo_rshift(e[0], o, a[1], a[3], a[5], a[7], bi);
  eo_mad_top(e, o[7], a[0], a[2], a[4], a[6], bi);
  eo_reduce(e, o);
}

// r = a * b * 2^-256 mod q, in [0, 2q) for a, b in [0, 2q) (CIOS, no final
// subtract). Safe when r aliases a or b.
__device__ __forceinline__ void mul(const uint32_t a[N], const uint32_t b[N], uint32_t r[N]) {
  uint32_t ev[N], od[N];
  eo_mul(od, a[1], a[3], a[5], a[7], b[0]);
  eo_mul(ev, a[0], a[2], a[4], a[6], b[0]);
  eo_reduce(ev, od);
  eo_step(od, ev, a, b[1]);
#pragma unroll
  for (int i = 2; i < N; i += 2) {
    eo_step(ev, od, a, b[i]);
    eo_step(od, ev, a, b[i + 1]);
  }
  // r = ev + od / 2^32
  asm("add.cc.u32 %0, %8, %16;\n\taddc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\taddc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\taddc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\taddc.u32 %7, %15, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7])
      : "r"(ev[0]), "r"(ev[1]), "r"(ev[2]), "r"(ev[3]), "r"(ev[4]), "r"(ev[5]), "r"(ev[6]),
        "r"(ev[7]), "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]), "r"(od[6]),
        "r"(od[7]));
}

// r = a + b for a, b in [0, 2q), in [0, 2q).
__device__ __forceinline__ void add(const uint32_t a[N], const uint32_t b[N], uint32_t r[N]) {
  uint32_t s[N], d[N], keep;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]),
        "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  // d = s - 2q; keep = all ones when that borrows (s < 2q)
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(keep)
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]),
        "r"(q2(0)), "r"(q2(1)), "r"(q2(2)), "r"(q2(3)), "r"(q2(4)), "r"(q2(5)), "r"(q2(6)),
        "r"(q2(7)));
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = (s[j] & keep) | (d[j] & ~keep);
}

// r = a - b for a, b in [0, 2q), in [0, 2q): 2q is added back when a < b.
__device__ __forceinline__ void sub(const uint32_t a[N], const uint32_t b[N], uint32_t r[N]) {
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7])
      : "r"(q2(0) & borrow), "r"(q2(1) & borrow), "r"(q2(2) & borrow), "r"(q2(3) & borrow),
        "r"(q2(4) & borrow), "r"(q2(5) & borrow), "r"(q2(6) & borrow), "r"(q2(7) & borrow));
}

// v[0..8] < 18q < 2^258  ->  r = v - k q in [0, 2q), k estimated from the
// top bits: k = floor((v >> 226) * QTOP_RECIP / 2^59) is at most
// floor(v / q) and more than v / q - 1 - 2^-23, so r < q (1 + 2^-23). r is
// computed mod 2^256 as v + k (2^256 - q), which is exact since r < 2^256.
__device__ __forceinline__ void reduce_small(const uint32_t v[N + 1], uint32_t r[N]) {
  uint32_t top = __funnelshift_r(v[N - 1], v[N], 2);  // v >> 226: bits 226..257
  uint32_t k = __umulhi(top, QTOP_RECIP) >> 27;
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = v[j];
  asm("mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
      "madc.lo.cc.u32 %1, %8, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %11, %2;\n\t"
      "madc.lo.cc.u32 %3, %8, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %8, %13, %4;\n\t"
      "madc.lo.cc.u32 %5, %8, %14, %5;\n\t"
      "madc.lo.cc.u32 %6, %8, %15, %6;\n\t"
      "madc.lo.u32 %7, %8, %16, %7;\n\t"
      "mad.hi.cc.u32 %1, %8, %9, %1;\n\t"
      "madc.hi.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %11, %3;\n\t"
      "madc.hi.cc.u32 %4, %8, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %8, %13, %5;\n\t"
      "madc.hi.cc.u32 %6, %8, %14, %6;\n\t"
      "madc.hi.u32 %7, %8, %15, %7;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7])
      : "r"(k), "r"(nq(0)), "r"(nq(1)), "r"(nq(2)), "r"(nq(3)), "r"(nq(4)), "r"(nq(5)),
        "r"(nq(6)), "r"(nq(7)));
}

// r = c * a for a in [0, 2q) and c in {3, 8, 9}: a shift by 1 or 3, plus a
// for c = 3 and 9, then reduce_small.
template <int C>
__device__ __forceinline__ void mul_small(const uint32_t a[N], uint32_t r[N]) {
  static_assert(C == 3 || C == 8 || C == 9, "mul_small: c in {3, 8, 9}");
  constexpr int S = C == 3 ? 1 : 3;
  uint32_t v[N + 1];
  v[0] = a[0] << S;
#pragma unroll
  for (int j = 1; j < N; ++j) v[j] = __funnelshift_l(a[j - 1], a[j], S);
  v[N] = a[N - 1] >> (32 - S);
  if (C != 8) {
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(v[0]), "+r"(v[1]), "+r"(v[2]), "+r"(v[3]), "+r"(v[4]), "+r"(v[5]), "+r"(v[6]),
          "+r"(v[7]), "+r"(v[8])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
          "r"(a[7]));
  }
  reduce_small(v, r);
}

// [0, 2q) -> [0, q), in place.
__device__ __forceinline__ void canon(uint32_t a[N]) {
  uint32_t d[N], keep;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(keep)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(q(0)), "r"(q(1)), "r"(q(2)), "r"(q(3)), "r"(q(4)), "r"(q(5)), "r"(q(6)), "r"(q(7)));
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = (a[j] & keep) | (d[j] & ~keep);
}

}  // namespace fq

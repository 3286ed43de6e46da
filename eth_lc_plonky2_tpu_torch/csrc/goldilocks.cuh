// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on the card.
//
// Replaces eth_lc_plonky2_tpu/ops/goldilocks.py `_mul32`, `_reduce128` and
// `mul`: the TPU has no 64-bit integers and multiplies 16-bit parts of
// (lo, hi) u32 limbs; Hopper has 64-bit registers and a 64x64 -> high-64
// multiply (`__umul64hi`), so a field element is one uint64_t here.
//
// Two kinds of word appear.  A CANONICAL word is the field element itself,
// < p: what memory holds, so equality and hashing are plain word compares,
// bit for bit the same as the JAX package.  A LAZY word is any uint64_t
// congruent to the element mod p (p <= x < 2^64 is allowed): what a kernel
// may carry in registers between steps, saving the final compare-subtract
// of every operation.  `canon` turns a lazy word into the canonical one.
// Each function below states what it takes and what it returns; a function
// that takes lazy words also takes canonical ones.
#pragma once

#include <cstdint>
#include <type_traits>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;  // 2^64 mod p

// lazy -> canonical (2p > 2^64, so one subtraction is enough).
__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= P ? x - P : x; }

// The reductions below are written as PTX carry chains (add.cc / addc,
// mad.lo.cc / madc.hi.cc): the kernels are bound by integer instruction
// throughput,
// and the compare-and-select code a compiler makes of `if (s < u)` costs
// about half as many again.

// Any 128-bit value (hi:lo) -> lazy, using 2^64 = 2^32 - 1 and 2^96 = -1:
// t = lo - (hi >> 32), less EPSILON on a borrow (- 2^64; t >= 2^64 - 2^32 + 1
// then, so no second borrow); s = t + (hi & 0xFFFFFFFF) * EPSILON, plus
// EPSILON on a carry (+ 2^64; s <= 2^64 - 2^33 then, so no second carry).
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t lo, uint64_t hi) {
  uint64_t s;
  asm("{\n\t"
      ".reg .u32 l0, l1, h0, h1, t0, t1, m;\n\t"
      "mov.b64 {l0, l1}, %1;\n\t"
      "mov.b64 {h0, h1}, %2;\n\t"
      "sub.cc.u32 t0, l0, h1;\n\t"
      "subc.cc.u32 t1, l1, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"  // 0, or 0xFFFFFFFF = EPSILON on a borrow
      "sub.cc.u32 t0, t0, m;\n\t"
      "subc.u32 t1, t1, 0;\n\t"
      "mad.lo.cc.u32 t0, h0, 0xFFFFFFFF, t0;\n\t"
      "madc.hi.cc.u32 t1, h0, 0xFFFFFFFF, t1;\n\t"
      "addc.u32 m, 0, 0;\n\t"  // the carry
      "neg.s32 m, m;\n\t"      // 0, or 0xFFFFFFFF = EPSILON
      "add.cc.u32 t0, t0, m;\n\t"
      "addc.u32 t1, t1, 0;\n\t"
      "mov.b64 %0, {t0, t1};\n\t"
      "}"
      : "=l"(s)
      : "l"(lo), "l"(hi));
  return s;
}

// Any 128-bit value (hi:lo) -> canonical.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  return canon(reduce128_lazy(lo, hi));
}

// lo + h * 2^64 with h < 2^32 -> lazy: lo + h * EPSILON, plus EPSILON on a
// carry (the wrapped sum is then at most 2^64 - 2^33, so no second carry).
__device__ __forceinline__ uint64_t reduce96_lazy(uint64_t lo, uint32_t h) {
  uint64_t s;
  asm("{\n\t"
      ".reg .u32 l0, l1, m;\n\t"
      "mov.b64 {l0, l1}, %1;\n\t"
      "mad.lo.cc.u32 l0, %2, 0xFFFFFFFF, l0;\n\t"
      "madc.hi.cc.u32 l1, %2, 0xFFFFFFFF, l1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 l0, l0, m;\n\t"
      "addc.u32 l1, l1, 0;\n\t"
      "mov.b64 %0, {l0, l1};\n\t"
      "}"
      : "=l"(s)
      : "l"(lo), "r"(h));
  return s;
}

// 2^i x of a lazy x, 0 <= i < 32 -> lazy.
__device__ __forceinline__ uint64_t shl_lazy(uint64_t x, int i) {
  return reduce96_lazy(x << i, (uint32_t)((x >> 1) >> (63 - i)));
}

// al + ah * 2^32 with al, ah < 2^44 (two sums of small multiples of 32-bit
// halves) -> lazy.  The value is a0 + a1 * 2^32 + h * 2^64 with h < 2^13;
// after a carry the wrapped sum is below h * EPSILON < 2^45, so adding
// EPSILON cannot carry again.
__device__ __forceinline__ uint64_t reduce_halves_lazy(uint64_t al, uint64_t ah) {
  uint64_t s;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, h, m;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a1, a1, b0;\n\t"
      "addc.u32 h, b1, 0;\n\t"
      "mad.lo.cc.u32 a0, h, 0xFFFFFFFF, a0;\n\t"
      "madc.hi.cc.u32 a1, h, 0xFFFFFFFF, a1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 a0, a0, m;\n\t"
      "addc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(s)
      : "l"(al), "l"(ah));
  return s;
}

// lazy x lazy -> lazy.
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy(a * b, __umul64hi(a, b));
}

// lazy x lazy + lazy -> lazy (the sum is below 2^128: (2^64-1)^2 + 2^64 - 1).
__device__ __forceinline__ uint64_t mul_add_lazy(uint64_t a, uint64_t b, uint64_t c) {
  uint64_t lo, hi;
  asm("mad.lo.cc.u64 %0, %2, %3, %4;\n\t"
      "madc.hi.u64 %1, %2, %3, 0;"
      : "=&l"(lo), "=l"(hi)
      : "l"(a), "l"(b), "l"(c));
  return reduce128_lazy(lo, hi);
}

// lazy + CANONICAL -> lazy.  On a carry the wrapped sum is below p - 1, so
// adding EPSILON cannot carry again.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b_canonical) {
  uint64_t s;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, m;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 a0, a0, m;\n\t"
      "addc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(s)
      : "l"(a), "l"(b_canonical));
  return s;
}

// lazy - CANONICAL -> lazy.  On a borrow the wrapped difference a - b + 2^64
// is at least 2^64 - p + 1 = EPSILON + 1 (b < p), so subtracting EPSILON
// cannot borrow again.
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b_canonical) {
  uint64_t s;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, m;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "sub.cc.u32 a0, a0, b0;\n\t"
      "subc.cc.u32 a1, a1, b1;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 a0, a0, m;\n\t"
      "subc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(s)
      : "l"(a), "l"(b_canonical));
  return s;
}

// A sum of up to 2^8 products of lazy words.  The four 32 x 32 partial
// products of a term go to three 96-bit column sums (weights 1, 2^32 and
// 2^64), each by one multiply-add with carry, and the columns are only added
// up when the sum is reduced: a term costs no carry chain across 128 bits.
struct Acc {
  uint32_t x0 = 0, x1 = 0, x2 = 0;  // sum of a0*b0
  uint32_t y0 = 0, y1 = 0, y2 = 0;  // sum of a0*b1 + a1*b0
  uint32_t z0 = 0, z1 = 0, z2 = 0;  // sum of a1*b1

  // += a * b, a and b lazy.
  __device__ __forceinline__ void mac(uint64_t a, uint64_t b) {
    const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
    const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
    asm("mad.lo.cc.u32 %0, %9, %11, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "mad.lo.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %12, %4;\n\t"
        "addc.u32 %5, %5, 0;\n\t"
        "mad.lo.cc.u32 %3, %10, %11, %3;\n\t"
        "madc.hi.cc.u32 %4, %10, %11, %4;\n\t"
        "addc.u32 %5, %5, 0;\n\t"
        "mad.lo.cc.u32 %6, %10, %12, %6;\n\t"
        "madc.hi.cc.u32 %7, %10, %12, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(x0), "+r"(x1), "+r"(x2), "+r"(y0), "+r"(y1), "+r"(y2), "+r"(z0), "+r"(z1),
          "+r"(z2)
        : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
  }

  // -> lazy.  x + y*2^32 + z*2^64 = lo + hi*2^64 + c*2^128 with c < 2^9, and
  // 2^128 = (2^32 - 1)^2 = -2^32 (mod p): d = r - c*2^32, less EPSILON on a
  // borrow (d >= 2^64 - 2^41 then, so no second borrow).
  __device__ __forceinline__ uint64_t reduce_lazy() const {
    uint64_t lo, hi;
    uint32_t c;
    asm("{\n\t"
        ".reg .u32 s1, s2, s3;\n\t"
        "add.cc.u32 s1, %4, %6;\n\t"
        "addc.cc.u32 s2, %5, %7;\n\t"
        "addc.u32 s3, %8, 0;\n\t"
        "add.cc.u32 s2, s2, %9;\n\t"
        "addc.cc.u32 s3, s3, %10;\n\t"
        "addc.u32 %2, %11, 0;\n\t"
        "mov.b64 %0, {%3, s1};\n\t"
        "mov.b64 %1, {s2, s3};\n\t"
        "}"
        : "=l"(lo), "=l"(hi), "=r"(c)
        : "r"(x0), "r"(x1), "r"(x2), "r"(y0), "r"(y1), "r"(y2), "r"(z0), "r"(z1), "r"(z2));
    const uint64_t r = reduce128_lazy(lo, hi);
    uint64_t d;
    asm("{\n\t"
        ".reg .u32 r0, r1, m;\n\t"
        "mov.b64 {r0, r1}, %1;\n\t"
        "sub.cc.u32 r1, r1, %2;\n\t"
        "subc.u32 m, 0, 0;\n\t"
        "sub.cc.u32 r0, r0, m;\n\t"
        "subc.u32 r1, r1, 0;\n\t"
        "mov.b64 %0, {r0, r1};\n\t"
        "}"
        : "=l"(d)
        : "l"(r), "r"(c));
    return d;
  }
};

// canonical x canonical -> canonical (lazy inputs are fine too).
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// canonical + canonical -> canonical.
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  // carry or s >= p: subtract p once (a + b < 2p); s - p wraps to s + EPSILON on carry
  return (s < a || s >= P) ? s - P : s;
}

// canonical - canonical -> canonical.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d + P : d;  // borrow: d + p wraps to d - EPSILON
}

// x^(2^n), lazy -> lazy.
__device__ __forceinline__ uint64_t square_times(uint64_t x, int n) {
  for (int i = 0; i < n; ++i) x = mul_lazy(x, x);
  return x;
}

// lazy -> canonical a^(p-2), p - 2 = 2^64 - 2^32 - 1; the inverse of 0
// comes out as 0.  The chain: a^3, a^7, a^(2^6 - 1), a^(2^12 - 1),
// a^(2^24 - 1), a^(2^30 - 1), a^(2^31 - 1) = t31; t31^(2^32) * t31 =
// a^((2^31 - 1)(2^32 + 1)); its square times a: 63 squarings, 9 products.
__device__ __forceinline__ uint64_t inv_fermat(uint64_t a) {
  const uint64_t t2 = mul_lazy(square_times(a, 1), a);
  const uint64_t t3 = mul_lazy(square_times(t2, 1), a);
  const uint64_t t6 = mul_lazy(square_times(t3, 3), t3);
  const uint64_t t12 = mul_lazy(square_times(t6, 6), t6);
  const uint64_t t24 = mul_lazy(square_times(t12, 12), t12);
  const uint64_t t30 = mul_lazy(square_times(t24, 6), t6);
  const uint64_t t31 = mul_lazy(square_times(t30, 1), a);
  const uint64_t t63 = mul_lazy(square_times(t31, 32), t31);
  return canon(mul_lazy(square_times(t63, 1), a));
}

// The numerator of a quotient that is an inverse: 1, costing no product.
struct One {
  __device__ __forceinline__ uint64_t operator()(int) const { return 1; }
};

// Word i of a row of shared memory with a stride (one thread's column of
// a table laid out [row][thread]).
struct Strided {
  uint64_t* base;
  int stride;
  __device__ __forceinline__ uint64_t& operator[](int i) const { return base[(long long)i * stride]; }
};

// Montgomery's trick: out[i] = num(i) / den(i) for i < count <= K, with ONE
// Fermat power for all of them, and 0 where den(i) = 0, which is the a^(p-2)
// of 0 that every plain inverse of the repo gives.  den(i) is a canonical
// word and is called twice for each i (forward, then backward), so a caller
// may recompute it rather than keep it; num(i) (lazy) is called once, in the
// forward pass, before out[i] is written, so it may read out[i] itself.
// Products: 3 a word (4 with a numerator) and 72 for the power; out[] is
// canonical.  `out` is a register array of K words (the loops unrolled, so
// that its words stay in registers), or a view of shared memory with
// UNROLL 1: rolled loops over the count words.  A caller that consumes each
// quotient as it comes takes the two halves: batch_prefix, then inv_fermat
// of its result and batch_back for i = count - 1 down to 0.

// The forward pass: out[i] = num(i) times the product of the non-zero
// den(j), j < i; returns the product of all the non-zero den(i), which is
// never 0 (the field has no zero divisors).
template <int K, int UNROLL = K, class Out, class Den, class Num = One>
__device__ __forceinline__ uint64_t batch_prefix(Out&& out, int count, Den den, Num num = Num()) {
  const int words = UNROLL == 1 ? count : K;  // a constant where unrolled
  uint64_t run = 1;
#pragma unroll (UNROLL)
  for (int i = 0; i < words; ++i) {
    if (i < count) {
      const uint64_t d = den(i);
      out[i] = std::is_same<Num, One>::value ? run : mul_lazy(num(i), run);
      if (d != 0) run = mul_lazy(run, d);
    }
  }
  return run;
}

// One backward step, for i from the last word down: `inv` is 1 / (the
// product of the non-zero den(j), j <= i), `prefix` batch_prefix's out[i]
// and d = den(i); returns num(i) / d (canonical; 0 where d = 0) and leaves
// in `inv` the inverse of the product for j < i.
__device__ __forceinline__ uint64_t batch_back(uint64_t& inv, uint64_t prefix, uint64_t d) {
  if (d == 0) return 0;
  const uint64_t q = mul(inv, prefix);
  inv = mul_lazy(inv, d);
  return q;
}

template <int K, int UNROLL = K, class Out, class Den, class Num = One>
__device__ __forceinline__ void batch_div(Out&& out, int count, Den den, Num num = Num()) {
  const int words = UNROLL == 1 ? count : K;
  uint64_t inv = inv_fermat(batch_prefix<K, UNROLL>(out, count, den, num));
#pragma unroll (UNROLL)
  for (int i = words - 1; i >= 0; --i) {
    if (i < count) out[i] = batch_back(inv, out[i], den(i));
  }
}

}  // namespace gl

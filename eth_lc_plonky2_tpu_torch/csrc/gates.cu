// The gates' share of the quotient: the SHA-256 and Poseidon gates, one
// launch each, and the generic gates with the public inputs, one launch.
//
// Replaces eth_lc_plonky2_tpu/circuit/gates_sha256.py:223 `absorb_sha_quotient`,
// eth_lc_plonky2_tpu/circuit/gates_poseidon.py:133 `absorb_poseidon_quotient`
// and the generic loop of eth_lc_plonky2_tpu/prover/prove.py:484-520 (the
// public-input terms, and `g.eval` with `absorb` for the ArithmeticGate,
// BaseSum2Gate and ConstantGate).  None is a Pallas kernel: XLA fuses the
// (32, L) bit blocks, the `lax.scan`s over rounds and the generic
// constraints into the jitted quotient (:534).  Eager PyTorch fuses nothing:
// the gates' generic `eval` is about 3,000 (SHA-256) and 10,000 (Poseidon)
// whole-domain field operations, the generic gates and public inputs of the
// light-client circuit about 900, one csrc/field.cu launch each.
//
// What each computes.  For every column x of the LDE domain and every
// challenge j:
//     out_j[x] = acc_j[x] + sel[x] * sum_k alpha_j[k] * C_k(x)
// where C_k are the gate's constraints in `eval()`'s emission order and
// alpha_j[k] = alpha_j^(k0 + k).  All arithmetic is exact in GF(p) and the
// stored words are canonical, so the result equals, word for word, the
// generic loop `acc_j += (sel * C_k) * alpha_j[k]`, whatever the order of the
// sums and wherever a common factor is taken out of a sum.
//
// Design.  One thread a column, neighbouring threads on neighbouring
// columns, so every load of a wire row coalesces.  `wire(col, off)` is row
// `col` at column (x + off * 2^rate) mod n_lde (the value at trace row
// r + off: ops/ntt.py `roll_lde`).  Nothing of the TPU version's windows,
// wrap pads and rolled (32, L) blocks is kept: a thread streams the bit
// wires through rolled loops (the rotations of a word re-read bits that L1
// and L2 still hold) and keeps only a few words in registers.  The alpha
// powers (and the Poseidon gate's round constants) sit in shared memory.
//
// All take exactly two challenges, the prover's configuration.
//
// What bounds them.  The SHA-256 gate's polynomials are evaluated in their
// cheapest form (xor3 as two nested xor2, ch = g + e (f - g),
// maj = ab + c (a + b - 2 ab): the same polynomials as `eval()`'s expanded
// ones, so the same words): 463 field products and 210 multiply-accumulates
// a column (about 3,200 multiply-adds of 32 x 32 bits) against 111 distinct
// words moved.  The Poseidon gate does 474 products, 30 dense layers (small
// coefficients: twelve terms are summed wide and reduced once) and 260
// multiply-accumulates (about 12,500) against 147 words.  At 16.75 T
// multiply-adds a second and 3.35 TB/s that is 0.40 against 0.56 ms (bound by
// bytes) and 1.56 against 0.74 ms (bound by operations) for 2^21 columns.
// Both kernels are kept simple: canonical products in the SHA-256 gate, bit
// wires re-read for each rotation.
//
// The generic gates (generic_gate_quotient_kernel) visit the wire columns
// once, in order, four at a time with the next four already loading; each
// word goes to every generic gate that reads it (ArithmeticGate op w / 4 in
// role w % 4, BaseSum2Gate slot w / 33 as its value or a bit, whose sum and
// booleanity both take it, ConstantGate slot w), each gate into its own
// 96-bit column sums a challenge.  The public-input terms
// lr_i (w_{c_i} - pi_i) read their wire and Lagrange rows once each.  The
// accumulators are updated in place.  What bounds it: memory, about 110 rows
// read a column in the light-client circuit (80 wires, 3 selectors, 8
// constant rows, 12 Lagrange rows and 12 public-input wires, 2
// accumulators) against about 200 multiply-accumulates and 150 products.
#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

constexpr int NCH = 2;  // challenges: one accumulator and one row of alpha powers each

// The wires' LDE, (num_wires, n_lde) words, row stride `stride`.
struct WireView {
  const uint64_t* base;
  long long stride;
  long long mask;  // n_lde - 1 (n_lde is a power of two)
  long long x;     // this thread's column
  int rate;

  // canonical word of wire `col` at trace row offset `off`.
  __device__ __forceinline__ uint64_t at(int col, int off = 0) const {
    const long long c = (x + (long long)off * (1ll << rate)) & mask;
    return base[(long long)col * stride + c];
  }
};

// 128-bit sum of words shifted left: the Horner sums sum_i v_i * 2^i (i < 32,
// at most 32 terms of fewer than 96 bits each, so nothing is lost).
struct Wide {
  uint64_t lo = 0, hi = 0;

  __device__ __forceinline__ void add_shl(uint64_t v, int i) {
    const uint64_t l = v << i;
    const uint64_t h = i ? v >> (64 - i) : 0;
    lo += l;
    hi += h + (lo < l);
  }

  __device__ __forceinline__ uint64_t reduce() const { return gl::reduce128(lo, hi); }
};

// canonical in, canonical out: x + y - 2 xy, one product.
__device__ __forceinline__ uint64_t xor2(uint64_t x, uint64_t y) {
  const uint64_t xy = gl::mul(x, y);
  return gl::sub(gl::add(x, y), gl::add(xy, xy));
}

// x + y + z - 2 (xy + yz + zx) + 4 xyz, which is xor2(xor2(x, y), z) as a
// polynomial (for any field words, not only bits): two products.
__device__ __forceinline__ uint64_t xor3(uint64_t x, uint64_t y, uint64_t z) {
  return xor2(xor2(x, y), z);
}

// c (c - 1) ... (c - hi), canonical.
__device__ __forceinline__ uint64_t range_prod(uint64_t c, int hi) {
  uint64_t acc = c;
  for (int v = 1; v <= hi; ++v) acc = gl::mul(acc, gl::sub(c, (uint64_t)v));
  return acc;
}

// ---------------------------------------------------------------------------
// SHA-256 round gate (circuit/gates_sha256.py Sha256RoundGate.eval)
// ---------------------------------------------------------------------------

// The constraint index layout of eval(): the wrapper's module holds the same
// numbers, and a test compares the two.
constexpr int K_ROUND_E = 0;
constexpr int K_ROUND_A = 1;
constexpr int K_SCHED = 2;
constexpr int K_WORD = 3;     // 3..5: a, e, w word-bit consistency
constexpr int K_BOOL = 6;     // 6..101: booleanity of the a, e, w bits
constexpr int K_CARRY = 102;  // 102..104: carry ranges of a, e, w
constexpr int SHA_CONSTRAINTS = 105;
constexpr uint64_t TWO32 = 1ull << 32;

// The wire layout, given by the wrapper (circuit/gates_sha256.py's constants).
struct ShaLayout {
  int col_wa, col_we, col_ww;     // routed word wires
  int a_bits, e_bits, w_bits;     // first of each 32 bit wires
  int carry_a, carry_e, carry_w;
};

// sum_i xor3(bits[(i + r0) % 32], bits[(i + r1) % 32], third) * 2^i, where the
// third input is bits[(i + r2) % 32] (a rotation) or, with `shift`, the
// shifted word's bit: bits[i + r2] for i + r2 < 32, else 0.
__device__ __forceinline__ uint64_t sigma_word(const WireView& w, int first, int off, int r0,
                                               int r1, int r2, bool shift) {
  Wide sum;
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
    const uint64_t x = w.at(first + ((i + r0) & 31), off);
    const uint64_t y = w.at(first + ((i + r1) & 31), off);
    uint64_t v;
    if (shift && i + r2 >= 32) {
      v = xor2(x, y);
    } else {
      v = xor3(x, y, w.at(first + ((i + r2) & 31), off));
    }
    sum.add_shl(v, i);
  }
  return sum.reduce();
}

__global__ void __launch_bounds__(256)
sha_gate_quotient_kernel(WireView w0, ShaLayout L, const uint64_t* __restrict__ k_t,
                         const uint64_t* __restrict__ m_round,
                         const uint64_t* __restrict__ m_sched,
                         const uint64_t* __restrict__ m_bits, const uint64_t* __restrict__ sel,
                         const uint64_t* __restrict__ alpha0, const uint64_t* __restrict__ alpha1,
                         const uint64_t* __restrict__ acc0, const uint64_t* __restrict__ acc1,
                         uint64_t* __restrict__ out0, uint64_t* __restrict__ out1,
                         long long n_lde) {
  __shared__ uint64_t alpha[NCH][SHA_CONSTRAINTS];
  for (int k = threadIdx.x; k < SHA_CONSTRAINTS; k += blockDim.x) {
    alpha[0][k] = alpha0[k];
    alpha[1][k] = alpha1[k];
  }
  __syncthreads();
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n_lde) return;
  WireView w = w0;
  w.x = x;
  const uint64_t mr = m_round[x], ms = m_sched[x], mb = m_bits[x];

  // round constraint for e: we + ce 2^32 = d + h + S1(e) + ch + K + W
  uint64_t c_round_e;
  {
    const uint64_t s1 = sigma_word(w, L.e_bits, -1, 6, 11, 25, false);
    Wide ch;
#pragma unroll 1
    for (int i = 0; i < 32; ++i) {
      const uint64_t e = w.at(L.e_bits + i, -1), f = w.at(L.e_bits + i, -2);
      const uint64_t g = w.at(L.e_bits + i, -3);
      ch.add_shl(gl::add(g, gl::mul(e, gl::sub(f, g))), i);  // ef + g - eg
    }
    const uint64_t t1 = gl::add(gl::add(w.at(L.col_we, -4), s1),
                                gl::add(ch.reduce(), gl::add(k_t[x], w.at(L.col_ww))));
    const uint64_t rhs = gl::add(w.at(L.col_wa, -4), t1);
    const uint64_t lhs = gl::add(w.at(L.col_we), gl::mul(w.at(L.carry_e), TWO32));
    c_round_e = gl::mul(mr, gl::sub(lhs, rhs));
  }
  // round constraint for a, differenced: (wa - we) + (ca - ce) 2^32 = S0(a) + maj - d
  uint64_t c_round_a;
  {
    const uint64_t s0 = sigma_word(w, L.a_bits, -1, 2, 13, 22, false);
    Wide maj;
#pragma unroll 1
    for (int i = 0; i < 32; ++i) {
      const uint64_t a = w.at(L.a_bits + i, -1), b = w.at(L.a_bits + i, -2);
      const uint64_t c = w.at(L.a_bits + i, -3);
      const uint64_t ab = gl::mul(a, b);  // ab + ac + bc - 2 abc = ab + c (a + b - 2 ab)
      maj.add_shl(gl::add(ab, gl::mul(c, gl::sub(gl::add(a, b), gl::add(ab, ab)))), i);
    }
    const uint64_t lhs =
        gl::add(gl::sub(w.at(L.col_wa), w.at(L.col_we)),
                gl::mul(gl::sub(w.at(L.carry_a), w.at(L.carry_e)), TWO32));
    const uint64_t rhs = gl::sub(gl::add(s0, maj.reduce()), w.at(L.col_wa, -4));
    c_round_a = gl::mul(mr, gl::sub(lhs, rhs));
  }
  // schedule: ww + cw 2^32 = s1(w[-2]) + w[-7] + s0(w[-15]) + w[-16]
  uint64_t c_sched;
  {
    const uint64_t sig1 = sigma_word(w, L.w_bits, -2, 17, 19, 10, true);
    const uint64_t sig0 = sigma_word(w, L.w_bits, -15, 7, 18, 3, true);
    const uint64_t lhs = gl::add(w.at(L.col_ww), gl::mul(w.at(L.carry_w), TWO32));
    const uint64_t rhs = gl::add(gl::add(sig1, w.at(L.col_ww, -7)),
                                 gl::add(sig0, w.at(L.col_ww, -16)));
    c_sched = gl::mul(ms, gl::sub(lhs, rhs));
  }
  const uint64_t c_carry_a = gl::mul(mr, range_prod(w.at(L.carry_a), 6));
  const uint64_t c_carry_e = gl::mul(mr, range_prod(w.at(L.carry_e), 6));
  const uint64_t c_carry_w = gl::mul(ms, range_prod(w.at(L.carry_w), 3));

  // The constraints that carry their mask already, weighted: 6 products.
  gl::Acc single[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    single[j].mac(alpha[j][K_ROUND_E], c_round_e);
    single[j].mac(alpha[j][K_ROUND_A], c_round_a);
    single[j].mac(alpha[j][K_SCHED], c_sched);
    single[j].mac(alpha[j][K_CARRY + 0], c_carry_a);
    single[j].mac(alpha[j][K_CARRY + 1], c_carry_e);
    single[j].mac(alpha[j][K_CARRY + 2], c_carry_w);
  }
  // Word-bit consistency and booleanity share the mask m_bits, which is
  // taken out of their weighted sum: 99 products a challenge.
  gl::Acc masked[NCH];
#pragma unroll 1
  for (int g = 0; g < 3; ++g) {
    const int first = g == 0 ? L.a_bits : g == 1 ? L.e_bits : L.w_bits;
    const int word_col = g == 0 ? L.col_wa : g == 1 ? L.col_we : L.col_ww;
    Wide word;
#pragma unroll 1
    for (int i = 0; i < 32; ++i) {
      const uint64_t b = w.at(first + i);
      word.add_shl(b, i);
      const uint64_t t = gl::sub(gl::mul(b, b), b);
#pragma unroll
      for (int j = 0; j < NCH; ++j) masked[j].mac(alpha[j][K_BOOL + 32 * g + i], t);
    }
    const uint64_t d = gl::sub(w.at(word_col), word.reduce());
#pragma unroll
    for (int j = 0; j < NCH; ++j) masked[j].mac(alpha[j][K_WORD + g], d);
  }
  const uint64_t s = sel[x];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const uint64_t total = gl::add(gl::canon(single[j].reduce_lazy()),
                                   gl::mul(mb, masked[j].reduce_lazy()));
    const uint64_t* acc = j == 0 ? acc0 : acc1;
    uint64_t* out = j == 0 ? out0 : out1;
    out[x] = gl::add(acc[x], gl::mul(s, total));
  }
}

// ---------------------------------------------------------------------------
// Poseidon gate (circuit/gates_poseidon.py PoseidonGate.eval)
// ---------------------------------------------------------------------------

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int NUM_ADVICE = 2 * HALF_FULL * WIDTH + PARTIAL;  // 118
constexpr int POSEIDON_CONSTRAINTS = NUM_ADVICE + WIDTH;       // 130
// The wrapper's table: ROUNDS x WIDTH round constants, the circulant's first
// row (WIDTH small words), then the one non-zero diagonal entry.
constexpr int TABLE_WORDS = ROUNDS * WIDTH + WIDTH + 1;

// lazy -> lazy x^7: four products.
__device__ __forceinline__ uint64_t pow7(uint64_t x) {
  const uint64_t x2 = gl::mul_lazy(x, x);
  const uint64_t x3 = gl::mul_lazy(x2, x);
  return gl::mul_lazy(gl::mul_lazy(x3, x3), x);
}

// The dense layer out[r] = sum_i circ[i] * st[(r + i) % 12] + diag0 * st[0]
// (r = 0 only), lazy words in and out.  The coefficients add up to less than
// 2^9, so the sums of the 32-bit halves stay below 2^41 and one reduction a
// row is enough.
__device__ __forceinline__ void mds(uint64_t (&st)[WIDTH], const uint64_t* circ, uint64_t diag0) {
  uint32_t lo[WIDTH], hi[WIDTH], c[WIDTH];
  uint64_t out[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    lo[i] = (uint32_t)st[i];
    hi[i] = (uint32_t)(st[i] >> 32);
    c[i] = (uint32_t)circ[i];
  }
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    uint64_t al = 0, ah = 0;  // 32 x 32 -> 64-bit multiply-adds
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      al += (uint64_t)c[i] * lo[(r + i) % WIDTH];
      ah += (uint64_t)c[i] * hi[(r + i) % WIDTH];
    }
    if (r == 0) {
      al += (uint64_t)(uint32_t)diag0 * lo[0];
      ah += (uint64_t)(uint32_t)diag0 * hi[0];
    }
    out[r] = gl::reduce_halves_lazy(al, ah);
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) st[i] = out[i];
}

struct PoseidonLayout {
  int w_in, w_out, w_adv;
};

__global__ void __launch_bounds__(256)
poseidon_gate_quotient_kernel(WireView w0, PoseidonLayout L, const uint64_t* __restrict__ table,
                              const uint64_t* __restrict__ sel,
                              const uint64_t* __restrict__ alpha0,
                              const uint64_t* __restrict__ alpha1,
                              const uint64_t* __restrict__ acc0,
                              const uint64_t* __restrict__ acc1, uint64_t* __restrict__ out0,
                              uint64_t* __restrict__ out1, long long n_lde) {
  __shared__ uint64_t alpha[NCH][POSEIDON_CONSTRAINTS];
  __shared__ uint64_t tab[TABLE_WORDS];
  for (int k = threadIdx.x; k < POSEIDON_CONSTRAINTS; k += blockDim.x) {
    alpha[0][k] = alpha0[k];
    alpha[1][k] = alpha1[k];
  }
  for (int k = threadIdx.x; k < TABLE_WORDS; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n_lde) return;
  WireView w = w0;
  w.x = x;
  const uint64_t* circ = tab + ROUNDS * WIDTH;
  const uint64_t diag0 = tab[ROUNDS * WIDTH + WIDTH];

  uint64_t st[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) st[i] = w.at(L.w_in + i);
  gl::Acc sum[NCH];  // 130 products each
  int adv = L.w_adv;  // the next advice wire
  int k = 0;          // the next constraint
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    const uint64_t* rc = tab + r * WIDTH;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = gl::add_lazy(st[i], rc[i]);
    const bool full = r < HALF_FULL || r >= HALF_FULL + PARTIAL;
    if (full) {
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) {
        const uint64_t a = w.at(adv + i);
        const uint64_t c = gl::sub(gl::canon(pow7(st[i])), a);
#pragma unroll
        for (int j = 0; j < NCH; ++j) sum[j].mac(alpha[j][k + i], c);
        st[i] = a;
      }
      adv += WIDTH;
      k += WIDTH;
    } else {
      const uint64_t a = w.at(adv);
      const uint64_t c = gl::sub(gl::canon(pow7(st[0])), a);
#pragma unroll
      for (int j = 0; j < NCH; ++j) sum[j].mac(alpha[j][k], c);
      st[0] = a;
      adv += 1;
      k += 1;
    }
    mds(st, circ, diag0);
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    const uint64_t c = gl::sub(w.at(L.w_out + i), gl::canon(st[i]));
#pragma unroll
    for (int j = 0; j < NCH; ++j) sum[j].mac(alpha[j][NUM_ADVICE + i], c);
  }
  const uint64_t s = sel[x];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const uint64_t* acc = j == 0 ? acc0 : acc1;
    uint64_t* out = j == 0 ? out0 : out1;
    out[x] = gl::add(acc[x], gl::mul(s, sum[j].reduce_lazy()));
  }
}

// ---------------------------------------------------------------------------
// The generic gates and the public inputs (circuit/gates.py)
// ---------------------------------------------------------------------------

constexpr int GEN_MAX_CONSTRAINTS = 256;  // a gate's constraints: one gl::Acc, no reduction between
constexpr int GEN_BS_MAX_BITS = 32;       // BaseSum2Gate bits a slot (its 33 wires a slot)
constexpr int GEN_BS_STRIDE = 33;         // wires a BaseSum2Gate slot

// Each generic gate at most once; a count of 0 leaves the gate out.
struct GenericArgs {
  const uint64_t* wires;   // wire w at column x: wires[w * wires_stride + x]
  long long wires_stride;
  const uint64_t* consts;  // constant column i at column x: consts[i * consts_stride + x]
  long long consts_stride;
  const uint64_t* sel_arith;  // the gates' selector rows
  const uint64_t* sel_bs;
  const uint64_t* sel_const;
  int arith_ops;              // ArithmeticGate(num_ops)
  int bs_bits, bs_slots;      // BaseSum2Gate(num_bits, num_slots)
  int const_slots;            // ConstantGate(num_slots)
  int visit;                  // wire columns visited: the most any of the three reads
  const uint64_t* lr;         // public input i's Lagrange row: lr[i * lr_stride + x]
  long long lr_stride;
  const uint64_t* pi;         // (num_pi,) the public inputs
  const long long* pi_col;    // (num_pi,) their wire columns
  int num_pi;
  const uint64_t* alpha[NCH]; // alpha_j^0, alpha_j^1, ...: reads [pi0, pi0 + num_pi), [k0, k0 + slots)
  int pi0, k0, slots;         // slots: the most constraints of the three gates
  uint64_t* acc[NCH];         // (n_lde,) updated in place
  long long n_lde;
};

// acc_j[x] += sum over the public inputs and the generic gates, canonical.
// Dynamic shared memory: per challenge the alpha powers of the public
// inputs, then of the constraint slots; then the public inputs' words.
__global__ void __launch_bounds__(256)
generic_gate_quotient_kernel(GenericArgs g) {
  extern __shared__ uint64_t gen_shared[];
  const int per = g.num_pi + g.slots;
  uint64_t* alpha = gen_shared;                 // alpha[j * per + i]: public input i
  uint64_t* pi = gen_shared + NCH * per;        // then slot k at j * per + num_pi + k
  for (int t = threadIdx.x; t < per; t += blockDim.x) {
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      alpha[j * per + t] = t < g.num_pi ? g.alpha[j][g.pi0 + t] : g.alpha[j][g.k0 + t - g.num_pi];
  }
  for (int t = threadIdx.x; t < g.num_pi; t += blockDim.x) pi[t] = g.pi[t];
  __syncthreads();
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= g.n_lde) return;
  const uint64_t* ak[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) ak[j] = alpha + j * per + g.num_pi;

  uint64_t total[NCH];
  // the public inputs: lr_i (w_{c_i} - pi_i), a reduction every 128 terms
#pragma unroll
  for (int j = 0; j < NCH; ++j) total[j] = 0;
  for (int i0 = 0; i0 < g.num_pi; i0 += 128) {
    const int i1 = min(g.num_pi, i0 + 128);
    gl::Acc sum[NCH];
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const uint64_t w = g.wires[g.pi_col[i] * g.wires_stride + x];
      const uint64_t t = gl::mul(g.lr[(long long)i * g.lr_stride + x], gl::sub(w, pi[i]));
#pragma unroll
      for (int j = 0; j < NCH; ++j) sum[j].mac(alpha[j * per + i], t);
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) total[j] = gl::add(total[j], gl::canon(sum[j].reduce_lazy()));
  }

  // one pass over the wire columns
  const uint64_t c0 = g.consts[x];
  const uint64_t c1 = g.consts_stride ? g.consts[g.consts_stride + x] : 0;
  gl::Acc arith[NCH], bs[NCH], cst[NCH];
  uint64_t a = 0, ab = 0, c = 0;   // the ArithmeticGate op in progress: a, a b, c
  uint64_t value = 0;               // the BaseSum2Gate slot in progress: its value
  Wide bits;                        //   and sum_i bit_i 2^i
  int slot = 0, r = 0;              // wire w is BaseSum2Gate slot `slot`, place r
  const auto visit = [&](int w, uint64_t v) {
    if (w < 4 * g.arith_ops) {  // op w / 4: out = c0 a b + c1 c
      const int role = w & 3;
      if (role == 0) {
        a = v;
      } else if (role == 1) {
        ab = gl::mul(a, v);
      } else if (role == 2) {
        c = v;
      } else {
        const uint64_t con = gl::sub(gl::add(gl::mul(c0, ab), gl::mul(c1, c)), v);
#pragma unroll
        for (int j = 0; j < NCH; ++j) arith[j].mac(ak[j][w >> 2], con);
      }
    }
    if (w < GEN_BS_STRIDE * g.bs_slots) {  // slot: [sum - value, bit_0^2 - bit_0, ...]
      const int first = slot * (1 + g.bs_bits);
      if (r == 0) {
        value = v;
        bits = Wide();
      } else if (r <= g.bs_bits) {
        bits.add_shl(v, r - 1);
        const uint64_t con = gl::sub(gl::mul(v, v), v);
#pragma unroll
        for (int j = 0; j < NCH; ++j) bs[j].mac(ak[j][first + r], con);
      }
      if (r == g.bs_bits) {
        const uint64_t con = gl::sub(bits.reduce(), value);
#pragma unroll
        for (int j = 0; j < NCH; ++j) bs[j].mac(ak[j][first], con);
      }
      if (++r == GEN_BS_STRIDE) {
        r = 0;
        ++slot;
      }
    }
    if (w < g.const_slots) {  // wire w == constant column w
      const uint64_t cw = w == 0 ? c0 : w == 1 ? c1 : g.consts[w * g.consts_stride + x];
      const uint64_t con = gl::sub(v, cw);
#pragma unroll
      for (int j = 0; j < NCH; ++j) cst[j].mac(ak[j][w], con);
    }
  };
  // four columns at a time, the next four loading meanwhile
  const uint64_t* col = g.wires + x;
  const auto load4 = [&](int w0, uint64_t (&v)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = w0 + q < g.visit ? col[(long long)(w0 + q) * g.wires_stride] : 0;
  };
  uint64_t cur[4], ahead[4];
  load4(0, cur);
#pragma unroll 1
  for (int w0 = 0; w0 < g.visit; w0 += 4) {
    load4(w0 + 4, ahead);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (w0 + q < g.visit) visit(w0 + q, cur[q]);
      cur[q] = ahead[q];
    }
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    if (g.arith_ops) total[j] = gl::add(total[j], gl::mul(g.sel_arith[x], arith[j].reduce_lazy()));
    if (g.bs_slots) total[j] = gl::add(total[j], gl::mul(g.sel_bs[x], bs[j].reduce_lazy()));
    if (g.const_slots) total[j] = gl::add(total[j], gl::mul(g.sel_const[x], cst[j].reduce_lazy()));
    g.acc[j][x] = gl::add(g.acc[j][x], total[j]);
  }
}

unsigned blocks_for(long long count, int threads) {
  return (unsigned)((count + threads - 1) / threads);
}

const uint64_t* words(const void* p) { return static_cast<const uint64_t*>(p); }

}  // namespace

// One launch for the two challenges.  `n_lde` is a power of two; `layout` is
// 9 ints in ShaLayout's order (read on the host).  The outputs must not
// overlap any input.
extern "C" int elp_sha_gate_quotient(const void* wires, long long stride, long long n_lde,
                                     int rate, const int* layout, const void* k_t,
                                     const void* m_round, const void* m_sched,
                                     const void* m_bits, const void* sel, const void* alpha0,
                                     const void* alpha1, const void* acc0, const void* acc1,
                                     void* out0, void* out1, int threads, void* stream) {
  if (n_lde < 1 || (n_lde & (n_lde - 1)) || threads < 1 || threads > 256)
    return (int)cudaErrorInvalidValue;
  const WireView w{words(wires), stride, n_lde - 1, 0, rate};
  const ShaLayout L{layout[0], layout[1], layout[2], layout[3], layout[4],
                    layout[5], layout[6], layout[7], layout[8]};
  sha_gate_quotient_kernel<<<blocks_for(n_lde, threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      w, L, words(k_t), words(m_round), words(m_sched), words(m_bits), words(sel), words(alpha0),
      words(alpha1), words(acc0), words(acc1), static_cast<uint64_t*>(out0),
      static_cast<uint64_t*>(out1), n_lde);
  return (int)cudaGetLastError();
}

// `layout` is 3 ints in PoseidonLayout's order; `table` is TABLE_WORDS words.
extern "C" int elp_poseidon_gate_quotient(const void* wires, long long stride, long long n_lde,
                                          const int* layout, const void* table, const void* sel,
                                          const void* alpha0, const void* alpha1,
                                          const void* acc0, const void* acc1, void* out0,
                                          void* out1, int threads, void* stream) {
  if (n_lde < 1 || (n_lde & (n_lde - 1)) || threads < 1 || threads > 256)
    return (int)cudaErrorInvalidValue;
  const WireView w{words(wires), stride, n_lde - 1, 0, 0};
  const PoseidonLayout L{layout[0], layout[1], layout[2]};
  poseidon_gate_quotient_kernel<<<blocks_for(n_lde, threads), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      w, L, words(table), words(sel), words(alpha0), words(alpha1), words(acc0), words(acc1),
      static_cast<uint64_t*>(out0), static_cast<uint64_t*>(out1), n_lde);
  return (int)cudaGetLastError();
}

// One launch for the two challenges; `acc0`, `acc1` are updated in place and
// overlap no input.  `pi_col` is a device array; the gates' parameters and
// the alpha offsets are ops/kernels.py `generic_gate_plan`'s.
extern "C" int elp_generic_gate_quotient(const void* wires, long long wires_stride,
                                         const void* consts, long long consts_stride,
                                         const void* sel_arith, const void* sel_bs,
                                         const void* sel_const, int arith_ops, int bs_bits,
                                         int bs_slots, int const_slots, const void* lr,
                                         long long lr_stride, const void* pi, const void* pi_col,
                                         int num_pi, const void* alpha0, const void* alpha1,
                                         int pi0, int k0, void* acc0, void* acc1,
                                         long long n_lde, int threads, void* stream) {
  const int arith = arith_ops, bs = bs_slots * (1 + bs_bits), cst = const_slots;
  const int slots = arith > bs ? (arith > cst ? arith : cst) : (bs > cst ? bs : cst);
  int visit = 4 * arith_ops;
  if (GEN_BS_STRIDE * bs_slots > visit) visit = GEN_BS_STRIDE * bs_slots;
  if (const_slots > visit) visit = const_slots;
  if (n_lde < 1 || threads < 1 || threads > 256 || arith_ops < 0 || bs_slots < 0 ||
      const_slots < 0 || bs_bits < 0 || bs_bits > GEN_BS_MAX_BITS || num_pi < 0 ||
      slots >= GEN_MAX_CONSTRAINTS || (arith_ops && !sel_arith) || (bs_slots && !sel_bs) ||
      (const_slots && !sel_const) || (const_slots > 1 && !consts_stride))
    return (int)cudaErrorInvalidValue;
  const size_t shared = ((size_t)NCH * (num_pi + slots) + num_pi) * sizeof(uint64_t);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  GenericArgs g{};
  g.wires = words(wires);
  g.wires_stride = wires_stride;
  g.consts = words(consts);
  g.consts_stride = consts_stride;
  g.sel_arith = words(sel_arith);
  g.sel_bs = words(sel_bs);
  g.sel_const = words(sel_const);
  g.arith_ops = arith_ops;
  g.bs_bits = bs_bits;
  g.bs_slots = bs_slots;
  g.const_slots = const_slots;
  g.visit = visit;
  g.lr = words(lr);
  g.lr_stride = lr_stride;
  g.pi = words(pi);
  g.pi_col = static_cast<const long long*>(pi_col);
  g.num_pi = num_pi;
  g.alpha[0] = words(alpha0);
  g.alpha[1] = words(alpha1);
  g.pi0 = pi0;
  g.k0 = k0;
  g.slots = slots;
  g.acc[0] = static_cast<uint64_t*>(acc0);
  g.acc[1] = static_cast<uint64_t*>(acc1);
  g.n_lde = n_lde;
  generic_gate_quotient_kernel<<<blocks_for(n_lde, threads), threads, shared,
                                 static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

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
// challenge j, in place:
//     acc_j[x] += sel[x] * sum_k alpha_j[k] * C_k(x)
// where C_k are the gate's constraints in `eval()`'s emission order and
// alpha_j[k] = alpha_j^(k0 + k).  All arithmetic is exact in GF(p) and the
// stored words are canonical, so the result equals, word for word, the
// generic loop `acc_j += (sel * C_k) * alpha_j[k]`, whatever the order of the
// sums, wherever a common factor is taken out of a sum, and whichever of two
// equal polynomials is evaluated.  A column of the LDE is no trace row, so
// a "bit" wire holds any field word and every identity used below is one of
// polynomials, not of bits.  All take exactly two challenges, the prover's
// configuration.
//
// What bounds them, and the design.  Both gate kernels are bound by the
// integer pipe, far above their byte bounds: almost every instruction is an
// integer one, which takes 2 cycles a warp a scheduler (4 for IMAD.WIDE, the
// 32 x 32 -> 64 products), half the issue rate (PERF.md: 39,000 and 37,000
// SASS instructions a column in the simple kernels these replace).  So the
// design takes instructions out, the wide products and the reductions first,
// and keeps the code small for the instruction cache:
//   * SHA-256 (sha_gate_quotient_kernel).  A block of SHA_TILE threads takes
//     SHA_TILE adjacent columns and stages each group of 32 bit wires (a, e,
//     w in turn) once, with the columns before the tile that its neighbours
//     read (3 trace rows back for a and e, 15 for w: 2^rate columns a row),
//     into shared memory by cp.async, column-major with a padded stride so
//     that neither the copy nor the reads conflict: every (row, offset) word
//     crosses from L2 once a block, and a thread reads its neighbours' bits
//     at fixed offsets from one base pointer.  A rotation xor is evaluated
//     through signs: with X = 1 - 2x, xor3(x, y, z) = (1 - XYZ) / 2 and
//     xor2(x, y) = (1 - XY) / 2 as polynomials, so a sigma word is
//     ((2^32 - 1) - sum_i 2^i X_i' Y_i' Z_i') / 2: two products a bit and no
//     additions between them.  Once a group's raw bits are read (word,
//     booleanity, ch or maj), the columns the sigmas read are turned into
//     signs in place, and the sums run as rolled loops in segments in which
//     no rotated index wraps (an unrolled version, 15,000 instructions, ran
//     slower than the simple kernel it replaced: the instruction cache).
//     ch = g + e (f - g) and maj = ab + c (a + b - 2ab) keep eval()'s
//     polynomials.  Products are
//     lazy, the weight 2^i goes onto a factor and the last product of a term
//     is summed unreduced in 96-bit column sums; the mask m_bits is taken out
//     of the word and booleanity sums.  About 463 products a column.
//   * Poseidon (poseidon_gate_quotient_kernel).  The 22 partial rounds run
//     in the sparse form the sponge uses (poseidon.cu, ops/poseidon.py
//     sparse_partial_rounds): an advice word takes the S-box output's place
//     in the state, and the sparse form is the same affine map of the input
//     and advice words as the dense rounds, so every S-box input, and so
//     every constraint, is the same word (tests/test_torch_gate_kernels.py
//     holds all 130).  The eight full rounds' dense layers run on 16-bit
//     limbs (poseidon.cuh `mds`), the state stays lazy, x^7 - a is one lazy
//     subtraction, and the tables are the sponge's __constant__ image, read
//     by every thread of a warp at once.  A column is one permutation, so
//     the kernel can be no faster than the sponge's permutation (PERF.md).
// The multiply-adds of each gate's cheapest form, and its bound, are counted
// in chip_smoke.py (SHA_GATE_MADS, POSEIDON_GATE_MADS).
//
// The generic gates (generic_gate_quotient_kernel) replace the generic loop
// of eth_lc_plonky2_tpu/prover/prove.py:484-520 with the public inputs.  They
// visit the wire columns once, in order; each word goes to every generic gate
// that reads it (ArithmeticGate op w / 4 in role w % 4, BaseSum2Gate slot
// w / 33 as its value or a bit, whose sum and booleanity both take it,
// ConstantGate slot w), each gate into its own 96-bit column sums a
// challenge, and each public input's term lr_i (w_{c_i} - pi_i) takes its
// wire from the same pass.  What bounds it: its bound by bytes is about 105
// rows read a column in the light-client circuit (80 wires, 3 selectors, 6
// constant rows, 12 Lagrange rows, 2 accumulators; 0.53 ms at 2^21), above
// its cheapest form's 1,540 32-bit multiply-adds (0.19 ms); on the card the
// integer pipe bounds it, as the permutation terms (field.cu): with its
// copies cut the kernel runs as long as with them (PERF.md).  The rows
// arrive by bulk asynchronous copies: persistent blocks (two an SM, 16
// warps) walk tiles of GEN_TILE columns, a thread a column; a tile's head
// (selectors, constant rows, Lagrange rows, accumulators: a row's segment a
// copy, the Lagrange rows 8 a copy of a 2-D tensor map) lands in a head slot
// kept for the tile, and the wire rows, GEN_STAGE_ROWS a stage (one tensor
// copy), stream through a ring of GEN_STAGES stages, each completing on an
// mbarrier; the warp that releases a stage (a head) last refills it, so no
// thread only copies and no warp waits for another.  The plan places each
// public input's wire on the host: a column below `visit` is read from the
// stage that holds it, one at or past it from a stage of such columns after
// the visited ones, so no wire row is read twice and the kernel reads the
// columns from shared memory only.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "goldilocks.cuh"
#include "poseidon.cuh"

namespace {

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

constexpr int NCH = 2;  // challenges: one accumulator and one row of alpha powers each

// 128-bit sum of words shifted left: the Horner sums sum_i v_i * 2^i (i < 32,
// at most 64 terms of fewer than 96 bits each, so nothing is lost).
struct Wide {
  uint64_t lo = 0, hi = 0;

  __device__ __forceinline__ void add_shl(uint64_t v, int i) {
    const uint64_t l = v << i;
    const uint64_t h = (v >> 1) >> (63 - i);  // v >> (64 - i), and 0 for i = 0
    lo += l;
    hi += h + (lo < l);
  }

  __device__ __forceinline__ uint64_t reduce() const { return gl::reduce128(lo, hi); }
};

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
constexpr uint64_t INV2 = 0x7FFFFFFF80000001ull;  // 1/2 = (p + 1) / 2
// A block: SHA_TILE adjacent columns, one a thread (ops/kernels.py sha_gate_plan);
// two blocks an SM (99 KB of shared memory each).
constexpr int SHA_TILE = 256;
// Words a staged column: its 32 bits and one of padding, so that the 32
// lanes of a warp reading one bit of 32 adjacent columns hit distinct banks.
constexpr int STAGE_STRIDE = 33;

// The wire layout, given by the wrapper (circuit/gates_sha256.py's constants).
struct ShaLayout {
  int col_wa, col_we, col_ww;     // routed word wires
  int a_bits, e_bits, w_bits;     // first of each 32 bit wires
  int carry_a, carry_e, carry_w;
};

struct ShaArgs {
  const uint64_t* wires;  // wire w at column c: wires[w * stride + c]
  long long stride;
  long long mask;         // n_lde - 1 (n_lde a power of two: neighbours wrap), or all
                          // ones in the window form (WINDOW = true), in which `wires`
                          // points at the first computed column of a window whose
                          // halos hold the neighbours (a shard's points)
  long long n_lde;        // the columns computed
  int step;               // 2^rate: the columns from one trace row to the next
  int halo_ae, halo_w;    // columns staged before a tile: 3 and 15 rows back
  ShaLayout L;
  const uint64_t *k_t, *m_round, *m_sched, *m_bits, *sel;
  const uint64_t* alpha[NCH];
  uint64_t* acc[NCH];     // (n_lde,) updated in place
};

// Stage bit wires [first, first + 32) of the columns (x0 - halo + j) & mask,
// j < SHA_TILE + halo, into stage[j * STAGE_STRIDE + i]: a thread copies
// whole columns, so a warp reads 32 adjacent words of a wire row.  In the
// window form a column past n_lde - 1, which only the threads past n_lde
// read (they store nothing) and which may lie beyond the window, is read at
// n_lde - 1.  Barriers on both sides: the block's reads of the last group
// are done before, and the copies have landed after.
template <bool WINDOW>
__device__ __forceinline__ void stage_bits(const ShaArgs& g, uint64_t* stage, int first,
                                           long long x0, int halo) {
  __syncthreads();
  for (int j = threadIdx.x; j < SHA_TILE + halo; j += SHA_TILE) {
    const long long c = WINDOW ? min(x0 - halo + j, g.n_lde - 1) : (x0 - halo + j) & g.mask;
    const uint64_t* src = g.wires + (long long)first * g.stride + c;
    uint64_t* dst = stage + j * STAGE_STRIDE;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) __pipeline_memcpy_async(dst + i, src + i * g.stride, 8);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// The canonical word of wire w at trace row offset `off` of column x.
__device__ __forceinline__ uint64_t wire_at(const ShaArgs& g, int w, long long x, int off) {
  return g.wires[(long long)w * g.stride + ((x + (long long)off * g.step) & g.mask)];
}

// 1 - 2x of a canonical x, lazy: (p + 1 - x) - x, with no wrap in the first
// subtraction.
__device__ __forceinline__ uint64_t sign_of(uint64_t x) { return gl::sub_lazy(gl::P + 1 - x, x); }

// Staged columns [lo, hi) have their 32 bits replaced by the bits' signs,
// column lo + t by thread t (and lo + t + SHA_TILE).  A barrier before: every
// read of the raw bits is done; and one after where a thread reads columns
// that others turned (`shared`), not only its own.
__device__ __forceinline__ void to_signs(uint64_t* stage, int lo, int hi, bool shared) {
  __syncthreads();
  for (int j = lo + threadIdx.x; j < hi; j += SHA_TILE) {
    uint64_t* col = stage + j * STAGE_STRIDE;
#pragma unroll 4
    for (int i = 0; i < 32; ++i) col[i] = sign_of(col[i]);
  }
  if (shared) __syncthreads();
}

// The first i > lo at which index i + r of a 32-bit word wraps, if below hi.
__host__ __device__ constexpr int wrap_after(int lo, int r, int hi) {
  return 32 - r > lo && 32 - r < hi ? 32 - r : hi;
}

// sum_{lo <= i < hi} 2^i x[i + O0] x[i + O1] (x[i + O2]), added to `sum`: a
// rolled loop whose three loads sit at fixed offsets from one pointer.  The
// weight 2^i goes to the last factor, and the last product is summed
// unreduced.
template <int O0, int O1, int O2, bool THIRD>
__device__ __forceinline__ void sign_segment(const uint64_t* x, int lo, int hi, gl::Acc& sum) {
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    if (THIRD) {
      sum.mac(gl::mul_lazy(x[i + O0], x[i + O1]), gl::shl_lazy(x[i + O2], i));
    } else {
      sum.mac(x[i + O0], gl::shl_lazy(x[i + O1], i));
    }
  }
}

// sum_i 2^i X[(i + R0) % 32] X[(i + R1) % 32] X[(i + R2) % 32] added to `sum`,
// X the signs of a word's bits at x[0..31], the third factor left out where
// SHIFT and i + R2 >= 32 (the shifted word's zero bit, whose sign is 1): that
// is 2^32 - 1 - 2 sigma, sigma = sum_i 2^i xor3 (or xor2) of eval().  The
// loop over i runs in segments [LO, HI) in which no index wraps.
template <int R0, int R1, int R2, bool SHIFT, int LO = 0>
__device__ __forceinline__ void sign_products(const uint64_t* x, gl::Acc& sum) {
  if constexpr (LO < 32) {
    constexpr int HI = wrap_after(LO, R0, wrap_after(LO, R1, wrap_after(LO, R2, 32)));
    sign_segment<(LO < 32 - R0 ? R0 : R0 - 32), (LO < 32 - R1 ? R1 : R1 - 32),
                 (LO < 32 - R2 ? R2 : R2 - 32), !(SHIFT && LO >= 32 - R2)>(x, LO, HI, sum);
    sign_products<R0, R1, R2, SHIFT, HI>(x, sum);
  }
}

// (2^32 - 1 - s) / 2 of the sign sum s: the sigma word.
__device__ __forceinline__ uint64_t sigma_of(const gl::Acc& signs) {
  return gl::mul(INV2, gl::sub(TWO32 - 1, gl::canon(signs.reduce_lazy())));
}

// sum_i 2^i maj(a1[i], a2[i], a3[i]), maj = ab + c (a + b - 2 ab) as eval()
// has it; a1, a2, a3 are the staged columns one, two and three trace rows
// back.
__device__ __forceinline__ uint64_t maj_word(const uint64_t* a1, const uint64_t* a2,
                                             const uint64_t* a3) {
  Wide ab_sum;
  gl::Acc ct;
#pragma unroll 2
  for (int i = 0; i < 32; ++i) {
    const uint64_t a = a1[i], b = a2[i];
    const uint64_t ab = gl::mul_lazy(a, b), ab_c = gl::canon(ab);
    ab_sum.add_shl(ab, i);
    const uint64_t t = gl::sub_lazy(gl::sub_lazy(gl::add_lazy(a, b), ab_c), ab_c);
    ct.mac(gl::shl_lazy(a3[i], i), t);
  }
  return gl::add(ab_sum.reduce(), gl::canon(ct.reduce_lazy()));
}

// sum_i 2^i ch(e1[i], e2[i], e3[i]), ch = g + e (f - g).
__device__ __forceinline__ uint64_t ch_word(const uint64_t* e1, const uint64_t* e2,
                                            const uint64_t* e3) {
  Wide g_sum;
  gl::Acc ef;
#pragma unroll 2
  for (int i = 0; i < 32; ++i) {
    const uint64_t g = e3[i];
    g_sum.add_shl(g, i);
    ef.mac(gl::shl_lazy(e1[i], i), gl::sub_lazy(e2[i], g));
  }
  return gl::add(g_sum.reduce(), gl::canon(ef.reduce_lazy()));
}

// The word-bit consistency and booleanity constraints of group `grp` (a, e,
// w) at offset 0, without their mask: sum_i alpha[K_BOOL + 32 grp + i]
// (b_i^2 - b_i) + alpha[K_WORD + grp] (word - sum_i 2^i b_i), added to
// masked[j] (canonical).
__device__ __forceinline__ void bits_here(const uint64_t* col, uint64_t word,
                                          const uint64_t (*alpha)[SHA_CONSTRAINTS], int grp,
                                          uint64_t (&masked)[NCH]) {
  gl::Acc sum[NCH];
  Wide bits;
#pragma unroll 2
  for (int i = 0; i < 32; ++i) {
    const uint64_t b = col[i];
    bits.add_shl(b, i);
    const uint64_t t = gl::mul_lazy(b, gl::sub_lazy(b, 1));  // b^2 - b
#pragma unroll
    for (int j = 0; j < NCH; ++j) sum[j].mac(alpha[j][K_BOOL + 32 * grp + i], t);
  }
  const uint64_t d = gl::sub(word, bits.reduce());
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    sum[j].mac(alpha[j][K_WORD + grp], d);
    masked[j] = gl::add(masked[j], gl::canon(sum[j].reduce_lazy()));
  }
}

// c (c - 1) ... (c - hi) of a canonical c, lazy.
__device__ __forceinline__ uint64_t range_prod(uint64_t c, int hi) {
  uint64_t acc = c;
  for (int v = 1; v <= hi; ++v) acc = gl::mul_lazy(acc, gl::sub_lazy(c, (uint64_t)v));
  return acc;
}

// Dynamic shared memory: the alpha powers (NCH x SHA_CONSTRAINTS), then the
// staged columns ((SHA_TILE + halo_w) x STAGE_STRIDE).  Every thread runs
// every barrier; a thread past n_lde (n_lde < SHA_TILE) computes on staged
// words of other columns and stores nothing.
template <bool WINDOW>
__global__ void __launch_bounds__(SHA_TILE, 2)
sha_gate_quotient_kernel(ShaArgs g) {
  extern __shared__ uint64_t sha_shared[];
  uint64_t (*alpha)[SHA_CONSTRAINTS] = reinterpret_cast<uint64_t (*)[SHA_CONSTRAINTS]>(sha_shared);
  uint64_t* stage = sha_shared + NCH * SHA_CONSTRAINTS;
  for (int k = threadIdx.x; k < SHA_CONSTRAINTS; k += SHA_TILE) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) alpha[j][k] = g.alpha[j][k];
  }
  const ShaLayout& L = g.L;
  const long long x0 = (long long)blockIdx.x * SHA_TILE;
  const long long x = x0 + threadIdx.x;
  const int back = g.step * STAGE_STRIDE;  // one trace row back, in staged words
  uint64_t masked[NCH] = {0, 0};

  // Each group: the raw bits at offset 0 (word, booleanity) and at -1, -2,
  // -3 (maj, ch), then the signs of the columns the sigma words read.
  // a: S0(a[-1]) + maj(a[-1], a[-2], a[-3])
  stage_bits<WINDOW>(g, stage, L.a_bits, x0, g.halo_ae);
  const int t = threadIdx.x;
  const uint64_t* col = stage + (t + g.halo_ae) * STAGE_STRIDE;  // offset 0
  bits_here(col, wire_at(g, L.col_wa, x, 0), alpha, 0, masked);
  uint64_t s0m = maj_word(col - back, col - 2 * back, col - 3 * back);
  to_signs(stage, g.halo_ae - g.step, g.halo_ae - g.step + SHA_TILE, false);
  {
    gl::Acc signs;
    sign_products<2, 13, 22, false>(col - back, signs);
    s0m = gl::add(s0m, sigma_of(signs));
  }
  // e: S1(e[-1]) + ch(e[-1], e[-2], e[-3])
  stage_bits<WINDOW>(g, stage, L.e_bits, x0, g.halo_ae);
  bits_here(col, wire_at(g, L.col_we, x, 0), alpha, 1, masked);
  uint64_t s1c = ch_word(col - back, col - 2 * back, col - 3 * back);
  to_signs(stage, g.halo_ae - g.step, g.halo_ae - g.step + SHA_TILE, false);
  {
    gl::Acc signs;
    sign_products<6, 11, 25, false>(col - back, signs);
    s1c = gl::add(s1c, sigma_of(signs));
  }
  // w: s1(w[-2]) + s0(w[-15]) = (2 (2^32 - 1) - s) / 2, s both sign sums
  stage_bits<WINDOW>(g, stage, L.w_bits, x0, g.halo_w);
  col = stage + (t + g.halo_w) * STAGE_STRIDE;
  bits_here(col, wire_at(g, L.col_ww, x, 0), alpha, 2, masked);
  to_signs(stage, g.halo_w - 15 * g.step, g.halo_w - 2 * g.step + SHA_TILE, true);
  uint64_t sig;
  {
    gl::Acc signs;
    sign_products<17, 19, 10, true>(col - 2 * back, signs);
    sign_products<7, 18, 3, true>(col - 15 * back, signs);
    sig = gl::sub(TWO32 - 1, gl::mul(INV2, gl::canon(signs.reduce_lazy())));
  }
  if (x >= g.n_lde) return;

  const uint64_t mr = g.m_round[x], ms = g.m_sched[x], mb = g.m_bits[x];
  const uint64_t wa = wire_at(g, L.col_wa, x, 0), we = wire_at(g, L.col_we, x, 0);
  const uint64_t ww = wire_at(g, L.col_ww, x, 0);
  const uint64_t ca = wire_at(g, L.carry_a, x, 0), ce = wire_at(g, L.carry_e, x, 0);
  const uint64_t cw = wire_at(g, L.carry_w, x, 0);
  // round constraint for e: we + ce 2^32 = d + h + S1(e) + ch + K + W
  const uint64_t rhs_e = gl::add(gl::add(wire_at(g, L.col_wa, x, -4), wire_at(g, L.col_we, x, -4)),
                                 gl::add(s1c, gl::add(g.k_t[x], ww)));
  const uint64_t c_round_e = gl::mul(mr, gl::sub(gl::add(we, gl::mul(ce, TWO32)), rhs_e));
  // round constraint for a, differenced: (wa - we) + (ca - ce) 2^32 = S0(a) + maj - d
  const uint64_t lhs_a = gl::add(gl::sub(wa, we), gl::mul(gl::sub(ca, ce), TWO32));
  const uint64_t c_round_a = gl::mul(mr, gl::sub(lhs_a, gl::sub(s0m, wire_at(g, L.col_wa, x, -4))));
  // schedule: ww + cw 2^32 = s1(w[-2]) + w[-7] + s0(w[-15]) + w[-16]
  const uint64_t rhs_w = gl::add(sig, gl::add(wire_at(g, L.col_ww, x, -7),
                                              wire_at(g, L.col_ww, x, -16)));
  const uint64_t c_sched = gl::mul(ms, gl::sub(gl::add(ww, gl::mul(cw, TWO32)), rhs_w));

  // The constraints that carry their mask already, weighted: 6 products.
  gl::Acc single[NCH];
  const uint64_t c_carry[3] = {gl::mul_lazy(mr, range_prod(ca, 6)),
                               gl::mul_lazy(mr, range_prod(ce, 6)),
                               gl::mul_lazy(ms, range_prod(cw, 3))};
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    single[j].mac(alpha[j][K_ROUND_E], c_round_e);
    single[j].mac(alpha[j][K_ROUND_A], c_round_a);
    single[j].mac(alpha[j][K_SCHED], c_sched);
#pragma unroll
    for (int c = 0; c < 3; ++c) single[j].mac(alpha[j][K_CARRY + c], c_carry[c]);
  }
  const uint64_t s = g.sel[x];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const uint64_t total = gl::add(gl::canon(single[j].reduce_lazy()), gl::mul(mb, masked[j]));
    g.acc[j][x] = gl::add(g.acc[j][x], gl::mul(s, total));
  }
}

// ---------------------------------------------------------------------------
// Poseidon gate (circuit/gates_poseidon.py PoseidonGate.eval)
// ---------------------------------------------------------------------------

constexpr int NUM_ADVICE = 2 * HALF_FULL * WIDTH + PARTIAL;  // 118
constexpr int POSEIDON_CONSTRAINTS = NUM_ADVICE + WIDTH;       // 130

struct PoseidonArgs {
  const uint64_t* wires;  // wire w at column c: wires[w * stride + c]
  long long stride;
  long long n_lde;
  int w_in, w_out, w_adv;  // the layout (circuit/gates_poseidon.py)
  const uint64_t* sel;
  const uint64_t* alpha[NCH];
  uint64_t* acc[NCH];      // (n_lde,) updated in place
};

using PoseidonAlpha = const uint64_t (*)[POSEIDON_CONSTRAINTS];

// A full round r of eval(): constraints k0 .. k0 + 11 are
// x^7(st[i] + rc[r][i]) - adv[k0 + i]; the advice words become the state,
// and the dense layer follows.  `adv` points at this column's first advice
// word, a wire row apart.  The round's weighted constraints are summed in
// 96-bit column sums and folded into sum[j] (lazy) before the dense layer,
// whose 16-bit limbs need the registers.  lazy -> lazy.
__device__ __forceinline__ void gate_full_round(uint64_t (&st)[WIDTH], int r, int k0,
                                                const uint64_t* adv, long long stride,
                                                PoseidonAlpha alpha, uint64_t (&sum)[NCH]) {
  gl::Acc round[NCH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    const uint64_t a = adv[(long long)(k0 + i) * stride];
    const uint64_t c = gl::sub_lazy(sbox(gl::add_lazy(st[i], C.rc_full[r][i])), a);
#pragma unroll
    for (int j = 0; j < NCH; ++j) round[j].mac(alpha[j][k0 + i], c);
    st[i] = a;
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j) sum[j] = gl::add_lazy(round[j].reduce_lazy(), gl::canon(sum[j]));
  mds(st);
}

// The 22 partial rounds in the sparse form (poseidon.cu `partial_rounds`),
// the advice word of round r in the place of its S-box output: constraint
// HALF_FULL * WIDTH + r is x^7(st[0]) - adv.  lazy -> lazy.
__device__ __forceinline__ void gate_partial_rounds(uint64_t (&st)[WIDTH], const uint64_t* adv,
                                                    long long stride, PoseidonAlpha alpha,
                                                    uint64_t (&sum)[NCH]) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) st[i] = gl::add_lazy(st[i], C.first[i]);
  uint64_t t[WIDTH - 1];
#pragma unroll
  for (int i = 0; i < WIDTH - 1; ++i) {
    gl::Acc acc;
#pragma unroll
    for (int j = 0; j < WIDTH - 1; ++j) acc.mac(C.init[i][j], st[j + 1]);
    t[i] = acc.reduce_lazy();
  }
#pragma unroll
  for (int i = 0; i < WIDTH - 1; ++i) st[i + 1] = t[i];
#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) {
    const int k = HALF_FULL * WIDTH + r;
    const uint64_t a = adv[(long long)k * stride];
    const uint64_t c = gl::sub_lazy(sbox(st[0]), a);
#pragma unroll
    for (int j = 0; j < NCH; ++j) sum[j] = gl::mul_add_lazy(alpha[j][k], c, sum[j]);
    const uint64_t s0 = gl::add_lazy(a, C.scalar[r]);
    gl::Acc acc;
    acc.mac(C.row[r][0], s0);
#pragma unroll
    for (int i = 1; i < WIDTH; ++i) acc.mac(C.row[r][i], st[i]);
#pragma unroll
    for (int i = 1; i < WIDTH; ++i) st[i] = gl::mul_add_lazy(C.col[r][i - 1], s0, st[i]);
    st[0] = acc.reduce_lazy();
  }
}

// One thread a column, no barrier after the alpha powers are loaded.  The
// tables are this source's copy of the sponge's constants (poseidon.cuh),
// filled by elp_poseidon_gate_set_constants.
__global__ void __launch_bounds__(256, 2)
poseidon_gate_quotient_kernel(PoseidonArgs g) {
  __shared__ uint64_t alpha[NCH][POSEIDON_CONSTRAINTS];
  for (int k = threadIdx.x; k < POSEIDON_CONSTRAINTS; k += blockDim.x) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) alpha[j][k] = g.alpha[j][k];
  }
  __syncthreads();
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= g.n_lde) return;
  const uint64_t* col = g.wires + x;
  const uint64_t* adv = col + (long long)g.w_adv * g.stride;

  uint64_t st[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) st[i] = col[(long long)(g.w_in + i) * g.stride];
  uint64_t sum[NCH] = {0, 0};  // sum_k alpha_j[k] C_k so far, lazy
#pragma unroll 1
  for (int r = 0; r < 2 * HALF_FULL; ++r) {
    gate_full_round(st, r, WIDTH * r + (r < HALF_FULL ? 0 : PARTIAL), adv, g.stride, alpha, sum);
    if (r == HALF_FULL - 1) gate_partial_rounds(st, adv, g.stride, alpha, sum);
  }
  gl::Acc out[NCH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    const uint64_t c = gl::sub(col[(long long)(g.w_out + i) * g.stride], gl::canon(st[i]));
#pragma unroll
    for (int j = 0; j < NCH; ++j) out[j].mac(alpha[j][NUM_ADVICE + i], c);
  }
  const uint64_t s = g.sel[x];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const uint64_t total = gl::add_lazy(out[j].reduce_lazy(), gl::canon(sum[j]));
    g.acc[j][x] = gl::add(g.acc[j][x], gl::mul(s, total));
  }
}

// ---------------------------------------------------------------------------
// The generic gates and the public inputs (circuit/gates.py)
// ---------------------------------------------------------------------------

constexpr int GEN_MAX_CONSTRAINTS = 256;  // a gate's constraints: one gl::Acc, no reduction between
constexpr int GEN_BS_MAX_BITS = 32;       // BaseSum2Gate bits a slot (its 33 wires a slot)
constexpr int GEN_BS_STRIDE = 33;         // wires a BaseSum2Gate slot
// The ring; ops/kernels.py generic_gate_plan mirrors it.  Persistent blocks
// (GEN_MIN_BLOCKS an SM of GEN_TILE threads) walk tiles of `tile` columns
// (GEN_TILE, or fewer where the head would not fit beside a ring of two
// stages), one thread a column, a block max(32, tile) threads.  A tile's head, kept
// for the whole tile in the head slot: the gates' selectors, the constant
// rows they read, the public inputs' Lagrange rows and the two accumulators
// (head rows h_sel, h_const, h_lr, h_acc).  One slot: two held a block to
// one an SM (PERF.md).  Its wire rows
// stream through a ring of `ring` stages (GEN_STAGES, or down to 2 where the
// head would not fit) of GEN_STAGE_ROWS rows: the `visit` columns in order,
// then the public inputs' columns at or past `visit` (`extra`, each once).
constexpr int GEN_TILE = 256;
constexpr int GEN_STAGE_ROWS = 8;
constexpr int GEN_STAGES = 4;
constexpr int GEN_MIN_BLOCKS = 2;

// Each generic gate at most once; a null selector leaves the gate out.
struct GenericArgs {
  const uint64_t* wires;   // wire w at column x: wires[w * wires_stride + x]
  long long wires_stride;
  const uint64_t* consts;  // constant column i at column x: consts[i * consts_stride + x]
  long long consts_stride;
  const uint64_t* sel[3];     // the selector rows of arith, basesum2, const
  int arith_ops;              // ArithmeticGate(num_ops)
  int bs_bits, bs_slots;      // BaseSum2Gate(num_bits, num_slots)
  int const_slots;            // ConstantGate(num_slots)
  int visit;                  // wire columns visited: the most any of the three reads
  int nconst;                 // constant columns in the head: the most any of the three reads
  const uint64_t* lr;         // public input i's Lagrange row: lr[i * lr_stride + x]
  long long lr_stride;
  const uint64_t* pi;         // (num_pi,) the public inputs
  int num_pi;
  // the plan's table (ints): the public inputs in stage order, i | slot << 16
  // (num_pi); each stage's first entry, and the count (stages + 1); the
  // columns at or past visit (extra)
  const int* table;
  int stages, extra;
  int ring;                   // stages of the ring: 2 to GEN_STAGES
  const uint64_t* alpha[NCH]; // alpha_j^0, alpha_j^1, ...: reads [pi0, pi0 + num_pi), [k0, k0 + slots)
  int pi0, k0, slots;         // slots: the most constraints of the three gates
  uint64_t* acc[NCH];         // (n_lde,) updated in place
  long long n_lde, tiles;
  int tile;
  int head_rows, h_sel[3], h_const, h_lr, h_acc;  // h_sel -1 for an absent gate
  // the visited wire rows and the Lagrange rows in boxes of GEN_STAGE_ROWS
  // rows of a tile (made where there are that many); fewer rows are copied
  // row by row
  CUtensorMap wires_map, lr_map;
};

// Fill the head slot `h` with the head of the tile at column c0: one bulk
// copy a row's segment (a tensor copy of GEN_STAGE_ROWS Lagrange rows),
// completing on its barrier.
__device__ __forceinline__ void gen_fill_head(const GenericArgs& g, uint64_t* h, uint64_t* hfull,
                                              long long c0) {
  const int T = g.tile;
  const uint32_t seg = (uint32_t)T * 8;
  mbar_expect_tx(hfull, g.head_rows * seg);
  for (int q = 0; q < 3; ++q)
    if (g.h_sel[q] >= 0) bulk_copy(h + g.h_sel[q] * T, g.sel[q] + c0, seg, hfull);
  for (int i = 0; i < g.nconst; ++i)
    bulk_copy(h + (g.h_const + i) * T, g.consts + i * g.consts_stride + c0, seg, hfull);
  int i = 0;
  for (; i + GEN_STAGE_ROWS <= g.num_pi; i += GEN_STAGE_ROWS)
    bulk_copy_rows(h + (g.h_lr + i) * T, &g.lr_map, (int)c0, i, hfull);
  for (; i < g.num_pi; ++i)
    bulk_copy(h + (g.h_lr + i) * T, g.lr + i * g.lr_stride + c0, seg, hfull);
  for (int j = 0; j < NCH; ++j) bulk_copy(h + (g.h_acc + j) * T, g.acc[j] + c0, seg, hfull);
}

// Fill ring slot s with wire stage st of the tile at column c0 (a tensor copy
// of GEN_STAGE_ROWS visited rows, or a bulk copy a row).
__device__ __forceinline__ void gen_fill_stage(const GenericArgs& g, uint64_t* ring, uint64_t* full,
                                               const int* extra, int s, long long c0, int st,
                                               int wire_stages) {
  const int T = g.tile;
  const uint32_t seg = (uint32_t)T * 8;
  uint64_t* dst = ring + (long long)s * GEN_STAGE_ROWS * T;
  const int w0 = st * GEN_STAGE_ROWS, e0 = (st - wire_stages) * GEN_STAGE_ROWS;
  const int nr = st < wire_stages ? min(GEN_STAGE_ROWS, g.visit - w0)
                                  : min(GEN_STAGE_ROWS, g.extra - e0);
  mbar_expect_tx(&full[s], nr * seg);
  if (st < wire_stages && nr == GEN_STAGE_ROWS) {
    bulk_copy_rows(dst, &g.wires_map, (int)c0, w0, &full[s]);
    return;
  }
  for (int r = 0; r < nr; ++r) {
    const long long col = st < wire_stages ? w0 + r : extra[e0 + r];
    bulk_copy(dst + r * T, g.wires + col * g.wires_stride + c0, seg, &full[s]);
  }
}

// acc_j[x] += sum over the public inputs and the generic gates, canonical.
// Block b takes the tiles b, b + gridDim.x, ..., thread xt column xt of each.
// No thread is only a producer: thread 0 fills the first head and stages,
// and the warp that releases a stage (a tile's head) last refills its slot
// with stage it + ring (the next tile's head; last_to_release), so no thread
// only copies, GEN_MIN_BLOCKS of GEN_TILE threads fit an SM, and no warp
// waits for another.  Dynamic shared memory: the ring (ring x GEN_STAGE_ROWS x tile
// words), the head slot (head_rows x tile), per challenge the alpha powers
// of the public inputs, then of the constraint slots; the public inputs'
// words; the full barriers of the stages and the head; then ints: the
// release counts of the stages and the head, and the table.
__global__ void __launch_bounds__(GEN_TILE, GEN_MIN_BLOCKS)
generic_gate_quotient_kernel(const __grid_constant__ GenericArgs g) {
  extern __shared__ __align__(128) uint64_t gen_smem[];
  const int T = g.tile, per = g.num_pi + g.slots;
  uint64_t* ring = gen_smem;
  uint64_t* head = ring + (long long)g.ring * GEN_STAGE_ROWS * T;
  uint64_t* alpha = head + (long long)g.head_rows * T;  // alpha[j * per + i]: public input i
  uint64_t* pi = alpha + NCH * per;                                 //   then slot k at j * per + num_pi + k
  uint64_t* full = pi + g.num_pi;
  uint64_t* hfull = full + g.ring;
  int* released = reinterpret_cast<int*>(hfull + 1);  // the stages', then the head's
  int* table = released + g.ring + 1;
  const int warps = blockDim.x / 32;
  const int* pi_order = table;                      // i | slot << 16, in stage order
  const int* pi_first = table + g.num_pi;           // stage s: entries [pi_first[s], pi_first[s + 1])
  const int* extra = pi_first + g.stages + 1;       // the columns at or past visit
  const int wire_stages = (g.visit + GEN_STAGE_ROWS - 1) / GEN_STAGE_ROWS;
  const long long c_step = (long long)gridDim.x * T, c_end = g.tiles * T;
  // a position in the block's walk of wire stages: its tile's first column and
  // its stage in the tile
  struct Pos {
    long long c0;
    int st;
  };
  const auto step = [&](Pos& p) {
    if (++p.st == g.stages) {
      p.st = 0;
      p.c0 += c_step;
    }
  };
  for (int t = threadIdx.x; t < per; t += blockDim.x) {
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      alpha[j * per + t] = t < g.num_pi ? g.alpha[j][g.pi0 + t] : g.alpha[j][g.k0 + t - g.num_pi];
  }
  for (int t = threadIdx.x; t < g.num_pi; t += blockDim.x) pi[t] = g.pi[t];
  for (int t = threadIdx.x; t < g.num_pi + g.stages + 1 + g.extra; t += blockDim.x)
    table[t] = g.table[t];
  __syncthreads();  // the extra columns, before thread 0 fills a stage
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.ring; ++s) mbar_init(&full[s], 1);
    mbar_init(hfull, 1);
    for (int s = 0; s <= g.ring; ++s) released[s] = 0;
    mbar_fence_init();
  }
  // the walk: the next stage to fill (`ring` ahead of the one read) and the
  // next tile's head
  Pos fill{(long long)blockIdx.x * T, 0};
  long long head_c0 = (long long)blockIdx.x * T;
  if (threadIdx.x == 0) {
    if (head_c0 < c_end) gen_fill_head(g, head, hfull, head_c0);
    for (int s = 0; s < g.ring && fill.c0 < c_end; ++s, step(fill))
      gen_fill_stage(g, ring, full, extra, s, fill.c0, fill.st, wire_stages);
  } else {
    for (int s = 0; s < g.ring; ++s) step(fill);
  }
  head_c0 += c_step;
  __syncthreads();
  // a thread past the tile (a tile below 32 columns) computes column 0's
  // words and stores nothing: no branch in the loops
  const int xt = threadIdx.x;
  const bool live = xt < T;
  const int xc = live ? xt : 0;
  const uint64_t* ak[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) ak[j] = alpha + j * per + g.num_pi;
  int s = 0;
  uint32_t phase = 0, hphase = 0;
  for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    mbar_wait(hfull, hphase);
    const uint64_t* h = head + xc;
    const uint64_t c0 = g.nconst > 0 ? h[g.h_const * T] : 0;
    const uint64_t c1 = g.nconst > 1 ? h[(g.h_const + 1) * T] : 0;
    uint64_t total[NCH];           // the public inputs' terms, lazy
    gl::Acc arith[NCH], bs[NCH], cst[NCH];
#pragma unroll
    for (int j = 0; j < NCH; ++j) total[j] = 0;
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
        const uint64_t cw = w == 0 ? c0 : w == 1 ? c1 : h[(g.h_const + w) * T];
        const uint64_t con = gl::sub(v, cw);
#pragma unroll
        for (int j = 0; j < NCH; ++j) cst[j].mac(ak[j][w], con);
      }
    };
    for (int st = 0; st < g.stages; ++st) {
      mbar_wait(&full[s], phase);
      const uint64_t* row = ring + (long long)s * GEN_STAGE_ROWS * T + xc;
      {
        if (st < wire_stages) {
          const int w0 = st * GEN_STAGE_ROWS;
#pragma unroll 1
          for (int q0 = 0; q0 < GEN_STAGE_ROWS; q0 += 4) {  // as rolled as the roles allow
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (w0 + q0 + q < g.visit) visit(w0 + q0 + q, row[(q0 + q) * T]);
          }
        }
        // the public inputs whose column this stage holds: lr_i (w_{c_i} - pi_i)
        for (int p = pi_first[st]; p < pi_first[st + 1]; ++p) {
          const int i = pi_order[p] & 0xFFFF, q = pi_order[p] >> 16;
          const uint64_t t = gl::mul_lazy(h[(g.h_lr + i) * T], gl::sub(row[q * T], pi[i]));
#pragma unroll
          for (int j = 0; j < NCH; ++j) total[j] = gl::mul_add_lazy(alpha[j * per + i], t, total[j]);
        }
      }
      if (last_to_release(&released[s], warps) && fill.c0 < c_end)
        gen_fill_stage(g, ring, full, extra, s, fill.c0, fill.st, wire_stages);
      step(fill);
      if (++s == g.ring) {
        s = 0;
        phase ^= 1;
      }
    }
    if (live) {
      const long long x = tile * T + xt;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        total[j] = gl::canon(total[j]);
        if (g.h_sel[0] >= 0) total[j] = gl::add(total[j], gl::mul(h[g.h_sel[0] * T], arith[j].reduce_lazy()));
        if (g.h_sel[1] >= 0) total[j] = gl::add(total[j], gl::mul(h[g.h_sel[1] * T], bs[j].reduce_lazy()));
        if (g.h_sel[2] >= 0) total[j] = gl::add(total[j], gl::mul(h[g.h_sel[2] * T], cst[j].reduce_lazy()));
        g.acc[j][x] = gl::add(h[(g.h_acc + j) * T], total[j]);
      }
    }
    if (last_to_release(&released[g.ring], warps) && head_c0 < c_end)
      gen_fill_head(g, head, hfull, head_c0);
    head_c0 += c_step;
    hphase ^= 1;
  }
}

unsigned blocks_for(long long count, int threads) {
  return (unsigned)((count + threads - 1) / threads);
}

const uint64_t* words(const void* p) { return static_cast<const uint64_t*>(p); }

}  // namespace

// One launch for the two challenges, `acc0` and `acc1` updated in place (they
// overlap no input).  `n_lde` is a power of two, at least 2, and `mask` is
// n_lde - 1, or -1 for the window form (ShaArgs); `layout` is 9 ints in
// ShaLayout's order (read on the host); `halo_ae` and `halo_w` are
// ops/kernels.py sha_gate_plan's (at least 3 and 15 rows of 2^rate columns).
extern "C" int elp_sha_gate_quotient(const void* wires, long long stride, long long n_lde,
                                     long long mask, int rate, const int* layout,
                                     const void* k_t, const void* m_round, const void* m_sched,
                                     const void* m_bits, const void* sel, const void* alpha0,
                                     const void* alpha1, void* acc0, void* acc1, int halo_ae,
                                     int halo_w, void* stream) {
  if (n_lde < 2 || (n_lde & (n_lde - 1)) || (mask != n_lde - 1 && mask != -1) || rate < 0 ||
      rate > 8 || halo_ae < (3 << rate) || halo_w < (15 << rate) || halo_ae > halo_w)
    return (int)cudaErrorInvalidValue;
  const size_t shared = ((size_t)NCH * SHA_CONSTRAINTS + (size_t)STAGE_STRIDE * (SHA_TILE + halo_w))
                        * sizeof(uint64_t);
  const auto kernel = mask == -1 ? sha_gate_quotient_kernel<true> : sha_gate_quotient_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return (int)err;
  ShaArgs g{};
  g.wires = words(wires);
  g.stride = stride;
  g.mask = mask;
  g.n_lde = n_lde;
  g.step = 1 << rate;
  g.halo_ae = halo_ae;
  g.halo_w = halo_w;
  g.L = ShaLayout{layout[0], layout[1], layout[2], layout[3], layout[4],
                  layout[5], layout[6], layout[7], layout[8]};
  g.k_t = words(k_t);
  g.m_round = words(m_round);
  g.m_sched = words(m_sched);
  g.m_bits = words(m_bits);
  g.sel = words(sel);
  g.alpha[0] = words(alpha0);
  g.alpha[1] = words(alpha1);
  g.acc[0] = static_cast<uint64_t*>(acc0);
  g.acc[1] = static_cast<uint64_t*>(acc1);
  kernel<<<blocks_for(n_lde, SHA_TILE), SHA_TILE, shared, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

// image: host pointer to a PoseidonConsts image (poseidon.cuh), for the
// Poseidon gate's kernel.
extern "C" int elp_poseidon_gate_set_constants(const void* image, long long bytes, void* stream) {
  return set_poseidon_constants(image, bytes, stream);
}

// One launch for the two challenges, `acc0` and `acc1` updated in place.
// `layout` is (w_in, w_out, w_adv).
extern "C" int elp_poseidon_gate_quotient(const void* wires, long long stride, long long n_lde,
                                          const int* layout, const void* sel,
                                          const void* alpha0, const void* alpha1, void* acc0,
                                          void* acc1, int threads, void* stream) {
  if (n_lde < 1 || (n_lde & (n_lde - 1)) || threads < 1 || threads > 256)
    return (int)cudaErrorInvalidValue;
  PoseidonArgs g{};
  g.wires = words(wires);
  g.stride = stride;
  g.n_lde = n_lde;
  g.w_in = layout[0];
  g.w_out = layout[1];
  g.w_adv = layout[2];
  g.sel = words(sel);
  g.alpha[0] = words(alpha0);
  g.alpha[1] = words(alpha1);
  g.acc[0] = static_cast<uint64_t*>(acc0);
  g.acc[1] = static_cast<uint64_t*>(acc1);
  poseidon_gate_quotient_kernel<<<blocks_for(n_lde, threads), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

// One launch for the two challenges; `acc0`, `acc1` are updated in place and
// overlap no input.  `sel` holds the three gates' selector rows (null for an
// absent gate); `head` is (h_sel[3], h_const, h_lr, h_acc) of `head_rows`;
// `table` the device ints of the public inputs' stage order, the stages'
// first entries and the extra columns; every row starts 16-byte aligned with
// an even row stride; `tile` columns a tile (at least 16: a tensor copy's
// shared memory is 128-byte aligned), `ring` stages, `blocks` persistent
// blocks of max(32, tile) threads.  The
// gates' parameters, the alpha offsets and the layout are ops/kernels.py
// `generic_gate_plan`'s.
extern "C" int elp_generic_gate_quotient(const void* wires, long long wires_stride,
                                         const void* consts, long long consts_stride,
                                         const void* const* sel, int arith_ops, int bs_bits,
                                         int bs_slots, int const_slots, int nconst,
                                         const void* lr, long long lr_stride, const void* pi,
                                         int num_pi, const void* table, int stages, int extra,
                                         const int* head, int head_rows, int ring,
                                         const void* alpha0,
                                         const void* alpha1, int pi0, int k0, void* acc0,
                                         void* acc1, long long n_lde, int tile, int blocks,
                                         void* stream) {
  const int arith = arith_ops, bs = bs_slots * (1 + bs_bits), cst = const_slots;
  const int slots = arith > bs ? (arith > cst ? arith : cst) : (bs > cst ? bs : cst);
  int visit = 4 * arith_ops;
  if (GEN_BS_STRIDE * bs_slots > visit) visit = GEN_BS_STRIDE * bs_slots;
  if (const_slots > visit) visit = const_slots;
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  const bool present[3] = {arith_ops > 0, bs_slots > 0, const_slots > 0};
  const int wire_stages = (visit + GEN_STAGE_ROWS - 1) / GEN_STAGE_ROWS;
  bool bad = n_lde < 16 || n_lde > (1ll << 30) || tile < 16 || tile > GEN_TILE || (tile & 15) || n_lde % tile ||
             blocks < 1 || arith_ops < 0 || bs_slots < 0 || const_slots < 0 || bs_bits < 0 ||
             bs_bits > GEN_BS_MAX_BITS || num_pi < 0 || num_pi > 0xFFFF ||
             slots >= GEN_MAX_CONSTRAINTS || nconst < const_slots || nconst < (arith_ops ? 2 : 0) ||
             (nconst > 1 && (consts_stride & 1)) || (nconst && misaligned(consts)) ||
             (num_pi > 1 && (lr_stride & 1)) || (num_pi && misaligned(lr)) ||
             (wires_stride & 1) || misaligned(wires) || misaligned(acc0) || misaligned(acc1) ||
             extra < 0 || stages != wire_stages + (extra + GEN_STAGE_ROWS - 1) / GEN_STAGE_ROWS ||
             ring < 2 || ring > GEN_STAGES ||
             (num_pi + stages && !table) || head[3] < 0 || head[3] + nconst > head_rows ||
             head[4] < 0 || head[4] + num_pi > head_rows || head[5] < 0 ||
             head[5] + NCH != head_rows;
  for (int q = 0; q < 3; ++q)
    bad = bad || present[q] != (sel[q] != nullptr) || (present[q] && misaligned(sel[q])) ||
          (present[q] ? head[q] < 0 || head[q] >= head_rows : head[q] != -1);
  if (bad) return (int)cudaErrorInvalidValue;
  const size_t shared =
      ((size_t)ring * GEN_STAGE_ROWS * tile + (size_t)head_rows * tile +
       (size_t)NCH * (num_pi + slots) + num_pi + ring + 1) * sizeof(uint64_t) +
      (size_t)(ring + 1 + num_pi + stages + 1 + extra) * sizeof(int);
  if (shared > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(generic_gate_quotient_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  GenericArgs g{};
  g.wires = words(wires);
  g.wires_stride = wires_stride;
  g.consts = words(consts);
  g.consts_stride = consts_stride;
  for (int q = 0; q < 3; ++q) {
    g.sel[q] = words(sel[q]);
    g.h_sel[q] = head[q];
  }
  g.arith_ops = arith_ops;
  g.bs_bits = bs_bits;
  g.bs_slots = bs_slots;
  g.const_slots = const_slots;
  g.visit = visit;
  g.nconst = nconst;
  g.lr = words(lr);
  g.lr_stride = lr_stride;
  g.pi = words(pi);
  g.num_pi = num_pi;
  g.table = static_cast<const int*>(table);
  g.stages = stages;
  g.extra = extra;
  g.ring = ring;
  g.alpha[0] = words(alpha0);
  g.alpha[1] = words(alpha1);
  g.pi0 = pi0;
  g.k0 = k0;
  g.slots = slots;
  g.acc[0] = static_cast<uint64_t*>(acc0);
  g.acc[1] = static_cast<uint64_t*>(acc1);
  g.n_lde = n_lde;
  g.tiles = n_lde / tile;
  g.tile = tile;
  g.head_rows = head_rows;
  g.h_const = head[3];
  g.h_lr = head[4];
  g.h_acc = head[5];
  if (visit >= GEN_STAGE_ROWS &&
      (err = (cudaError_t)rows_map(&g.wires_map, wires, visit, n_lde, wires_stride, GEN_STAGE_ROWS,
                                   tile)))
    return (int)err;
  if (num_pi >= GEN_STAGE_ROWS &&
      (err = (cudaError_t)rows_map(&g.lr_map, lr, num_pi, n_lde, lr_stride, GEN_STAGE_ROWS, tile)))
    return (int)err;
  generic_gate_quotient_kernel<<<(unsigned)blocks, tile < 32 ? 32 : tile, shared,
                                 static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

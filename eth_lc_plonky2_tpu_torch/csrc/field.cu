// Goldilocks field kernels: the elementwise operations, and fused passes of
// the prover that eager PyTorch would run as long chains of them.
//
// 1. field_binary_kernel, field_inv_kernel: add, sub, mul of two operands
//    with broadcasting, and the multiplicative inverse.  Replace
//    eth_lc_plonky2_tpu/ops/goldilocks.py:143-301 (`add`, `sub`, `mul`,
//    `square`, `inv`).  The JAX package has no Pallas kernel for them: XLA
//    fuses the u32-limb arithmetic into its neighbours on the TPU.  Eager
//    PyTorch does not fuse, and a product written as tensor ops is some 35
//    launches and as many passes over the array, so on the card each
//    operation is one launch here: one load an operand, one store an element.
//
//    Addressing.  The output is a contiguous (rows, cols) array.  Each
//    operand is read at base[r * stride_r + c * stride_c] (strides in words),
//    so the wrapper passes 0 for a broadcast axis: a scalar is (0, 0), a row
//    (1, n) against (r, n) is (0, 1), a column (r, 1) is (1, 0), and a strided
//    slice keeps its own strides.  Threads run along cols, so neighbouring
//    threads read neighbouring words of every operand that has stride_c = 1.
//    One path serves every form: a contiguous path with 16-byte word pairs
//    and 32-bit indices ran at the same 0.140 ms a launch at (8, 2^21) on an
//    H100 (PERF.md section 6), so it was not kept.
//
//    What bounds it: memory traffic.  A binary op on same-shape operands
//    moves 24 bytes an element (0.120 ms for (8, 2^21) at 3.35 TB/s) against
//    one 64 x 64 product and its reduction, about 20 integer instructions.
//    The inverse is Montgomery's batch trick (gl::batch_div): a thread takes
//    a run of INV_RUN = 16 words, their prefix products, ONE Fermat power
//    a^(p-2) (63 squarings and 9 products) and the walk back, so about 3 +
//    72 / 16 products a word instead of 72 (a zero word is skipped and its
//    inverse is 0).  That makes it bound by memory, 16 bytes a word, where
//    the word-by-word Fermat power of earlier versions was bound by
//    operations at 3.3 times the time.
//
// 2. field_open_kernel (+ field_open_sum_kernel): the openings, the values of
//    (rows, n) base-field coefficient rows at k points of the quadratic
//    extension, sum_c coeffs[r][c] * z_j^c.  Replaces what XLA fuses of
//    eth_lc_plonky2_tpu/prover/prove.py:551 `_open_core` (ext powers by
//    log-doubling, two products and two sums over (rows, n) a point), which
//    eager PyTorch ran as some 276 launches a point.  A block owns a slice of
//    columns and a group of rows; each warp takes one point and a few rows,
//    so the block's warps read the same coefficient words (from device memory
//    once, then from L1) for all of its points.  A thread works out z^c for
//    its columns in registers, z^c0 by square-and-multiply and then steps of
//    z^32, and accumulates coeff * re and coeff * im in 96-bit column sums
//    (gl::Acc: one reduction an output word).  A warp adds up its lanes with
//    shuffles and writes one partial sum a row, point and slice; a second,
//    small launch adds the slices.  What bounds it: operations, two 64 x 64
//    products a coefficient a point (W: 184 x 2^18 words at 8 points), a
//    little above the bytes' time for phase 7's four batches; the powers cost
//    one ext product a column a point a thread besides (about a third of a
//    lane's instructions at 4 rows a thread), and a column's words are loaded
//    one column ahead.
//
// 3. perm_quotient_kernel: the permutation argument's terms of the quotient,
//    for both challenges, in one pass: term 0, l0 * (Z - 1), and for each
//    chunk k of `chunk` routed columns
//        chain[k+1] * prod_i (w_i + beta sigma_i + gamma)
//          - chain[k] * prod_i (w_i + beta k_i x + gamma),
//    each times its power of alpha, summed into one accumulator a challenge
//    (chain = [Z, partials..., Z at the next row]).  Replaces what XLA fuses
//    of eth_lc_plonky2_tpu/prover/prove.py:457-481 inside the jitted quotient
//    (:534); eager PyTorch ran it as some 358 launches over (8, n_lde)
//    temporaries.  One thread a column keeps both challenges' running
//    products in registers; beta k_i, the alpha powers, beta and gamma sit in
//    shared memory; the routed wires and sigma rows are read through their
//    row strides (sigma as rows of the preprocessed LDE, no copy), and Z at
//    the next row is column (x + 2^rate) mod n_lde, as ops/ntt.py `roll_lde`
//    (in the window form, WINDOW = true, a shard's points: column x + 2^rate
//    of a window whose halo holds it, unwrapped; the one-device form is the
//    other instantiation, the kernel as it was).
//    What bounds it: memory, 182 words read and 2 written a column (80 wires,
//    80 sigmas, 20 Z rows, x, l0; 3.1 GB at 2^21) against 686 products; each
//    word is loaded one step ahead of its use.
//
// 4. fri_g_kernel: FRI's combined opening polynomial on the LDE coset,
//        G(x) = sum_j a_{total+j} (B_{tag(j)}(x) - y_j) / (x - z_j),
//        B_t(x) = sum_i a_{off_t+i} lde_t[i](x)
//    (base rows, ext weights a, ext points z_j and values y_j).  Replaces
//    what XLA fuses of eth_lc_plonky2_tpu/prover/fri.py:72 `make_g_kernel`
//    (jitted at :166), which eager PyTorch ran as some 277 launches and a
//    batched inversion of the (S, n_lde) norms.  One thread a column reads
//    every row of the four batches once (P, W, Z, Q: 312 rows in phase 7),
//    keeping the four ext sums in 96-bit column sums (a reduction every 128
//    rows); the weights sit in shared memory.  Then it takes the S specs in
//    registers: the norm (x - z_re)^2 - 7 z_im^2 of each, ONE Fermat
//    inversion for all S by Montgomery's trick (gl::batch_prefix, then
//    gl::batch_back a spec on the way back, each inverse consumed as it
//    comes; a zero norm is skipped, so its inverse is 0, as the plain
//    version's), and the weighted sum.  What
//    bounds it: memory, 312 rows read a column (5.2 GB at 2^21), against
//    about 2,500 multiply-adds a column for the sums.
//
// 5. fri_fold_kernel: one radix-2 FRI fold, 2h ext words to h:
//        ((e0 + e1) / 2) + beta (e0 - e1) w^-i / (2 shift)
//    with e0, e1 the words i and i + h.  Replaces
//    eth_lc_plonky2_tpu/prover/fri.py:170 `_fold_core` (@jit) and the table
//    product before it; eager PyTorch ran 18 launches a layer.  One thread an
//    output word: five words read (re, im of both halves, w^-i from the
//    cached table), two written; bound by memory (56 bytes an output word).
//
// 6. perm_z_kernel, perm_z_scan_kernel, perm_z_fixup_kernel: the permutation
//    argument's rows [Z, p_0, ..., p_{m-2}] on the subgroup, for every
//    challenge, in three launches: with num_k and den_k the products over
//    chunk k of (w_i + beta k_i omega^x + gamma) and (w_i + beta sigma_i +
//    gamma), rat_pref[k] = prod_{l <= k} num_l / den_l, Z(x) = prod_{y < x}
//    rat_pref[m - 1](y) and p_k = Z rat_pref[k].  Replaces what XLA fuses of
//    eth_lc_plonky2_tpu/prover/prove.py:264 `_prefix_mul`, :296 `_perm_core`
//    and :351 `compute_permutation_polys` (one jitted program a challenge),
//    which eager PyTorch ran as 42 launches a challenge (a doubling scan of
//    18 shifted products at 2^18 among them) and an inversion.  Reduce, then
//    scan: pass 1 takes a column a thread for all challenges, reading each
//    routed wire and sigma word once, with ONE Fermat power for its
//    challenges * m quotients (gl::batch_div over shared memory), parks the
//    unscaled rat_pref rows in the partials' rows of the output, and scans
//    the row ratios across its block (warp shuffles, then the warps' products
//    in shared memory), writing each block's product; pass 2 scans the block
//    products of each challenge in one block; pass 3 multiplies each column's
//    Z by its block's offset and the parked rows by Z.  What bounds it:
//    memory, 161 rows read and 20 written a column at (80, 2^18) with two
//    challenges (0.11 ms at 3.35 TB/s), against about 830 products a column.
//
// All results are canonical and the field is exact, so every word equals
// the plain versions' (prover/prove.py `_open_core_plain`,
// `perm_quotient_terms_plain`, `_perm_core`, prover/fri.py `g_plain`,
// `fold_plain`) whatever the order of the sums and products.
#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int OP_ADD = 0;
constexpr int OP_SUB = 1;
constexpr int OP_MUL = 2;

struct Operand {
  const uint64_t* base;
  long long stride_r;
  long long stride_c;
};

template <int OP>
__device__ __forceinline__ uint64_t apply(uint64_t a, uint64_t b) {
  if (OP == OP_ADD) return gl::add(a, b);
  if (OP == OP_SUB) return gl::sub(a, b);
  return gl::mul(a, b);
}

// canonical (op) canonical -> canonical, out[r * cols + c].
template <int OP>
__global__ void __launch_bounds__(256)
field_binary_kernel(Operand a, Operand b, uint64_t* __restrict__ out, long long rows,
                    long long cols) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint64_t* ar = a.base + r * a.stride_r;
    const uint64_t* br = b.base + r * b.stride_r;
    uint64_t* outr = out + r * cols;
    for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < cols; c += step)
      outr[c] = apply<OP>(ar[c * a.stride_c], br[c * b.stride_c]);
  }
}

// A block takes tiles of blockDim.x * INV_RUN words; thread t of a tile at
// word b takes the run b + t + i * blockDim.x, i < INV_RUN (neighbouring
// threads on neighbouring words at every i).  Words past n load as 0 and are
// not stored.  ops/kernels.py `field_inv_plan` mirrors it.
constexpr int INV_RUN = 16;

__global__ void __launch_bounds__(256)
field_inv_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, long long n) {
  const long long tile = (long long)blockDim.x * INV_RUN;
  for (long long b = (long long)blockIdx.x * tile; b < n; b += (long long)gridDim.x * tile) {
    const long long at = b + threadIdx.x;
    uint64_t v[INV_RUN], inv[INV_RUN];
#pragma unroll
    for (int i = 0; i < INV_RUN; ++i) {
      const long long w = at + (long long)i * blockDim.x;
      v[i] = w < n ? in[w] : 0;
    }
    gl::batch_div<INV_RUN>(inv, INV_RUN, [&](int i) { return v[i]; });
#pragma unroll
    for (int i = 0; i < INV_RUN; ++i) {
      const long long w = at + (long long)i * blockDim.x;
      if (w < n) out[w] = inv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// The openings
// ---------------------------------------------------------------------------

// The tiling; ops/kernels.py `field_open_plan` mirrors it.
constexpr int OPEN_WARPS = 8;      // warps a block: points_per_block x row subgroups
constexpr int OPEN_ROWS = 4;       // rows a thread (two column sums each)
constexpr int OPEN_MAX_COLS = 128; // columns a thread a slice (gl::Acc takes 2^8 products)

// a + b phi in GF(p^2) = GF(p)[phi] / (phi^2 - 7), lazy words.
struct Ext {
  uint64_t re, im;
};

// lazy x lazy -> lazy; b_im7 = 7 * b.im (canonical), so that
// (a + a' phi)(b + b' phi) = (a b + a' 7b') + (a b' + a' b) phi is two sums of
// two products each.
__device__ __forceinline__ Ext ext_mul_by(Ext a, Ext b, uint64_t b_im7) {
  gl::Acc re, im;
  re.mac(a.re, b.re);
  re.mac(a.im, b_im7);
  im.mac(a.re, b.im);
  im.mac(a.im, b.re);
  return {re.reduce_lazy(), im.reduce_lazy()};
}

__device__ __forceinline__ Ext ext_mul(Ext a, Ext b) { return ext_mul_by(a, b, gl::mul(b.im, 7)); }

// z^e by square-and-multiply, lazy.
__device__ Ext ext_pow(Ext z, unsigned long long e) {
  Ext r{1, 0};
  while (e) {
    if (e & 1) r = ext_mul(r, z);
    e >>= 1;
    if (e) z = ext_mul(z, z);
  }
  return r;
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int off = 16; off; off >>= 1)
    v = gl::add(v, (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)v, off));
  return v;
}

// Block b = (row group g, slice s) = (b / slices, b % slices) of blockIdx.x
// and point group blockIdx.y.  Warp w takes point
// blockIdx.y * points_per_block + w % points_per_block and rows
// g * rows_per_block + (w / points_per_block) * OPEN_ROWS + q, q < OPEN_ROWS;
// lane l takes columns s * 32 * cols + l + 32 i, i < cols.  Coefficient
// (r, c) is coeffs[r * stride + c].  Writes the canonical partial sums
// partial[((s * 2 + part) * k + j) * rows + r], part 0 the real one.
__global__ void __launch_bounds__(32 * OPEN_WARPS)
field_open_kernel(const uint64_t* __restrict__ coeffs, long long stride, long long rows,
                  long long n, const uint64_t* __restrict__ z_re,
                  const uint64_t* __restrict__ z_im, int k, int points_per_block,
                  long long slices, int cols, uint64_t* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp / points_per_block;
  const int j = blockIdx.y * points_per_block + warp % points_per_block;
  const long long s = blockIdx.x % slices;
  const long long r0 =
      (blockIdx.x / slices) * (long long)(OPEN_WARPS / points_per_block) * OPEN_ROWS +
      (long long)sub * OPEN_ROWS;
  // uniform across a warp: a warp without a point or rows has nothing to do
  const bool active = sub < OPEN_WARPS / points_per_block && j < k && r0 < rows;
  gl::Acc re[OPEN_ROWS], im[OPEN_ROWS];
  if (active) {
    const Ext z{z_re[j], z_im[j]};
    const Ext step = ext_pow(z, 32);
    const uint64_t step_im7 = gl::mul(step.im, 7);
    const long long c0 = s * 32ll * cols + lane;
    Ext zc = ext_pow(z, (unsigned long long)c0);
    // a column's words are loaded one column ahead, so that their latency
    // hides behind a column of arithmetic
    uint64_t cur[OPEN_ROWS], ahead[OPEN_ROWS];
    const auto load = [&](long long c, uint64_t* w) {
#pragma unroll
      for (int q = 0; q < OPEN_ROWS; ++q)
        w[q] = c < n && r0 + q < rows ? coeffs[(r0 + q) * stride + c] : 0;
    };
    load(c0, cur);
    for (int i = 0; i < cols; ++i) {
      const long long c = c0 + 32ll * i;
      if (c >= n) break;
      load(i + 1 < cols ? c + 32 : n, ahead);
#pragma unroll
      for (int q = 0; q < OPEN_ROWS; ++q) {
        re[q].mac(cur[q], zc.re);
        im[q].mac(cur[q], zc.im);
        cur[q] = ahead[q];
      }
      zc = ext_mul_by(zc, step, step_im7);
    }
  }
#pragma unroll
  for (int q = 0; q < OPEN_ROWS; ++q) {
    const uint64_t a = warp_sum(gl::canon(re[q].reduce_lazy()));
    const uint64_t b = warp_sum(gl::canon(im[q].reduce_lazy()));
    if (active && lane == 0 && r0 + q < rows) {
      partial[((s * 2) * k + j) * rows + r0 + q] = a;
      partial[((s * 2 + 1) * k + j) * rows + r0 + q] = b;
    }
  }
}

// out[i] = sum_s partial[s * count + i], canonical.
__global__ void __launch_bounds__(256)
field_open_sum_kernel(const uint64_t* __restrict__ partial, long long slices, long long count,
                      uint64_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint64_t v = 0;
  for (long long s = 0; s < slices; ++s) v = gl::add(v, partial[s * count + i]);
  out[i] = v;
}

// ---------------------------------------------------------------------------
// The permutation terms of the quotient
// ---------------------------------------------------------------------------

constexpr int PERM_CHALLENGES = 2;   // the prover's two challenges, one launch
constexpr int PERM_MAX_ROUTED = 256; // routed wires (shared memory for beta k_i)
constexpr int PERM_MAX_CHUNKS = 64;  // chunks: alpha^0 .. alpha^m in shared memory

struct PermArgs {
  const uint64_t* wires;  // routed wire i at column x: wires[i * wires_stride + x]
  long long wires_stride;
  const uint64_t* sigma;  // sigma_i at column x: sigma[i * sigma_stride + x]
  long long sigma_stride;
  const uint64_t* zs;  // challenge j's Z at row j * m, its partials at j * m + 1 + k
  long long zs_stride;
  const uint64_t* x;   // the LDE coset's points
  const uint64_t* l0;  // the first Lagrange polynomial on it
  const uint64_t* k_shifts;  // (routed,)
  const uint64_t* betas;     // (2,)
  const uint64_t* gammas;    // (2,)
  const uint64_t* alpha[PERM_CHALLENGES];  // alpha_j^0 .. alpha_j^m
  long long n_lde;  // the columns computed: a power of two
  long long next;   // 2^rate: the column of the next trace row
  int routed, chunk;
};

// out[j * n_lde + x] = sum_k alpha_j^k * term_k(x), canonical.
template <bool WINDOW>
__global__ void __launch_bounds__(256)
perm_quotient_kernel(PermArgs a, uint64_t* __restrict__ out) {
  constexpr int NC = PERM_CHALLENGES;
  static_assert(NC == 2, "the alpha rows below are written out for two challenges");
  __shared__ uint64_t beta_k[NC][PERM_MAX_ROUTED];
  __shared__ uint64_t alpha[NC][PERM_MAX_CHUNKS + 1];
  __shared__ uint64_t beta[NC], gamma[NC];
  const int m = a.routed / a.chunk;
  for (int t = threadIdx.x; t < NC * a.routed; t += blockDim.x)
    beta_k[t / a.routed][t % a.routed] = gl::mul(a.betas[t / a.routed], a.k_shifts[t % a.routed]);
  for (int t = threadIdx.x; t <= m; t += blockDim.x) {
    alpha[0][t] = a.alpha[0][t];
    alpha[1][t] = a.alpha[1][t];
  }
  if (threadIdx.x < NC) {
    beta[threadIdx.x] = a.betas[threadIdx.x];
    gamma[threadIdx.x] = a.gammas[threadIdx.x];
  }
  __syncthreads();
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= a.n_lde) return;
  const uint64_t xv = a.x[x];
  const uint64_t l0 = a.l0[x];
  const long long x_next = WINDOW ? x + a.next : (x + a.next) & (a.n_lde - 1);
  // the sum of the terms as two sums: sum alpha * (chain[k+1] * den_k) and
  // sum alpha * (chain[k] * num_k), l0 * Z and l0 for term 0
  gl::Acc pos[NC], neg[NC];
  uint64_t prev[NC];  // chain[k]
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const uint64_t z = a.zs[(long long)j * m * a.zs_stride + x];
    pos[j].mac(alpha[j][0], gl::mul_lazy(l0, z));
    neg[j].mac(alpha[j][0], l0);
    prev[j] = z;
  }
  // each word is loaded one wire (a chain word one chunk) ahead of its use,
  // so that its latency hides behind the arithmetic
  uint64_t w = a.wires[x], sg = a.sigma[x];
  for (int c = 0; c < m; ++c) {
    uint64_t next[NC];  // chain[k+1]
#pragma unroll
    for (int j = 0; j < NC; ++j)
      next[j] = c + 1 < m ? a.zs[((long long)j * m + c + 1) * a.zs_stride + x]
                          : a.zs[(long long)j * m * a.zs_stride + x_next];
    uint64_t num[NC], den[NC];  // lazy running products of the chunk
    for (int i = 0; i < a.chunk; ++i) {
      const int col = c * a.chunk + i;
      uint64_t w_ahead = 0, sg_ahead = 0;
      if (col + 1 < a.routed) {
        w_ahead = a.wires[(long long)(col + 1) * a.wires_stride + x];
        sg_ahead = a.sigma[(long long)(col + 1) * a.sigma_stride + x];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const uint64_t wg = gl::add(w, gamma[j]);
        const uint64_t nt = gl::mul_add_lazy(beta_k[j][col], xv, wg);  // w + beta k_i x + gamma
        const uint64_t dt = gl::mul_add_lazy(beta[j], sg, wg);          // w + beta sigma_i + gamma
        num[j] = i ? gl::mul_lazy(num[j], nt) : nt;
        den[j] = i ? gl::mul_lazy(den[j], dt) : dt;
      }
      w = w_ahead;
      sg = sg_ahead;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      pos[j].mac(alpha[j][c + 1], gl::mul_lazy(next[j], den[j]));
      neg[j].mac(alpha[j][c + 1], gl::mul_lazy(prev[j], num[j]));
      prev[j] = next[j];
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j)
    out[(long long)j * a.n_lde + x] =
        gl::sub(gl::canon(pos[j].reduce_lazy()), gl::canon(neg[j].reduce_lazy()));
}

// ---------------------------------------------------------------------------
// The permutation argument's Z and partial products
// ---------------------------------------------------------------------------

constexpr int PERM_Z_MAX_THREADS = 256;
// the block scan's shared words: one a warp, and the last for the block's product
static_assert(PERM_Z_MAX_THREADS / 32 < 32, "a block's warps and its product fit one warp's lanes");

struct PermZArgs {
  const uint64_t* wires;  // routed wire i at column x: wires[i * wires_stride + x]
  long long wires_stride;
  const uint64_t* sigma;  // sigma_i at column x: sigma[i * sigma_stride + x]
  long long sigma_stride;
  const uint64_t* omega;     // (n,) the subgroup's points
  const uint64_t* k_shifts;  // (routed,)
  const uint64_t* betas;     // (challenges,)
  const uint64_t* gammas;
  uint64_t* out;     // (challenges * m, n), rows of n words: challenge j's Z at
                     // row j * m, its partial k at row j * m + 1 + k
  uint64_t* totals;  // (challenges, blocks) the block totals, then their offsets
  long long n;
  int routed, chunk, challenges;
};

// v[j] -> the product of the v[j] of the block's threads before this one (an
// exclusive scan by field products, in thread order), for j < NC; total[j]
// -> the product over the whole block.  Every thread of the block calls it.
// A warp scans its lanes with shuffles (lane l takes the product of lanes
// l - off .. l at off = 1, 2, 4, 8, 16), the first warp scans the warps'
// products in shared memory the same way, and a thread's exclusive product
// is its warp's offset times its left neighbour's inclusive one.
template <int NC>
__device__ __forceinline__ void block_scan(uint64_t (&v)[NC], uint64_t (&total)[NC],
                                           uint64_t (&warp_sums)[NC][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint64_t y = __shfl_up_sync(0xffffffffu, (unsigned long long)v[j], off);
      if (lane >= off) v[j] = gl::mul(v[j], y);
    }
    if (lane == 31) warp_sums[j][warp] = v[j];
    const uint64_t left = __shfl_up_sync(0xffffffffu, (unsigned long long)v[j], 1);
    v[j] = lane ? left : 1;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      uint64_t s = lane < warps ? warp_sums[j][lane] : 1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint64_t y = __shfl_up_sync(0xffffffffu, (unsigned long long)s, off);
        if (lane >= off) s = gl::mul(s, y);
      }
      const uint64_t left = __shfl_up_sync(0xffffffffu, (unsigned long long)s, 1);
      if (lane < warps) warp_sums[j][lane] = lane ? left : 1;
      if (lane == 31) warp_sums[j][31] = s;  // the block's product (lanes past the warps are 1)
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    v[j] = gl::mul(warp_sums[j][warp], v[j]);
    total[j] = warp_sums[j][31];
  }
}

// Pass 1 of 3: thread x of the grid takes column x for every challenge.  It
// reads each routed wire and sigma word once (words loaded one group of
// PERM_Z_GROUP wires ahead), keeps num_k = prod (w + beta k_i omega^x +
// gamma) and den_k = prod (w + beta sigma_i + gamma) of each chunk k in
// shared memory (dynamic: q[j * m + k][thread], then d[...] after the
// challenges * m rows of q), turns all challenges * m quotients num_k / den_k
// into words with ONE Fermat power (gl::batch_div: a zero den_k gives 0, as
// the plain inverse), and their running product rat_pref[k].  It parks
// rat_pref[k], k < m - 1, unscaled in the partials' rows of `out`, scans the
// row ratio rat_pref[m - 1] across the block (block_scan) into the Z row, and
// writes the block's product to totals[j * gridDim.x + blockIdx.x].
constexpr int PERM_Z_GROUP = 4;

__global__ void __launch_bounds__(PERM_Z_MAX_THREADS)
perm_z_kernel(PermZArgs a) {
  constexpr int NC = PERM_CHALLENGES;
  extern __shared__ uint64_t quot[];  // q: challenges * m rows of blockDim.x, then d: as many
  __shared__ uint64_t beta_k[NC][PERM_MAX_ROUTED];
  __shared__ uint64_t beta[NC], gamma[NC];
  __shared__ uint64_t warp_sums[NC][32];
  const int nc = a.challenges, m = a.routed / a.chunk, T = blockDim.x, t = threadIdx.x;
  for (int i = t; i < nc * a.routed; i += T)
    beta_k[i / a.routed][i % a.routed] = gl::mul(a.betas[i / a.routed], a.k_shifts[i % a.routed]);
  if (t < nc) {
    beta[t] = a.betas[t];
    gamma[t] = a.gammas[t];
  }
  __syncthreads();
  const long long x = (long long)blockIdx.x * T + t;
  const bool live = x < a.n;
  uint64_t* q = quot + t;                             // q[r * T]: row r's word of this thread
  uint64_t* d = quot + (long long)nc * m * T + t;
  uint64_t row_ratio[NC] = {1, 1};                    // 1 for a column past n: it leaves the scan as it is
  if (live) {
    const uint64_t om = a.omega[x];
    uint64_t w[PERM_Z_GROUP], s[PERM_Z_GROUP];
    const auto load = [&](int c0, uint64_t (&wg)[PERM_Z_GROUP], uint64_t (&sg)[PERM_Z_GROUP]) {
#pragma unroll
      for (int u = 0; u < PERM_Z_GROUP; ++u) {
        const int col = c0 + u;
        wg[u] = col < a.routed ? a.wires[(long long)col * a.wires_stride + x] : 0;
        sg[u] = col < a.routed ? a.sigma[(long long)col * a.sigma_stride + x] : 0;
      }
    };
    load(0, w, s);
    uint64_t num[NC], den[NC];
    int i = 0, k = 0;  // the wire's place in its chunk, the chunk
    for (int c0 = 0; c0 < a.routed; c0 += PERM_Z_GROUP) {
      uint64_t w_ahead[PERM_Z_GROUP], s_ahead[PERM_Z_GROUP];
      load(c0 + PERM_Z_GROUP, w_ahead, s_ahead);
#pragma unroll
      for (int u = 0; u < PERM_Z_GROUP; ++u) {
        const int col = c0 + u;
        if (col < a.routed) {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            if (j < nc) {
              const uint64_t wg = gl::add_lazy(w[u], gamma[j]);
              const uint64_t nt = gl::mul_add_lazy(beta_k[j][col], om, wg);  // w + beta k_i x + gamma
              const uint64_t dt = gl::mul_add_lazy(beta[j], s[u], wg);      // w + beta sigma_i + gamma
              num[j] = i ? gl::mul_lazy(num[j], nt) : nt;
              den[j] = i ? gl::mul_lazy(den[j], dt) : dt;
            }
          }
          if (++i == a.chunk) {
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              if (j < nc) {
                q[(long long)(j * m + k) * T] = num[j];
                d[(long long)(j * m + k) * T] = gl::canon(den[j]);  // compared with 0
              }
            }
            i = 0;
            ++k;
          }
        }
        w[u] = w_ahead[u];
        s[u] = s_ahead[u];
      }
    }
    // q[r] = num_r / den_r for the challenges * m rows r, with one Fermat power
    const gl::Strided qs{q, T}, ds{d, T};
    gl::batch_div<NC * PERM_MAX_CHUNKS, 1>(qs, nc * m, [&](int r) { return ds[r]; },
                                           [&](int r) { return qs[r]; });
    // rat_pref[k] = prod_{l <= k} ratio_l: the partials' rows get it unscaled
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j < nc) {
        uint64_t pref = qs[j * m];
        for (int kk = 1; kk < m; ++kk) {
          a.out[((long long)j * m + kk) * a.n + x] = pref;
          pref = gl::mul(pref, qs[j * m + kk]);
        }
        row_ratio[j] = pref;
      }
    }
  }
  uint64_t total[NC];
  block_scan(row_ratio, total, warp_sums);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < nc) {
      if (live) a.out[(long long)j * m * a.n + x] = row_ratio[j];
      if (t == 0) a.totals[(long long)j * gridDim.x + blockIdx.x] = total[j];
    }
  }
}

// Pass 2 of 3: block j turns totals[j * blocks ...] into the exclusive
// products of the block totals before each block, in place.  Thread t takes
// the run of `run` totals from t * run, its product goes through block_scan,
// and it walks its run again writing the offsets.
__global__ void __launch_bounds__(PERM_Z_MAX_THREADS)
perm_z_scan_kernel(uint64_t* __restrict__ totals, long long blocks, long long run) {
  __shared__ uint64_t warp_sums[1][32];
  uint64_t* tot = totals + (long long)blockIdx.x * blocks;
  const long long b0 = (long long)threadIdx.x * run;
  const long long b1 = b0 + run < blocks ? b0 + run : blocks;
  uint64_t v[1] = {1}, total[1];
  for (long long b = b0; b < b1; ++b) v[0] = gl::mul(v[0], tot[b]);
  block_scan(v, total, warp_sums);
  for (long long b = b0; b < b1; ++b) {
    const uint64_t t = tot[b];
    tot[b] = v[0];
    v[0] = gl::mul(v[0], t);
  }
}

// Pass 3 of 3: column x of challenge blockIdx.y: Z = offset of its pass-1
// block (of `tile` columns) times the block's exclusive product, and the
// partial k = Z * rat_pref[k], in place.
__global__ void __launch_bounds__(256)
perm_z_fixup_kernel(uint64_t* __restrict__ out, const uint64_t* __restrict__ totals,
                    long long n, long long tile, long long blocks, int m) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  uint64_t* z = out + (long long)blockIdx.y * m * n + x;
  const uint64_t zv = gl::mul(totals[(long long)blockIdx.y * blocks + x / tile], z[0]);
  z[0] = zv;
  for (int k = 1; k < m; ++k) z[(long long)k * n] = gl::mul(zv, z[(long long)k * n]);
}

// ---------------------------------------------------------------------------
// FRI's combined opening polynomial G
// ---------------------------------------------------------------------------

constexpr int G_TAGS = 4;          // batches P, W, Z, Q
constexpr int G_MAX_SPECS = 16;    // opening points (12 in phase 7)
constexpr int G_MAX_ROWS = 2048;   // rows of the four batches together (shared memory)
constexpr int G_CHUNK = 128;       // rows summed before a reduction (gl::Acc takes 2^8)

struct GArgs {
  const uint64_t* lde[G_TAGS];  // batch t's row i at column x: lde[t][i * stride[t] + x]
  long long stride[G_TAGS];
  int rows[G_TAGS];
  int offset[G_TAGS];           // its row i is weighted by a_{offset[t] + i}
  int spec_tag[G_MAX_SPECS];    // the batch of spec j
  int specs, total;
  const uint64_t* x;            // the LDE coset's points
  const uint64_t* a_re;         // (total + specs,) the weights a
  const uint64_t* a_im;
  const uint64_t* y_re;         // (specs,) the opened values y_j
  const uint64_t* y_im;
  const uint64_t* z_re;         // (specs,) the points z_j
  const uint64_t* z_im;
  long long n_lde;
};

// The norm (x - z_re)^2 - 7 z_im^2 of spec j (c7[j] = 7 z_im^2), canonical.
struct NormOf {
  uint64_t x;
  const uint64_t* z_re;
  const uint64_t* c7;
  __device__ __forceinline__ uint64_t operator()(int j) const {
    const uint64_t dre = gl::sub(x, z_re[j]);
    return gl::sub(gl::mul(dre, dre), c7[j]);
  }
};

__device__ __forceinline__ uint64_t pick(const uint64_t (&v)[G_TAGS], int t) {
  return t == 0 ? v[0] : t == 1 ? v[1] : t == 2 ? v[2] : v[3];
}

// out_re[x], out_im[x] = G(x), canonical.  Dynamic shared memory: the
// weights a_re, a_im of the total rows.
__global__ void __launch_bounds__(256)
fri_g_kernel(GArgs g, uint64_t* __restrict__ out_re, uint64_t* __restrict__ out_im) {
  extern __shared__ uint64_t weights[];  // a_re[0..total), a_im[0..total)
  __shared__ uint64_t s_zre[G_MAX_SPECS], s_zim[G_MAX_SPECS], s_c7[G_MAX_SPECS];
  __shared__ uint64_t s_yre[G_MAX_SPECS], s_yim[G_MAX_SPECS];
  __shared__ uint64_t s_are[G_MAX_SPECS], s_aim[G_MAX_SPECS], s_aim7[G_MAX_SPECS];
  for (int t = threadIdx.x; t < g.total; t += blockDim.x) {
    weights[t] = g.a_re[t];
    weights[g.total + t] = g.a_im[t];
  }
  if (threadIdx.x < g.specs) {
    const int j = threadIdx.x;
    const uint64_t zi = g.z_im[j];
    s_zre[j] = g.z_re[j];
    s_zim[j] = zi;
    s_c7[j] = gl::mul(gl::mul(zi, zi), 7);  // W z_im^2: the norm is (x - z_re)^2 - W z_im^2
    s_yre[j] = g.y_re[j];
    s_yim[j] = g.y_im[j];
    s_are[j] = g.a_re[g.total + j];
    s_aim[j] = g.a_im[g.total + j];
    s_aim7[j] = gl::mul(g.a_im[g.total + j], 7);
  }
  __syncthreads();
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= g.n_lde) return;

  // B_t(x) for the four batches: every row read once, down its column
  uint64_t b_re[G_TAGS], b_im[G_TAGS];
#pragma unroll
  for (int t = 0; t < G_TAGS; ++t) {
    uint64_t sum_re = 0, sum_im = 0;
    const uint64_t* col = g.lde[t] + x;
    const uint64_t* w_re = weights + g.offset[t];
    const uint64_t* w_im = weights + g.total + g.offset[t];
    for (int i0 = 0; i0 < g.rows[t]; i0 += G_CHUNK) {
      const int i1 = min(g.rows[t], i0 + G_CHUNK);
      gl::Acc acc_re, acc_im;
#pragma unroll 8
      for (int i = i0; i < i1; ++i) {
        const uint64_t v = col[(long long)i * g.stride[t]];
        acc_re.mac(w_re[i], v);
        acc_im.mac(w_im[i], v);
      }
      sum_re = gl::add(sum_re, gl::canon(acc_re.reduce_lazy()));
      sum_im = gl::add(sum_im, gl::canon(acc_im.reduce_lazy()));
    }
    b_re[t] = sum_re;
    b_im[t] = sum_im;
  }

  // the norms' inverses by Montgomery's trick, one Fermat inversion of all
  // of them (a zero norm's inverse is 0, as the plain version's), each
  // consumed as the walk back makes it; a norm is recomputed where the trick
  // reads it again rather than kept
  const uint64_t xv = g.x[x];
  const NormOf norm_of{xv, s_zre, s_c7};
  uint64_t prefix[G_MAX_SPECS];
  uint64_t inv = gl::inv_fermat(gl::batch_prefix<G_MAX_SPECS>(prefix, g.specs, norm_of));
  gl::Acc acc_re, acc_im;
#pragma unroll
  for (int j = G_MAX_SPECS - 1; j >= 0; --j) {
    if (j < g.specs) {
      const uint64_t dre = gl::sub(xv, s_zre[j]);
      const uint64_t ninv = gl::batch_back(inv, prefix[j], norm_of(j));
      // 1 / (x - z) = (dre + z_im phi) / norm
      const Ext den{gl::mul(dre, ninv), gl::mul(s_zim[j], ninv)};
      const int t = g.spec_tag[j];
      const Ext num{gl::sub(pick(b_re, t), s_yre[j]), gl::sub(pick(b_im, t), s_yim[j])};
      const Ext q = ext_mul(num, den);
      acc_re.mac(q.re, s_are[j]);
      acc_re.mac(q.im, s_aim7[j]);
      acc_im.mac(q.re, s_aim[j]);
      acc_im.mac(q.im, s_are[j]);
    }
  }
  out_re[x] = gl::canon(acc_re.reduce_lazy());
  out_im[x] = gl::canon(acc_im.reduce_lazy());
}

// ---------------------------------------------------------------------------
// One FRI fold
// ---------------------------------------------------------------------------

// out[i] = (e0 + e1) half + beta (e0 - e1) w_inv[i] scale, e0 and e1 the ext
// words i and i + h of (re, im); canonical.
__global__ void __launch_bounds__(256)
fri_fold_kernel(const uint64_t* __restrict__ re, const uint64_t* __restrict__ im,
                const uint64_t* __restrict__ w_inv, uint64_t scale, uint64_t half,
                const uint64_t* __restrict__ beta_re, const uint64_t* __restrict__ beta_im,
                uint64_t* __restrict__ out_re, uint64_t* __restrict__ out_im, long long h) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  const uint64_t re0 = re[i], re1 = re[i + h], im0 = im[i], im1 = im[i + h];
  const uint64_t hx = gl::mul(w_inv[i], scale);
  const Ext beta{beta_re[0], beta_im[0]};
  const Ext d{gl::mul(gl::sub(re0, re1), hx), gl::mul(gl::sub(im0, im1), hx)};
  const Ext t = ext_mul(d, beta);
  out_re[i] = gl::add(gl::mul(gl::add(re0, re1), half), gl::canon(t.re));
  out_im[i] = gl::add(gl::mul(gl::add(im0, im1), half), gl::canon(t.im));
}

unsigned blocks_for(long long count, int threads, long long most) {
  long long blocks = (count + threads - 1) / threads;
  if (blocks > most) blocks = most;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" int elp_field_binary(int op, const void* a, long long a_r, long long a_c,
                                const void* b, long long b_r, long long b_c, void* out,
                                long long rows, long long cols, int threads, void* stream) {
  const Operand oa{static_cast<const uint64_t*>(a), a_r, a_c};
  const Operand ob{static_cast<const uint64_t*>(b), b_r, b_c};
  uint64_t* o = static_cast<uint64_t*>(out);
  const dim3 grid(blocks_for(cols, threads, 1ll << 30), blocks_for(rows, 1, 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == OP_ADD) {
    field_binary_kernel<OP_ADD><<<grid, threads, 0, s>>>(oa, ob, o, rows, cols);
  } else if (op == OP_SUB) {
    field_binary_kernel<OP_SUB><<<grid, threads, 0, s>>>(oa, ob, o, rows, cols);
  } else if (op == OP_MUL) {
    field_binary_kernel<OP_MUL><<<grid, threads, 0, s>>>(oa, ob, o, rows, cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int elp_field_inv(const void* in, void* out, long long n, int threads, void* stream) {
  if (n < 1 || threads < 1 || threads > 256) return (int)cudaErrorInvalidValue;
  field_inv_kernel<<<blocks_for(n, threads * INV_RUN, 1ll << 30), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return (int)cudaGetLastError();
}

// One launch of field_open_kernel: grid (slices x row groups, point groups).
extern "C" int elp_field_open(const void* coeffs, long long stride, long long rows, long long n,
                              const void* z_re, const void* z_im, int k, int points_per_block,
                              long long slices, int cols, long long row_groups,
                              long long point_groups, void* partial, void* stream) {
  if (points_per_block < 1 || points_per_block > OPEN_WARPS || cols < 1 ||
      cols > OPEN_MAX_COLS || slices < 1 || row_groups < 1 || point_groups < 1 ||
      slices * row_groups > 0x7FFFFFFFll || point_groups > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(slices * row_groups), (unsigned)point_groups);
  field_open_kernel<<<grid, 32 * OPEN_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(coeffs), stride, rows, n, static_cast<const uint64_t*>(z_re),
      static_cast<const uint64_t*>(z_im), k, points_per_block, slices, cols,
      static_cast<uint64_t*>(partial));
  return (int)cudaGetLastError();
}

extern "C" int elp_field_open_sum(const void* partial, long long slices, long long count,
                                  void* out, int threads, void* stream) {
  field_open_sum_kernel<<<blocks_for(count, threads, 1ll << 30), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(partial), slices, count, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

// One launch for the two challenges; `out` is (2, n_lde) and overlaps no input.
// `mask` is n_lde - 1 (the next row wraps), or -1 for the window form.
extern "C" int elp_perm_quotient(const void* wires, long long wires_stride, const void* sigma,
                                 long long sigma_stride, const void* zs, long long zs_stride,
                                 const void* x, const void* l0, const void* k_shifts,
                                 const void* betas, const void* gammas, const void* alpha0,
                                 const void* alpha1, long long n_lde, long long mask, int rate,
                                 int routed, int chunk, void* out, int threads, void* stream) {
  if (n_lde < 1 || (n_lde & (n_lde - 1)) || (mask != n_lde - 1 && mask != -1) || rate < 0 ||
      rate > 30 || chunk < 1 ||
      routed < chunk || routed % chunk || routed > PERM_MAX_ROUTED ||
      routed / chunk > PERM_MAX_CHUNKS || threads < 1 || threads > 256)
    return (int)cudaErrorInvalidValue;
  const auto w = [](const void* p) { return static_cast<const uint64_t*>(p); };
  const PermArgs a{w(wires), wires_stride, w(sigma), sigma_stride, w(zs), zs_stride, w(x), w(l0),
                   w(k_shifts), w(betas), w(gammas), {w(alpha0), w(alpha1)}, n_lde,
                   1ll << rate, routed, chunk};
  const auto kernel = mask == -1 ? perm_quotient_kernel<true> : perm_quotient_kernel<false>;
  kernel<<<blocks_for(n_lde, threads, 1ll << 30), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

// The three launches of Z and the partials for `challenges` challenges into
// `out` ((challenges * m, n), contiguous; it overlaps no input), with the
// (challenges, blocks) scratch `totals`: perm_z_kernel in blocks of
// `threads` columns with `shared` bytes of dynamic shared memory, then
// perm_z_scan_kernel (one block a challenge, `run` totals a thread), then
// perm_z_fixup_kernel.  ops/kernels.py `perm_z_plan` computes the sizes.
extern "C" int elp_perm_z(const void* wires, long long wires_stride, const void* sigma,
                          long long sigma_stride, const void* omega, const void* k_shifts,
                          const void* betas, const void* gammas, long long n, int routed, int chunk,
                          int challenges, void* out, void* totals, int threads, long long blocks,
                          long long shared, long long run, int scan_threads, void* stream) {
  const int m = chunk > 0 ? routed / chunk : 0;
  if (n < 1 || chunk < 1 || routed < chunk || routed % chunk || routed > PERM_MAX_ROUTED ||
      m > PERM_MAX_CHUNKS || challenges < 1 || challenges > PERM_CHALLENGES || threads < 32 ||
      threads > PERM_Z_MAX_THREADS || threads % 32 || blocks != (n + threads - 1) / threads ||
      blocks > 0x7FFFFFFFll || shared != 2ll * challenges * m * threads * 8 ||
      shared > 227 * 1024 || scan_threads < 32 || scan_threads > PERM_Z_MAX_THREADS ||
      scan_threads % 32 || run < 1 || run * scan_threads < blocks)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(perm_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return (int)err;
  const auto w = [](const void* p) { return static_cast<const uint64_t*>(p); };
  uint64_t* o = static_cast<uint64_t*>(out);
  uint64_t* t = static_cast<uint64_t*>(totals);
  const PermZArgs a{w(wires), wires_stride, w(sigma), sigma_stride, w(omega), w(k_shifts),
                    w(betas), w(gammas), o, t, n, routed, chunk, challenges};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  perm_z_kernel<<<(unsigned)blocks, threads, (size_t)shared, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  perm_z_scan_kernel<<<challenges, scan_threads, 0, s>>>(t, blocks, run);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid(blocks_for(n, 256, 1ll << 30), challenges);
  perm_z_fixup_kernel<<<grid, 256, 0, s>>>(o, t, n, threads, blocks, m);
  return (int)cudaGetLastError();
}

// One launch: G on the LDE coset into out_re, out_im (n_lde words each).
// `lde`, `stride`, `rows`: the four batches P, W, Z, Q; `spec_tag`: the
// batch of each of `specs` specs (ints, read on the host).
extern "C" int elp_fri_g(const void* const* lde, const long long* stride, const int* rows,
                         const int* spec_tag, int specs, const void* x, const void* a_re,
                         const void* a_im, const void* y_re, const void* y_im, const void* z_re,
                         const void* z_im, long long n_lde, void* out_re, void* out_im,
                         int threads, void* stream) {
  if (specs < 1 || specs > G_MAX_SPECS || n_lde < 1 || threads < G_MAX_SPECS || threads > 256)
    return (int)cudaErrorInvalidValue;
  const auto w = [](const void* p) { return static_cast<const uint64_t*>(p); };
  GArgs g{};
  int total = 0;
  for (int t = 0; t < G_TAGS; ++t) {
    if (rows[t] < 0 || (rows[t] > 0 && stride[t] < n_lde)) return (int)cudaErrorInvalidValue;
    g.lde[t] = w(lde[t]);
    g.stride[t] = stride[t];
    g.rows[t] = rows[t];
    g.offset[t] = total;
    total += rows[t];
  }
  if (total > G_MAX_ROWS) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < specs; ++j) {
    if (spec_tag[j] < 0 || spec_tag[j] >= G_TAGS) return (int)cudaErrorInvalidValue;
    g.spec_tag[j] = spec_tag[j];
  }
  g.specs = specs;
  g.total = total;
  g.x = w(x);
  g.a_re = w(a_re);
  g.a_im = w(a_im);
  g.y_re = w(y_re);
  g.y_im = w(y_im);
  g.z_re = w(z_re);
  g.z_im = w(z_im);
  g.n_lde = n_lde;
  const size_t shared = 2 * (size_t)total * sizeof(uint64_t);
  fri_g_kernel<<<blocks_for(n_lde, threads, 1ll << 30), threads, shared,
                 static_cast<cudaStream_t>(stream)>>>(g, static_cast<uint64_t*>(out_re),
                                                      static_cast<uint64_t*>(out_im));
  return (int)cudaGetLastError();
}

// One fold of (re, im), 2h words each, into (out_re, out_im), h words each.
extern "C" int elp_fri_fold(const void* re, const void* im, const void* w_inv,
                            unsigned long long scale, unsigned long long half, const void* beta_re,
                            const void* beta_im, void* out_re, void* out_im, long long h,
                            int threads, void* stream) {
  if (h < 1 || threads < 1 || threads > 256) return (int)cudaErrorInvalidValue;
  const auto w = [](const void* p) { return static_cast<const uint64_t*>(p); };
  fri_fold_kernel<<<blocks_for(h, threads, 1ll << 30), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      w(re), w(im), w(w_inv), scale, half, w(beta_re), w(beta_im), static_cast<uint64_t*>(out_re),
      static_cast<uint64_t*>(out_im), h);
  return (int)cudaGetLastError();
}

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
// 2. field_open_table_kernel, field_open_kernel (+ field_open_sum_kernel):
//    the openings, the values of every batch's (rows, n) base-field
//    coefficient rows at its k points of the quadratic extension,
//    sum_c coeffs[r][c] * z_j^c.  Replaces what XLA fuses of
//    eth_lc_plonky2_tpu/prover/prove.py:551 `_open_core` (ext powers by
//    log-doubling, two products and two sums over (rows, n) a point), one
//    call for all of a proof's batches.  The function is a product of (rows
//    x n) coefficients with (n x 2k) power words, K = n = 2^18, so the design
//    runs it on the int8 tensor cores: with a = sum_a A_a 2^8a and b = sum_b
//    B_b 2^8b split into byte planes, a b = sum_s 2^8s sum_{a+b=s} A_a B_b,
//    and each plane pair is one mma.sync m16n8k32 u8 x u8 -> s32 into the
//    accumulator of its class s = a + b (15 classes, at most 8 pairs each).
//    A block's columns are at most OPEN_CHUNK = 2^12, so a class sum is below
//    8 * 255^2 * 2^12 < 2^31 and never wraps; the block folds its 15 class
//    sums into one canonical word with the weights 2^8s mod p.
//    The table kernel writes z_j^c once a proof for the union of the batches'
//    points (9 for the flagship), as byte planes in the order the B fragments
//    read them (`open_column`); the product kernel takes every batch from a
//    table of batches: a block owns 32 rows of one batch and one 2^12-column
//    slice, and its producer thread keeps cp.async.bulk copies of the rows'
//    and the points' segments in flight into a ring of shared-memory stages
//    (mbarriers); each consumer warp takes one m16 x n8 tile, turns the
//    coefficient words into byte planes with byte permutes in registers and
//    runs the 64 plane pairs; a second, small launch adds the slices.
//    What bounds it: memory, the coefficients read once (8 bytes a word)
//    and the table; the tensor work, 64 u8 products a coefficient and
//    power word, sits below that at the card's int8 rate.  The old form
//    (a warp a point, 96-bit column sums on the integer pipe) was bound by
//    the integer multiply-adds at 7% of its bound.  On the card the bulk
//    copies' count, one a row's stage segment, sets the product's time, so
//    a stage is OPEN_KS = 256 columns (2 KB a copy) and the ring two deep.
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
//    of a window whose halo holds it, unwrapped).
//    What bounds it: its bound by bytes is 182 words read and 2 written a
//    column (80 wires, 80 sigmas, 20 Z rows, x, l0; 3.1 GB at 2^21, 0.92 ms
//    at 3.35 TB/s), above the 3,386 32-bit multiply-adds of its cheapest
//    form (0.42 ms).  On the card the integer pipe bounds it: a lazy product
//    is some 20 integer instructions, not 5 multiply-adds, and the 8
//    products a wire make about 17,000 instructions a column, which issue at
//    two cycles a warp (about 2.1 ms at 2^21: the kernel with its copies cut
//    runs 2.05 to 2.15 ms, its copies alone 1.08 ms; PERF.md).  So the rows
//    arrive by bulk asynchronous copies, off the threads that compute:
//    persistent blocks (two an SM, 16 warps) walk tiles of PERM_TILE
//    columns, a thread a column; a stage is a chunk's 8 wire and 8 sigma
//    rows (one copy of a 2-D tensor map each) and its next chain rows (the
//    tile's first stage x, l0 and Z), in a ring of PERM_STAGES stages of
//    dynamic shared memory, each completing on an mbarrier; the warp that
//    releases a stage last refills it, so no thread only copies and no warp
//    waits for another.  Z at the next row, 2 of the 184 words, stays a
//    direct load, so the wrap and the window's halo read as before.  One
//    96-bit column sum a challenge takes alpha (chain[k+1] den - chain[k]
//    num) (fewer registers than two).
//
// 4. fri_g_kernel: FRI's combined opening polynomial on the LDE coset,
//        G(x) = sum_j a_{total+j} (B_{tag(j)}(x) - y_j) / (x - z_j),
//        B_t(x) = sum_i a_{off_t+i} lde_t[i](x)
//    (base rows, ext weights a, ext points z_j and values y_j).  Replaces
//    what XLA fuses of eth_lc_plonky2_tpu/prover/fri.py:72 `make_g_kernel`
//    (jitted at :166), which eager PyTorch ran as some 277 launches and a
//    batched inversion of the (S, n_lde) norms.  What bounds it: memory,
//    every row of the four batches read once (P, W, Z, Q: 312 rows, 5.2 GB
//    at 2^21), against about 2,500 multiply-adds a column for the sums.  So
//    the rows arrive by bulk asynchronous copies: persistent blocks walk
//    tiles of G_TILE columns; one producer thread keeps cp.async.bulk copies
//    in flight (one row's segment of the tile each, G_STAGE_ROWS rows of a
//    batch a stage) into a ring of G_STAGES stages of dynamic shared memory,
//    each stage completing on an mbarrier; the row-sum threads, one a
//    column, take the rows from shared memory while the next stages load,
//    keeping the four ext sums in 96-bit column sums (a reduction every 128
//    rows; the weights sit in shared memory), and hand them to the epilogue
//    threads, one a column, through two slots of shared memory.  The epilogue
//    takes the S specs in registers: the norm (x - z_re)^2 - 7 z_im^2 of
//    each, ONE Fermat inversion for all S by Montgomery's trick
//    (gl::batch_prefix, then gl::batch_back a spec on the way back, each
//    inverse consumed as it comes; a zero norm is skipped, so its inverse is
//    0, as the plain version's), and the weighted sum.  The epilogue is about
//    a third of a column's instructions, most of them on serial chains; done
//    by the threads that sum the rows it stalled the ring, so it runs beside
//    the next tile's sums (at 2^21 on an H100, tools/field_variants.py: the
//    rows alone stream in 1.8 to 1.9 ms, with the sums 2.2 to 2.3 ms, with
//    the epilogue beside them 2.6 to 2.7 ms).
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
//    Z by its block's offset and the parked rows by Z.  What bounds it: not
//    its bytes, 161 rows read and 20 written a column at (80, 2^18) with two
//    challenges (0.11 ms at 3.35 TB/s), but pass 1's integer instructions,
//    some 830 products a column at about 20 integer instructions a lazy
//    product (about 0.26 ms at 2^18); passes 2 and 3 take about a tenth of
//    the time.  One launch with a decoupled look-back across tiles, every
//    word written once (tools/variants/perm_z_one_pass.cu), ran slower on an
//    H100: the tiles of a wave finish together, so their look-backs run
//    while the SMs wait, and its pass writes every word after the block's
//    barrier where pass 1 stores between its products (PERF.md section 6).
//
// All results are canonical and the field is exact, so every word equals
// the plain versions' (prover/prove.py `_open_core_plain`,
// `perm_quotient_terms_plain`, `_perm_core`, prover/fri.py `g_plain`,
// `fold_plain`) whatever the order of the sums and products.
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
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
constexpr int OPEN_MAX_BATCHES = 8;  // batches a launch
constexpr int OPEN_MAX_POINTS = 8;   // points a batch: 16 power rows, OPEN_NTILES n-tiles of 8
constexpr int OPEN_MTILES = 2;       // m-tiles of 16 coefficient rows a block
constexpr int OPEN_NTILES = 2;
constexpr int OPEN_WARPS = 4;        // consumer warps: OPEN_MTILES x OPEN_NTILES tiles
constexpr int OPEN_ROWS = 32;        // coefficient rows a block: 16 x OPEN_MTILES
constexpr int OPEN_KS = 256;         // columns a stage: eight k-steps of 32
constexpr int OPEN_STAGES = 2;
constexpr int OPEN_CHUNK = 4096;     // columns a block: a class sum stays below 2^31
constexpr int OPEN_CLASSES = 15;     // plane pairs (a, b) by a + b
constexpr int OPEN_TABLE_THREADS = 256;
static_assert(OPEN_WARPS == OPEN_MTILES * OPEN_NTILES && OPEN_ROWS == 16 * OPEN_MTILES, "tiles");
static_assert(8ll * 255 * 255 * OPEN_CHUNK < (1ll << 31), "a class sum of a block must not wrap");
static_assert(OPEN_CHUNK % OPEN_KS == 0 && OPEN_KS % 32 == 0, "a block's slice is whole stages");
// a stage: OPEN_ROWS coefficient rows of OPEN_KS words, then 8 x (the
// launch's most n-tiles) power rows of OPEN_KS words (bytes); the pitches put
// the rows a quarter warp reads (A: two rows of 64 bytes; B: four rows of 32)
// on distinct banks.  A copy moves one row's OPEN_KS words: the copies'
// count, not their bytes, bounds the kernel (stages of 64 columns ran 0.78
// to 0.87 ms, 128 0.50 to 0.54 ms, 256 0.41 to 0.45 ms at phase 7's shapes on
// an H100, tools/field_variants.py).
constexpr int OPEN_A_PITCH = OPEN_KS * 8 + 64;
constexpr int OPEN_B_PITCH = OPEN_KS * 8 + 32;
constexpr int OPEN_THREADS = 32 * (OPEN_WARPS + 1);  // and one producer warp

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

// The k order of a 32-column k-step.  Lane (g, t) of a warp reads, of each of
// its coefficient rows, the words 2t + 8i + h (i < 4, h < 2: 16 bytes at a
// time, a quarter warp on 128 contiguous bytes of two rows), and byte e of A
// fragment register f holds the word with i = 2 (f >> 1) + (e >> 1), h = e & 1:
// logical k = 16 (f >> 1) + 4t + e is column 16 (f >> 1) + 2t + (e & 1) + 8 (e >> 1).
// The table stores a k-step's 32 power bytes of a plane so that lane t's two
// B registers are the 8 bytes from 8t: position pos = 8t + 4 hi + e holds
// logical k = 16 hi + 4t + e, the column below.
__device__ __forceinline__ int open_column(int pos) {
  const int t = pos >> 3, hi = (pos >> 2) & 1, e = pos & 3;
  return 16 * hi + 2 * t + (e & 1) + 8 * (e >> 1);
}

// The power table: row 2j + part (part 0 the real one) of point j is n_pad
// words of byte planes: the 32-column group kg at bytes [256 kg, 256 kg +
// 256), plane pl at 256 kg + 32 pl + pos, pos the column's place
// (open_column); zero from column n on.  A warp of block (x, j) takes a run
// of OPEN_TABLE_RUN groups of point j, stepping z^(32 kg) by z^32; lane pos
// makes the word at position pos of a group, and each plane's 32 bytes are
// gathered by shuffles into 8 words that 8 lanes store side by side.
constexpr int OPEN_TABLE_RUN = 16;

__global__ void __launch_bounds__(OPEN_TABLE_THREADS)
field_open_table_kernel(const uint64_t* __restrict__ z_re, const uint64_t* __restrict__ z_im,
                        long long n, long long groups, uint8_t* __restrict__ table) {
  __shared__ uint64_t zu_re[32], zu_im[32];  // z^open_column(pos), pos < 32
  const int j = blockIdx.y;
  const Ext z{z_re[j], z_im[j]};
  if (threadIdx.x < 32) {
    const Ext p = ext_pow(z, open_column(threadIdx.x));
    zu_re[threadIdx.x] = p.re;
    zu_im[threadIdx.x] = p.im;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long kg0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * OPEN_TABLE_RUN;
  if (kg0 >= groups) return;  // uniform across the warp
  const Ext zl{zu_re[lane], zu_im[lane]};
  const Ext step = ext_pow(z, 32);
  const uint64_t step_im7 = gl::mul(step.im, 7);
  Ext base = ext_pow(z, 32ull * (unsigned long long)kg0);
  const int u = open_column(lane);
  for (int i = 0; i < OPEN_TABLE_RUN && kg0 + i < groups; ++i) {
    const long long kg = kg0 + i;
    uint64_t vr = 0, vi = 0;
    if (32 * kg + u < n) {
      const Ext v = ext_mul(base, zl);
      vr = gl::canon(v.re);
      vi = gl::canon(v.im);
    }
    uint8_t* out_re = table + ((2ll * j) * groups + kg) * 256;
    uint8_t* out_im = table + ((2ll * j + 1) * groups + kg) * 256;
#pragma unroll
    for (int pl = 0; pl < 8; ++pl) {
      // lane 4w gathers the bytes of lanes 4w .. 4w + 3, lowest first
      uint32_t xr = (uint32_t)(vr >> (8 * pl)) & 0xFF, xi = (uint32_t)(vi >> (8 * pl)) & 0xFF;
      xr |= __shfl_down_sync(0xffffffffu, xr, 1) << 8;
      xi |= __shfl_down_sync(0xffffffffu, xi, 1) << 8;
      xr |= __shfl_down_sync(0xffffffffu, xr, 2) << 16;
      xi |= __shfl_down_sync(0xffffffffu, xi, 2) << 16;
      if ((lane & 3) == 0) {
        *reinterpret_cast<uint32_t*>(out_re + 32 * pl + lane) = xr;
        *reinterpret_cast<uint32_t*>(out_im + 32 * pl + lane) = xi;
      }
    }
    base = ext_mul_by(base, step, step_im7);
  }
}

// One batch of the table of batches.
struct OpenBatch {
  const uint64_t* coeffs;  // row r: coeffs + r * stride (words)
  long long stride;
  long long out;  // value (part, point j, row r) at out + (part * k + j) * rows + r of a slice
  int rows, k;
  int group0;  // its first block of OPEN_ROWS rows in blockIdx.x
  int point[OPEN_MAX_POINTS];  // point j's rows 2 point[j], 2 point[j] + 1 of the table
};

struct OpenArgs {
  OpenBatch batch[OPEN_MAX_BATCHES];
  int batches;
  const uint64_t* table;  // (2 * points, n_pad) words of byte planes
  long long n, n_pad;
  long long total;        // words of a slice's values: sum of 2 k rows
  uint64_t* partial;      // slice s at partial + s * total
  int stage_bytes;        // OPEN_ROWS A rows, then the launch's power rows
};

// A stage's bytes for power rows of at most `ntiles` n-tiles.
constexpr long long open_stage_bytes(int ntiles) {
  return (long long)OPEN_ROWS * OPEN_A_PITCH + 8ll * ntiles * OPEN_B_PITCH;
}

// y[e] = byte e of x0, x1, x2, x3 (a 4 x 4 byte transpose, 8 permutes).
__device__ __forceinline__ void byte_transpose(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                                               uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140), t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140), t3 = __byte_perm(x2, x3, 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// d += a b: one m16n8k32 product of u8 planes into s32 sums.
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (blockIdx.x, blockIdx.y): rows [r0, r0 + OPEN_ROWS) of the batch whose
// groups hold blockIdx.x, columns [OPEN_CHUNK y, OPEN_CHUNK (y + 1)) of n.
// Warp w < OPEN_WARPS takes m-tile w % OPEN_MTILES (16 rows) and n-tile
// w / OPEN_MTILES (8 of the batch's 2k power rows, 2j + part for point j),
// where both exist; warp OPEN_WARPS is the producer.  Writes the canonical
// values of the slice: partial[y * total + out + (part * k + j) * rows + r].
__global__ void __launch_bounds__(OPEN_THREADS, 1)
field_open_kernel(const __grid_constant__ OpenArgs a) {
  extern __shared__ __align__(128) uint8_t open_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(open_smem + OPEN_STAGES * a.stage_bytes);
  uint64_t* empty = full + OPEN_STAGES;
  int b = 0;
  while (b + 1 < a.batches && (int)blockIdx.x >= a.batch[b + 1].group0) ++b;
  const OpenBatch& B = a.batch[b];
  const int r0 = ((int)blockIdx.x - B.group0) * OPEN_ROWS;
  const int rows = min(OPEN_ROWS, B.rows - r0);
  const int npc = 2 * B.k;
  const int mtiles = (rows + 15) / 16, ntiles = (npc + 7) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % OPEN_MTILES, nt = warp / OPEN_MTILES;
  const long long c_begin = (long long)blockIdx.y * OPEN_CHUNK;
  const long long c_end = min(a.n, c_begin + OPEN_CHUNK);
  const int stages = (int)((c_end - c_begin + OPEN_KS - 1) / OPEN_KS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < OPEN_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], mtiles * ntiles);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == OPEN_WARPS) {
    if (lane == 0) {
      for (int it = 0; it < stages; ++it) {
        const int s = it % OPEN_STAGES;
        if (it >= OPEN_STAGES) mbar_wait(&empty[s], ((it / OPEN_STAGES) - 1) & 1);
        const long long c0 = c_begin + (long long)it * OPEN_KS;
        // the last stage of the columns copies what is left of the rows; the
        // table's rows are zero from n to n_pad, so a stage's stale words
        // past n meet zero powers
        const uint32_t a_bytes = (uint32_t)(min((long long)OPEN_KS, c_end - c0) * 8);
        uint8_t* st = open_smem + s * a.stage_bytes;
        mbar_expect_tx(&full[s], rows * a_bytes + npc * OPEN_KS * 8);
        for (int r = 0; r < rows; ++r)
          bulk_copy(st + r * OPEN_A_PITCH, B.coeffs + (long long)(r0 + r) * B.stride + c0, a_bytes,
                    &full[s]);
        for (int q = 0; q < npc; ++q)
          bulk_copy(st + OPEN_ROWS * OPEN_A_PITCH + q * OPEN_B_PITCH,
                    a.table + (long long)(2 * B.point[q >> 1] + (q & 1)) * a.n_pad + c0,
                    OPEN_KS * 8, &full[s]);
      }
      // the block's shared memory stays until the consumers have read it all
      for (int it = max(0, stages - OPEN_STAGES); it < stages; ++it)
        mbar_wait(&empty[it % OPEN_STAGES], (it / OPEN_STAGES) & 1);
    }
    return;
  }
  if (mt >= mtiles || nt >= ntiles) return;
  const int g = lane >> 2, t = lane & 3;
  // lane (g, t): coefficient rows 16 mt + g and + 8, from word 2t; power row
  // 8 nt + g, from byte 8t
  const uint8_t* a_lane = open_smem + (16 * mt + g) * OPEN_A_PITCH + 16 * t;
  const uint8_t* b_lane = open_smem + OPEN_ROWS * OPEN_A_PITCH + (8 * nt + g) * OPEN_B_PITCH + 8 * t;
  uint32_t acc[OPEN_CLASSES][4];
#pragma unroll
  for (int s = 0; s < OPEN_CLASSES; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0;
  for (int it = 0; it < stages; ++it) {
    const int s = it % OPEN_STAGES;
    mbar_wait(&full[s], (it / OPEN_STAGES) & 1);
    const uint8_t* a_st = a_lane + s * a.stage_bytes;
    const uint8_t* b_st = b_lane + s * a.stage_bytes;
#pragma unroll
    for (int ks = 0; ks < OPEN_KS / 32; ++ks) {
      // lo[f][e], hi[f][e]: the halves of the word in byte e of A register f
      uint32_t lo[4][4], hi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {  // rows g and g + 8
          const uint4 v =
              *reinterpret_cast<const uint4*>(a_st + r8 * 8 * OPEN_A_PITCH + ks * 256 + i * 64);
          const int f = 2 * (i >> 1) + r8, e = 2 * (i & 1);
          lo[f][e] = v.x;
          hi[f][e] = v.y;
          lo[f][e + 1] = v.z;
          hi[f][e + 1] = v.w;
        }
      }
      uint32_t planes[8][4];  // plane p of the A fragment
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        uint32_t y[4];
        byte_transpose(lo[f][0], lo[f][1], lo[f][2], lo[f][3], y);
#pragma unroll
        for (int p = 0; p < 4; ++p) planes[p][f] = y[p];
        byte_transpose(hi[f][0], hi[f][1], hi[f][2], hi[f][3], y);
#pragma unroll
        for (int p = 0; p < 4; ++p) planes[4 + p][f] = y[p];
      }
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) {
        const uint2 bv = *reinterpret_cast<const uint2*>(b_st + ks * 256 + pb * 32);
#pragma unroll
        for (int pa = 0; pa < 8; ++pa) mma_u8(acc[pa + pb], planes[pa], bv.x, bv.y);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  // the class sums folded: sum_s acc[s] 2^8s mod p.  Accumulator i is row
  // 16 mt + g + 8 (i >> 1), power row 8 nt + 2t + (i & 1).
  gl::Acc fold[4];
  uint64_t w = 1;
#pragma unroll
  for (int s = 0; s < OPEN_CLASSES; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fold[i].mac(acc[s][i], w);
    w = gl::mul(w, 256);
  }
  uint64_t* out = a.partial + (long long)blockIdx.y * a.total + B.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 16 * mt + g + 8 * (i >> 1), q = 8 * nt + 2 * t + (i & 1);
    if (r < B.rows && q < npc)
      out[(long long)((q & 1) * B.k + (q >> 1)) * B.rows + r] = gl::canon(fold[i].reduce_lazy());
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
// The ring; ops/kernels.py perm_quotient_plan mirrors it.  Persistent blocks
// (PERM_MIN_BLOCKS an SM) walk tiles of `tile` = min(PERM_TILE, n_lde)
// columns, one thread a column.  A tile's first stage is its head: x (slot
// 0), l0 (slot 1) and Z of challenge j (slot 2 + j); then each chunk k of
// `chunk` routed wires takes ceil(chunk / PERM_PAIRS) stages: wire i0 + r of
// the chunk in slot r and its sigma row in slot PERM_PAIRS + r, and the
// chunk's last stage, but for the last chunk's, also the chain row k + 1
// (challenge j's partial k) of each challenge in slot 2 PERM_PAIRS + j.  Z
// at the next trace row is read from device memory.
constexpr int PERM_TILE = 256;
constexpr int PERM_PAIRS = 8;
constexpr int PERM_STAGE_ROWS = 2 * PERM_PAIRS + PERM_CHALLENGES;  // slots of a stage
constexpr int PERM_STAGES = 3;
constexpr int PERM_MIN_BLOCKS = 2;
static_assert(PERM_STAGE_ROWS >= 2 + PERM_CHALLENGES, "the head fits a stage");

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
  long long tiles;  // n_lde / tile
  int tile;         // columns a tile: min(PERM_TILE, n_lde)
  int routed, chunk;
  // the wires' and sigma rows in boxes of PERM_PAIRS rows of a tile (made
  // where routed >= PERM_PAIRS); a stage of fewer pairs copies row by row
  CUtensorMap wires_map, sigma_map;
};

// Fill ring slot s with stage st of the tile at column c0: the layout above,
// a tensor copy of PERM_PAIRS wire (sigma) rows or one bulk copy a row's
// segment of the tile, completing on the slot's `full` barrier.
__device__ __forceinline__ void perm_fill(const PermArgs& a, uint64_t* ring, uint64_t* full, int s,
                                          long long c0, int st, int per_chunk, int m) {
  constexpr int NC = PERM_CHALLENGES;
  const int T = a.tile;
  const uint32_t seg = (uint32_t)T * 8;  // bytes of a row's segment
  uint64_t* dst = ring + (long long)s * PERM_STAGE_ROWS * T;
  if (st == 0) {  // the head
    mbar_expect_tx(&full[s], (2 + NC) * seg);
    bulk_copy(dst, a.x + c0, seg, &full[s]);
    bulk_copy(dst + T, a.l0 + c0, seg, &full[s]);
    for (int j = 0; j < NC; ++j)
      bulk_copy(dst + (2 + j) * T, a.zs + (long long)j * m * a.zs_stride + c0, seg, &full[s]);
    return;
  }
  const int k = (st - 1) / per_chunk, q = (st - 1) % per_chunk;
  const int i0 = q * PERM_PAIRS, np = min(PERM_PAIRS, a.chunk - i0);
  const bool chain = q == per_chunk - 1 && k + 1 < m;
  mbar_expect_tx(&full[s], (2 * np + (chain ? NC : 0)) * seg);
  if (np == PERM_PAIRS) {
    bulk_copy_rows(dst, &a.wires_map, (int)c0, k * a.chunk + i0, &full[s]);
    bulk_copy_rows(dst + PERM_PAIRS * T, &a.sigma_map, (int)c0, k * a.chunk + i0, &full[s]);
  } else {
    for (int r = 0; r < np; ++r) {
      const long long col = (long long)k * a.chunk + i0 + r;
      bulk_copy(dst + r * T, a.wires + col * a.wires_stride + c0, seg, &full[s]);
      bulk_copy(dst + (PERM_PAIRS + r) * T, a.sigma + col * a.sigma_stride + c0, seg, &full[s]);
    }
  }
  if (chain) {
    for (int j = 0; j < NC; ++j)
      bulk_copy(dst + (2 * PERM_PAIRS + j) * T, a.zs + ((long long)j * m + 1 + k) * a.zs_stride + c0,
                seg, &full[s]);
  }
}

// out[j * n_lde + x] = sum_k alpha_j^k * term_k(x), canonical.  Block b takes
// the tiles b, b + gridDim.x, ..., thread xt column xt of each.  No thread is
// only a producer: thread 0 fills the first PERM_STAGES stages, and the warp
// that releases stage it last refills its slot with stage it + PERM_STAGES
// (last_to_release), so a block is PERM_TILE threads, PERM_MIN_BLOCKS fit an
// SM, and no warp waits for another.  Dynamic shared memory: the ring
// (PERM_STAGES stages of PERM_STAGE_ROWS x tile words), beta_j k_i (2 x
// routed words), the stages' full barriers, then their release counts.
template <bool WINDOW>
__global__ void __launch_bounds__(PERM_TILE, PERM_MIN_BLOCKS)
perm_quotient_kernel(const __grid_constant__ PermArgs a, uint64_t* __restrict__ out) {
  constexpr int NC = PERM_CHALLENGES;
  static_assert(NC == 2, "the alpha rows below are written out for two challenges");
  extern __shared__ __align__(128) uint64_t perm_smem[];
  __shared__ uint64_t alpha[NC][PERM_MAX_CHUNKS + 1];
  __shared__ uint64_t beta[NC], gamma[NC];
  const int T = a.tile;
  uint64_t* ring = perm_smem;
  uint64_t* beta_k = ring + (long long)PERM_STAGES * PERM_STAGE_ROWS * T;  // [j * routed + i]
  uint64_t* full = beta_k + NC * a.routed;
  int* released = reinterpret_cast<int*>(full + PERM_STAGES);
  const int m = a.routed / a.chunk;
  const int per_chunk = (a.chunk + PERM_PAIRS - 1) / PERM_PAIRS;  // stages a chunk
  const int per_tile = 1 + m * per_chunk;                         // stages a tile
  // a position in the block's walk: its tile's first column and its stage in the tile
  struct Pos {
    long long c0;
    int st;
  };
  const long long c_step = (long long)gridDim.x * T, c_end = a.tiles * T;
  const auto step = [&](Pos& p) {
    if (++p.st == per_tile) {
      p.st = 0;
      p.c0 += c_step;
    }
  };
  for (int t = threadIdx.x; t < NC * a.routed; t += blockDim.x)
    beta_k[t] = gl::mul(a.betas[t / a.routed], a.k_shifts[t % a.routed]);
  for (int t = threadIdx.x; t <= m; t += blockDim.x) {
    alpha[0][t] = a.alpha[0][t];
    alpha[1][t] = a.alpha[1][t];
  }
  if (threadIdx.x < NC) {
    beta[threadIdx.x] = a.betas[threadIdx.x];
    gamma[threadIdx.x] = a.gammas[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < PERM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_fence_init();
  }
  // the walk: `fill` the next stage to fill (PERM_STAGES ahead of the one
  // read), slot s of parity `phase` the one read
  Pos fill{(long long)blockIdx.x * T, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < PERM_STAGES && fill.c0 < c_end; ++s, step(fill))
      perm_fill(a, ring, full, s, fill.c0, fill.st, per_chunk, m);
  } else {
    for (int s = 0; s < PERM_STAGES; ++s) step(fill);
  }
  __syncthreads();
  // a thread past the tile (a tile below PERM_TILE) computes column 0's
  // words and stores nothing: no branch in the loops
  const int xt = threadIdx.x;
  const bool live = xt < T;
  const int xc = live ? xt : 0;
  int s = 0;
  uint32_t phase = 0;
  // the stage read: release its slot, which the last warp to do so refills
  const auto release = [&]() {
    if (last_to_release(&released[s], PERM_TILE / 32) && fill.c0 < c_end)
      perm_fill(a, ring, full, s, fill.c0, fill.st, per_chunk, m);
    step(fill);
    if (++s == PERM_STAGES) {
      s = 0;
      phase ^= 1;
    }
  };
  const auto stage = [&]() {
    mbar_wait(&full[s], phase);
    return ring + (long long)s * PERM_STAGE_ROWS * T + xc;
  };
  for (long long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long x = tile * T + xc;
    // Z at the next trace row, 2 words of 184 a column: a direct load, issued
    // here so that its latency hides behind the tile
    const long long x_next = WINDOW ? x + a.next : (x + a.next) & (a.n_lde - 1);
    uint64_t z_next[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) z_next[j] = a.zs[(long long)j * m * a.zs_stride + x_next];
    // the sum of the terms, alpha_0 l0 (Z - 1) and alpha_{k+1} (chain[k+1]
    // den_k - chain[k] num_k), one 96-bit column sum a challenge
    gl::Acc sum[NC];
    uint64_t prev[NC];  // chain[k]
    const uint64_t* st = stage();
    const uint64_t xv = st[0], l0 = st[T];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const uint64_t z = st[(2 + j) * T];
      sum[j].mac(alpha[j][0], gl::sub_lazy(gl::mul_lazy(l0, z), l0));
      prev[j] = z;
    }
    release();
    for (int k = 0; k < m; ++k) {
      uint64_t num[NC], den[NC], next[NC];  // lazy running products of the chunk; chain[k+1]
      for (int q = 0; q < per_chunk; ++q) {
        st = stage();
        const int i0 = q * PERM_PAIRS, np = min(PERM_PAIRS, a.chunk - i0);
#pragma unroll
        for (int r = 0; r < PERM_PAIRS; ++r) {
          if (r < np) {
            const uint64_t w = st[r * T], sg = st[(PERM_PAIRS + r) * T];
            const int i = i0 + r, col = k * a.chunk + i;  // the wire's place in its chunk
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              const uint64_t wg = gl::add_lazy(w, gamma[j]);
              const uint64_t nt = gl::mul_add_lazy(beta_k[j * a.routed + col], xv, wg);  // w + beta k_i x + gamma
              const uint64_t dt = gl::mul_add_lazy(beta[j], sg, wg);  // w + beta sigma_i + gamma
              num[j] = i ? gl::mul_lazy(num[j], nt) : nt;
              den[j] = i ? gl::mul_lazy(den[j], dt) : dt;
            }
          }
        }
        if (q == per_chunk - 1) {
#pragma unroll
          for (int j = 0; j < NC; ++j)
            next[j] = k + 1 < m ? st[(2 * PERM_PAIRS + j) * T] : z_next[j];
        }
        release();
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const uint64_t t = gl::sub_lazy(gl::mul_lazy(next[j], den[j]),
                                        gl::canon(gl::mul_lazy(prev[j], num[j])));
        sum[j].mac(alpha[j][k + 1], t);
        prev[j] = next[j];
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        out[(long long)j * a.n_lde + x] = gl::canon(sum[j].reduce_lazy());
    }
  }
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
// The row-sum and epilogue loops run over a thread's G_COLS columns, and
// G_COLS = 1 (two columns a thread spilled).  The loops are kept for the code
// ptxas makes of them, not for generality: the same source with G_COLS
// substituted by hand (one accumulator pair, a scalar `live`, no arrays)
// also takes 82 registers and spills nothing, but its row-sum loops carry
// more register copies (IMAD.MOV and MOV: 161 against 73 in P's stage loop,
// 513 against 383 instructions; tools/cuda_sass_counts.py --source field.cu),
// and it ran 2.76 to 2.81 against 2.63 to 2.71 ms at 2^21 (an H100 at 700 W,
// tools/field_variants.py).  Moving the `live` guard outside the row loop
// cost more (2.88 to 2.96 ms).  Check the SASS and time both forms before
// removing the loops.
constexpr int G_HALF = 256;        // threads of a role
constexpr int G_COLS = 1;          // columns a thread: x + c G_HALF, c < G_COLS
constexpr int G_TILE = 256;        // columns a tile: G_COLS G_HALF
constexpr int G_STAGE_ROWS = 8;    // rows of one batch a stage
constexpr int G_STAGES = 8;
constexpr int G_THREADS = 544;     // the row-sum and the epilogue threads, and a producer warp
static_assert(G_THREADS == 2 * G_HALF + 32 && G_TILE == G_COLS * G_HALF, "G's roles");
static_assert(G_CHUNK % G_STAGE_ROWS == 0, "a stage's rows share one reduction");

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
  long long tiles;              // n_lde / tile
  int tile;                     // columns a tile (even, at most G_TILE)
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

// G(x) at column x of the coset, canonical: the epilogue of one column, from
// its four ext sums b_re, b_im.  The norms' inverses by Montgomery's trick,
// one Fermat inversion of all of them (a zero norm's inverse is 0, as the
// plain version's), each consumed as the walk back makes it.  Rolled loops:
// the epilogue threads run this code while the row-sum threads run theirs,
// and unrolled (some 7,000 instructions) the two roles evict each other from
// the instruction cache (3.25 to 3.32 against 2.61 to 2.72 ms at 2^21 on an
// H100, tools/field_variants.py).
struct GSpecs {
  const uint64_t *zre, *zim, *c7, *yre, *yim, *are, *aim, *aim7;
};

// x^(2^n), lazy, a rolled loop.
__device__ __forceinline__ uint64_t sq_rolled(uint64_t x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = gl::mul_lazy(x, x);
  return x;
}

// gl::inv_fermat's chain with rolled squarings, out of line: a^(p-2), canonical.
__device__ __noinline__ uint64_t inv_rolled(uint64_t a) {
  const uint64_t t2 = gl::mul_lazy(sq_rolled(a, 1), a);
  const uint64_t t3 = gl::mul_lazy(sq_rolled(t2, 1), a);
  const uint64_t t6 = gl::mul_lazy(sq_rolled(t3, 3), t3);
  const uint64_t t12 = gl::mul_lazy(sq_rolled(t6, 6), t6);
  const uint64_t t24 = gl::mul_lazy(sq_rolled(t12, 12), t12);
  const uint64_t t30 = gl::mul_lazy(sq_rolled(t24, 6), t6);
  const uint64_t t31 = gl::mul_lazy(sq_rolled(t30, 1), a);
  const uint64_t t63 = gl::mul_lazy(sq_rolled(t31, 32), t31);
  return gl::canon(gl::mul_lazy(sq_rolled(t63, 1), a));
}

__device__ __forceinline__ Ext g_epilogue(const GArgs& g, const GSpecs& sp, uint64_t xv,
                                          const uint64_t (&b_re)[G_TAGS],
                                          const uint64_t (&b_im)[G_TAGS]) {
  const NormOf norm_of{xv, sp.zre, sp.c7};
  uint64_t prefix[G_MAX_SPECS], norms[G_MAX_SPECS];
  uint64_t run = 1;
#pragma unroll 1
  for (int j = 0; j < g.specs; ++j) {
    const uint64_t d = norm_of(j);
    norms[j] = d;
    prefix[j] = run;
    if (d != 0) run = gl::mul_lazy(run, d);
  }
  uint64_t inv = inv_rolled(run);
  gl::Acc acc_re, acc_im;
#pragma unroll 1
  for (int j = g.specs - 1; j >= 0; --j) {
    const uint64_t dre = gl::sub(xv, sp.zre[j]);
    const uint64_t ninv = gl::batch_back(inv, prefix[j], norms[j]);
    // 1 / (x - z) = (dre + z_im phi) / norm
    const Ext den{gl::mul(dre, ninv), gl::mul(sp.zim[j], ninv)};
    const int t = g.spec_tag[j];
    const Ext num{gl::sub(pick(b_re, t), sp.yre[j]), gl::sub(pick(b_im, t), sp.yim[j])};
    const Ext q = ext_mul(num, den);
    acc_re.mac(q.re, sp.are[j]);
    acc_re.mac(q.im, sp.aim7[j]);
    acc_im.mac(q.re, sp.aim[j]);
    acc_im.mac(q.im, sp.are[j]);
  }
  return {gl::canon(acc_re.reduce_lazy()), gl::canon(acc_im.reduce_lazy())};
}

// out_re[x], out_im[x] = G(x), canonical.  Block b takes the tiles b, b +
// gridDim.x, ...; a tile's stages are its batches' rows in order, G_STAGE_ROWS
// of one batch at a time (the last of a batch may hold fewer), each a tile's
// segment of those rows.  Three roles: the producer thread fills the ring;
// row-sum thread x (warps 0 to 7) takes column x of each tile's rows from
// the ring and hands its four ext sums to epilogue thread x (warps 8 to 15)
// through one of two hand-off slots (barriers `hfull`,
// `hempty`), so that a tile's epilogue (the specs' norms, their inversion,
// the weighted sum) runs while the next tile's rows load and are summed.
// Dynamic shared memory: the ring (G_STAGES stages of G_STAGE_ROWS x tile
// words), the two hand-off slots (2 G_TAGS rows of tile words each), the
// weights a_re, a_im of the total rows, then the barriers: the stages' full
// and empty, the slots' full and empty.
__global__ void __launch_bounds__(G_THREADS, 1)
fri_g_kernel(const __grid_constant__ GArgs g, uint64_t* __restrict__ out_re,
             uint64_t* __restrict__ out_im) {
  extern __shared__ __align__(128) uint64_t g_smem[];
  uint64_t* ring = g_smem;
  uint64_t* hand = ring + G_STAGES * G_STAGE_ROWS * g.tile;
  uint64_t* weights = hand + 2 * 2 * G_TAGS * g.tile;  // a_re[0..total), a_im[0..total)
  uint64_t* full = weights + 2 * g.total;
  uint64_t* empty = full + G_STAGES;
  uint64_t* hfull = empty + G_STAGES;
  uint64_t* hempty = hfull + 2;
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
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G_HALF / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&hfull[s], G_HALF);
      mbar_init(&hempty[s], G_HALF);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t seg = (uint32_t)g.tile * 8;  // bytes of a row's segment
  if (threadIdx.x >= 2 * G_HALF) {  // the producer warp
    if (lane == 0) {
      int it = 0;
      for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
        const long long c0 = tile * g.tile;
        for (int t = 0; t < G_TAGS; ++t) {
          for (int i0 = 0; i0 < g.rows[t]; i0 += G_STAGE_ROWS, ++it) {
            const int s = it % G_STAGES;
            if (it >= G_STAGES) mbar_wait(&empty[s], ((it / G_STAGES) - 1) & 1);
            const int nr = min(G_STAGE_ROWS, g.rows[t] - i0);
            mbar_expect_tx(&full[s], nr * seg);
            uint64_t* st = ring + (long long)s * G_STAGE_ROWS * g.tile;
            for (int r = 0; r < nr; ++r)
              bulk_copy(st + (long long)r * g.tile, g.lde[t] + (long long)(i0 + r) * g.stride[t] + c0,
                        seg, &full[s]);
          }
        }
      }
      // the block's shared memory stays until the consumers have read it all
      for (int i = max(0, it - G_STAGES); i < it; ++i)
        mbar_wait(&empty[i % G_STAGES], (i / G_STAGES) & 1);
    }
    return;
  }
  const int xt = threadIdx.x % G_HALF;  // columns xt + c G_HALF of a tile, c < G_COLS
  bool live[G_COLS];
#pragma unroll
  for (int c = 0; c < G_COLS; ++c) live[c] = xt + c * G_HALF < g.tile;
  if (threadIdx.x < G_HALF) {  // the row sums
    int it = 0, k = 0;
    for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++k) {
      // B_t(x) for the four batches: every row read once, from the ring;
      // b[c][0] the real sums of column xt + c G_HALF, b[c][1] the imaginary
      uint64_t b[G_COLS][2][G_TAGS];
#pragma unroll
      for (int t = 0; t < G_TAGS; ++t) {
        uint64_t sum[G_COLS][2];
        gl::Acc acc[G_COLS][2];
#pragma unroll
        for (int c = 0; c < G_COLS; ++c) sum[c][0] = sum[c][1] = 0;
        const uint64_t* w_re = weights + g.offset[t];
        const uint64_t* w_im = weights + g.total + g.offset[t];
        for (int i0 = 0; i0 < g.rows[t]; i0 += G_STAGE_ROWS, ++it) {
          const int s = it % G_STAGES;
          mbar_wait(&full[s], (it / G_STAGES) & 1);
          const int nr = min(G_STAGE_ROWS, g.rows[t] - i0);
          const uint64_t* st = ring + (long long)s * G_STAGE_ROWS * g.tile + xt;
#pragma unroll
          for (int r = 0; r < G_STAGE_ROWS; ++r) {
            if (r < nr) {
              const uint64_t wr = w_re[i0 + r], wi = w_im[i0 + r];
#pragma unroll
              for (int c = 0; c < G_COLS; ++c) {
                if (live[c]) {
                  const uint64_t v = st[r * g.tile + c * G_HALF];
                  acc[c][0].mac(wr, v);
                  acc[c][1].mac(wi, v);
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
          if ((i0 + G_STAGE_ROWS) % G_CHUNK == 0) {
#pragma unroll
            for (int c = 0; c < G_COLS; ++c) {
#pragma unroll
              for (int part = 0; part < 2; ++part) {
                sum[c][part] = gl::add(sum[c][part], gl::canon(acc[c][part].reduce_lazy()));
                acc[c][part] = gl::Acc();
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < G_COLS; ++c) {
#pragma unroll
          for (int part = 0; part < 2; ++part)
            b[c][part][t] = gl::add(sum[c][part], gl::canon(acc[c][part].reduce_lazy()));
        }
      }
      const int slot = k & 1;
      if (k >= 2) mbar_wait(&hempty[slot], ((k >> 1) - 1) & 1);
      uint64_t* h = hand + (long long)slot * 2 * G_TAGS * g.tile + xt;
#pragma unroll
      for (int c = 0; c < G_COLS; ++c) {
        if (live[c]) {
#pragma unroll
          for (int t = 0; t < G_TAGS; ++t) {
            h[t * g.tile + c * G_HALF] = b[c][0][t];
            h[(G_TAGS + t) * g.tile + c * G_HALF] = b[c][1][t];
          }
        }
      }
      mbar_arrive(&hfull[slot]);
    }
    return;
  }
  const GSpecs sp{s_zre, s_zim, s_c7, s_yre, s_yim, s_are, s_aim, s_aim7};
  int k = 0;  // the epilogue
  for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++k) {
    const int slot = k & 1;
    mbar_wait(&hfull[slot], (k >> 1) & 1);
    uint64_t b_re[G_COLS][G_TAGS], b_im[G_COLS][G_TAGS];
    const uint64_t* h = hand + (long long)slot * 2 * G_TAGS * g.tile + xt;
#pragma unroll
    for (int c = 0; c < G_COLS; ++c) {
      if (live[c]) {
#pragma unroll
        for (int t = 0; t < G_TAGS; ++t) {
          b_re[c][t] = h[t * g.tile + c * G_HALF];
          b_im[c][t] = h[(G_TAGS + t) * g.tile + c * G_HALF];
        }
      }
    }
    mbar_arrive(&hempty[slot]);
#pragma unroll
    for (int c = 0; c < G_COLS; ++c) {
      if (live[c]) {
        const long long x = tile * g.tile + xt + c * G_HALF;
        const Ext v = g_epilogue(g, sp, g.x[x], b_re[c], b_im[c]);
        out_re[x] = v.re;
        out_im[x] = v.im;
      }
    }
  }
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

// The power table of `points` points (z_re, z_im) into `table` ((2 points,
// n_pad) words of byte planes, zero from column n on): one launch.
extern "C" int elp_field_open_table(const void* z_re, const void* z_im, int num_points, long long n,
                                    long long n_pad, void* table, void* stream) {
  if (num_points < 1 || num_points > 65535 || n < 1 || n_pad < n || n_pad % OPEN_KS)
    return (int)cudaErrorInvalidValue;
  const long long groups = n_pad / 32;
  const dim3 grid(blocks_for(groups, OPEN_TABLE_THREADS / 32 * OPEN_TABLE_RUN, 1ll << 30),
                  (unsigned)num_points);
  field_open_table_kernel<<<grid, OPEN_TABLE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(z_re), static_cast<const uint64_t*>(z_im), n, groups,
      static_cast<uint8_t*>(table));
  return (int)cudaGetLastError();
}

// The openings of `batches` batches from the power table of `num_points`
// points, in one or two launches: field_open_kernel over `blocks` row groups
// and `slices` column slices into `partial` ((slices, total) words), and,
// with more than one slice, field_open_sum_kernel into `out` (total words;
// with one slice `partial` is `out`).  Batch b: `coeffs[b]` (rows[b], n)
// with row stride `stride[b]` (words, even; rows 16-byte aligned), ks[b]
// points, its point j at row pair points[b * OPEN_MAX_POINTS + j] of the
// table, its values at outs[b] of a slice, its first row group group0[b].
// ops/kernels.py `field_open_plan` computes the sizes.
extern "C" int elp_field_open(int batches, const void* const* coeffs, const long long* stride,
                              const int* rows, const int* ks, const int* points,
                              const long long* outs, const int* group0, int blocks,
                              long long slices, int num_points, long long n, long long n_pad,
                              const void* table, long long total, void* partial, void* out,
                              void* stream) {
  if (batches < 1 || batches > OPEN_MAX_BATCHES || num_points < 1 || n < 2 || (n & 1) ||
      n_pad < n || n_pad % OPEN_KS || slices != (n + OPEN_CHUNK - 1) / OPEN_CHUNK ||
      slices > 65535 || blocks < 1 || total < 1)
    return (int)cudaErrorInvalidValue;
  OpenArgs a{};
  int groups = 0;
  long long count = 0;
  for (int b = 0; b < batches; ++b) {
    OpenBatch& B = a.batch[b];
    if (rows[b] < 1 || ks[b] < 1 || ks[b] > OPEN_MAX_POINTS || (stride[b] & 1) ||
        (rows[b] > 1 && stride[b] < n) || (reinterpret_cast<uintptr_t>(coeffs[b]) & 15) ||
        group0[b] != groups || outs[b] != count)
      return (int)cudaErrorInvalidValue;
    B.coeffs = static_cast<const uint64_t*>(coeffs[b]);
    B.stride = stride[b];
    B.rows = rows[b];
    B.k = ks[b];
    B.group0 = group0[b];
    B.out = outs[b];
    for (int j = 0; j < ks[b]; ++j) {
      const int p = points[b * OPEN_MAX_POINTS + j];
      if (p < 0 || p >= num_points) return (int)cudaErrorInvalidValue;
      B.point[j] = p;
    }
    groups += (rows[b] + OPEN_ROWS - 1) / OPEN_ROWS;
    count += 2ll * ks[b] * rows[b];
  }
  if (groups != blocks || count != total || (reinterpret_cast<uintptr_t>(table) & 15))
    return (int)cudaErrorInvalidValue;
  int ntiles = 1;
  for (int b = 0; b < batches; ++b) ntiles = max(ntiles, (2 * ks[b] + 7) / 8);
  a.stage_bytes = (int)open_stage_bytes(ntiles);
  const int shared = OPEN_STAGES * a.stage_bytes + 2 * OPEN_STAGES * 8;
  a.batches = batches;
  a.table = static_cast<const uint64_t*>(table);
  a.n = n;
  a.n_pad = n_pad;
  a.total = total;
  a.partial = static_cast<uint64_t*>(slices == 1 ? out : partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(field_open_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shared);
  if (err != cudaSuccess) return (int)err;
  field_open_kernel<<<dim3((unsigned)blocks, (unsigned)slices), OPEN_THREADS, shared, s>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess || slices == 1) return (int)err;
  field_open_sum_kernel<<<blocks_for(total, 256, 1ll << 30), 256, 0, s>>>(
      static_cast<const uint64_t*>(partial), slices, total, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

// One launch for the two challenges; `out` is (2, n_lde) and overlaps no input.
// `mask` is n_lde - 1 (the next row wraps), or -1 for the window form.  The
// wires, sigma and Z rows, x and l0 start 16-byte aligned with even row
// strides; `tile` columns a tile (min(PERM_TILE, n_lde), at least 16: a
// tensor copy's shared memory is 128-byte aligned), `blocks` persistent
// blocks.  ops/kernels.py `perm_quotient_plan` computes them.
extern "C" int elp_perm_quotient(const void* wires, long long wires_stride, const void* sigma,
                                 long long sigma_stride, const void* zs, long long zs_stride,
                                 const void* x, const void* l0, const void* k_shifts,
                                 const void* betas, const void* gammas, const void* alpha0,
                                 const void* alpha1, long long n_lde, long long mask, int rate,
                                 int routed, int chunk, void* out, int tile, int blocks,
                                 void* stream) {
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (n_lde < 16 || n_lde > (1ll << 30) || (n_lde & (n_lde - 1)) || (mask != n_lde - 1 && mask != -1) || rate < 0 ||
      rate > 30 || chunk < 1 || routed < chunk || routed % chunk || routed > PERM_MAX_ROUTED ||
      routed / chunk > PERM_MAX_CHUNKS || tile != (n_lde < PERM_TILE ? n_lde : PERM_TILE) ||
      blocks < 1 || (wires_stride & 1) || (sigma_stride & 1) || (zs_stride & 1) ||
      misaligned(wires) || misaligned(sigma) || misaligned(zs) || misaligned(x) || misaligned(l0))
    return (int)cudaErrorInvalidValue;
  const auto w = [](const void* p) { return static_cast<const uint64_t*>(p); };
  PermArgs a{w(wires), wires_stride, w(sigma), sigma_stride, w(zs), zs_stride, w(x), w(l0),
             w(k_shifts), w(betas), w(gammas), {w(alpha0), w(alpha1)}, n_lde,
             1ll << rate, n_lde / tile, tile, routed, chunk};
  if (routed >= PERM_PAIRS) {
    int e = rows_map(&a.wires_map, wires, routed, n_lde, wires_stride, PERM_PAIRS, tile);
    if (!e) e = rows_map(&a.sigma_map, sigma, routed, n_lde, sigma_stride, PERM_PAIRS, tile);
    if (e) return e;
  }
  const auto kernel = mask == -1 ? perm_quotient_kernel<true> : perm_quotient_kernel<false>;
  const size_t shared =
      ((size_t)PERM_STAGES * PERM_STAGE_ROWS * tile + 2 * (size_t)routed + PERM_STAGES) * 8 +
      PERM_STAGES * sizeof(int);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, PERM_TILE, shared, static_cast<cudaStream_t>(stream)>>>(
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
// `lde`, `stride`, `rows`: the four batches P, W, Z, Q (rows 16-byte aligned,
// even strides); `spec_tag`: the batch of each of `specs` specs (ints, read
// on the host); `tile` columns a tile (even, dividing n_lde), `blocks`
// persistent blocks.  ops/kernels.py `fri_g_plan` computes them.
extern "C" int elp_fri_g(const void* const* lde, const long long* stride, const int* rows,
                         const int* spec_tag, int specs, const void* x, const void* a_re,
                         const void* a_im, const void* y_re, const void* y_im, const void* z_re,
                         const void* z_im, long long n_lde, int tile, int blocks, void* out_re,
                         void* out_im, void* stream) {
  if (specs < 1 || specs > G_MAX_SPECS || n_lde < 2 || tile < 2 || tile > G_TILE || (tile & 1) ||
      n_lde % tile || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const auto w = [](const void* p) { return static_cast<const uint64_t*>(p); };
  GArgs g{};
  int total = 0;
  for (int t = 0; t < G_TAGS; ++t) {
    if (rows[t] < 0 || (rows[t] > 0 && ((stride[t] & 1) || (rows[t] > 1 && stride[t] < n_lde) ||
                                        (reinterpret_cast<uintptr_t>(lde[t]) & 15))))
      return (int)cudaErrorInvalidValue;
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
  g.tile = tile;
  g.tiles = n_lde / tile;
  const size_t shared = ((size_t)G_STAGES * G_STAGE_ROWS * tile + 4 * (size_t)G_TAGS * tile +
                         2 * (size_t)total + 2 * G_STAGES + 4) *
                        sizeof(uint64_t);
  cudaError_t err =
      cudaFuncSetAttribute(fri_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  fri_g_kernel<<<(unsigned)blocks, G_THREADS, shared, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<uint64_t*>(out_re), static_cast<uint64_t*>(out_im));
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

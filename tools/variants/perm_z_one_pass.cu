// The permutation argument's rows [Z, p_0, ..., p_{m-2}] of every
// challenge in ONE launch: a variant of csrc/field.cu's perm_z_kernel,
// perm_z_scan_kernel and perm_z_fixup_kernel (three launches), kept off the
// main path because it ran slower on an H100 (PERF.md section 6).
// tools/variants/perm_z_one_pass.py builds it beside the package's kernels,
// checks its words against kernels.perm_z and times both in turns.
//
// A block draws a ticket for its tile of columns (tiles start in order,
// whatever order the card schedules blocks in), takes a column a thread for
// all challenges, reading each routed wire and sigma word once, turns its
// challenges * m quotients into words with ONE Fermat power (gl::batch_div
// over shared memory), keeps their running products rat_pref[k] in shared
// memory and scans the row ratios across the block (warp shuffles, then the
// warps' products in shared memory); then warp w runs the decoupled
// look-back (Merrill and Garland, NVIDIA 2016) of challenges w, w + warps,
// ...: it publishes the tile's product, multiplies its predecessors'
// published products back to the nearest inclusive one and publishes its
// own inclusive prefix; last each thread writes Z = prefix x its in-block
// exclusive product and p_k = Z rat_pref[k] straight from shared memory.
// The look-back state (a status, the tile's product and its inclusive
// product a challenge and tile, and the ticket counter) persists between
// launches: each launch brings its ticket base and an epoch, and a status of
// another epoch reads as not yet published, so nothing is reset.
//
// Why it is slower than the three launches (0.393 against 0.348 ms at (80,
// 2^18), two challenges): the tiles of a wave of 264 resident blocks finish
// together, so their look-backs run while every SM waits (0.03 to 0.04 ms:
// the kernel without its look-back, words wrong, took 0.356), and the pass
// alone writes every word after the block's barrier where the three
// launches' first pass stored its running products between its products.
// A window of 8 statuses a lane (ld.acquire each) and one Fermat power a
// block instead of a column both ran slower (0.414 and 0.399).
#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int PERM_CHALLENGES = 2;   // as csrc/field.cu
constexpr int PERM_MAX_ROUTED = 256;
constexpr int PERM_MAX_CHUNKS = 64;

constexpr int PERM_Z_MAX_THREADS = 256;
// the block scan's shared words: one a warp, and the last for the block's product
static_assert(PERM_Z_MAX_THREADS / 32 < 32, "a block's warps and its product fit one warp's lanes");
// a look-back status word is epoch * 4 + one of these
constexpr uint64_t PERM_Z_AGGREGATE = 1;  // the tile's own product is published
constexpr uint64_t PERM_Z_INCLUSIVE = 2;  // the product of every tile up to it is published

struct PermZArgs {
  const uint64_t* wires;  // routed wire i at column x: wires[i * wires_stride + x]
  long long wires_stride;
  const uint64_t* sigma;  // sigma_i at column x: sigma[i * sigma_stride + x]
  long long sigma_stride;
  const uint64_t* omega;     // (n,) the subgroup's points
  const uint64_t* k_shifts;  // (routed,)
  const uint64_t* betas;     // (challenges,)
  const uint64_t* gammas;
  uint64_t* out;  // (challenges * m, n), rows of n words: challenge j's Z at
                  // row j * m, its partial k at row j * m + 1 + k
  // the look-back state, kept between launches (perm_z_one_pass.py
  // `state`): the ticket counter, then for each challenge j and tile
  // i < cap the status, the tile's own product and its inclusive product at
  // [j * cap + i]
  unsigned long long* ticket;
  uint64_t* status;
  uint64_t* aggregate;
  uint64_t* inclusive;
  long long n, cap;
  unsigned long long ticket_base;  // the ticket this launch's first tile draws
  unsigned long long epoch;        // this launch's, in every status it writes
  int routed, chunk, challenges;
};

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

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

// The decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016) of challenge j for `tile`,
// whose own product is `own`; every lane of one warp calls it.  Returns the
// product of every earlier tile's own product, the tile's exclusive prefix
// (1 for tile 0: Z is 1 at the first column).  A tile past 0 first publishes
// `own` as its aggregate; then the warp reads the statuses of the 32 nearest
// tiles not yet multiplied in (lane l the tile l back) and multiplies, in one
// shuffle reduction, the products of those up to and including the nearest
// inclusive one, or of those before the nearest one not yet published, whose
// status it reads again on the next step (tiles are drawn in order, so that
// tile belongs to a block that runs).  Last the tile publishes prefix * own
// as inclusive.  A publish writes the value, then the status with release; a
// read takes the status with acquire, then the value its flag names.  A
// status of another epoch reads as not yet published.
__device__ __forceinline__ uint64_t look_back(const PermZArgs& a, int j, long long tile,
                                              uint64_t own) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)j * a.cap;
  const uint64_t epoch = a.epoch << 2;
  uint64_t prefix = 1;
  if (tile > 0) {
    if (lane == 0) {
      store_relaxed(a.aggregate + row + tile, own);
      store_release(a.status + row + tile, epoch | PERM_Z_AGGREGATE);
    }
    long long next = tile - 1;  // the nearest tile not yet multiplied in
    while (true) {
      const long long i = next - lane;
      const uint64_t s = i >= 0 ? load_acquire(a.status + row + i) : epoch | PERM_Z_INCLUSIVE;
      const bool ready = (s & ~3ull) == epoch;
      const bool inclusive = ready && (s & 3) == PERM_Z_INCLUSIVE;
      const unsigned waiting = __ballot_sync(0xffffffffu, !ready);
      const unsigned found = __ballot_sync(0xffffffffu, inclusive);
      const int first_waiting = waiting ? __ffs(waiting) - 1 : 32;
      const int first_found = found ? __ffs(found) - 1 : 32;
      const int take = first_found < first_waiting ? first_found + 1 : first_waiting;
      uint64_t v = 1;
      if (lane < take && i >= 0)
        v = load_relaxed((inclusive ? a.inclusive : a.aggregate) + row + i);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        v = gl::mul(v, __shfl_xor_sync(0xffffffffu, (unsigned long long)v, off));
      prefix = gl::mul(prefix, v);
      if (first_found < first_waiting) break;
      next -= take;
      if (take == 0) __nanosleep(64);
    }
  }
  if (lane == 0) {
    store_relaxed(a.inclusive + row + tile, gl::mul(prefix, own));
    store_release(a.status + row + tile, epoch | PERM_Z_INCLUSIVE);
  }
  return prefix;
}

// The one pass: a block draws a ticket, which names its tile of blockDim.x
// columns (tiles in the order the blocks start), and thread t takes the
// tile's column x for every challenge.  It reads each routed wire and sigma
// word once (words loaded one group of PERM_Z_GROUP wires ahead), keeps
// num_k = prod (w + beta k_i omega^x + gamma) and den_k = prod (w + beta
// sigma_i + gamma) of each chunk k in shared memory (dynamic: q[j * m +
// k][thread], then d[...] after the challenges * m rows of q), turns all
// challenges * m quotients num_k / den_k into words with ONE Fermat power
// (gl::batch_div: a zero den_k gives 0, as the plain inverse), and their
// running products rat_pref[k] in place in q.  The block scans the row
// ratios rat_pref[m - 1] (block_scan), warp j mod warps looks back for
// challenge j's prefix of the tiles before (look_back), and each thread
// writes Z = prefix times its exclusive in-block product and p_k = Z
// rat_pref[k] from shared memory: every output word is written once.
constexpr int PERM_Z_GROUP = 4;

__global__ void __launch_bounds__(PERM_Z_MAX_THREADS)
perm_z_one_pass_kernel(PermZArgs a) {
  constexpr int NC = PERM_CHALLENGES;
  extern __shared__ uint64_t quot[];  // q: challenges * m rows of blockDim.x, then d: as many
  __shared__ uint64_t beta_k[NC][PERM_MAX_ROUTED];
  __shared__ uint64_t beta[NC], gamma[NC];
  __shared__ uint64_t warp_sums[NC][32];
  __shared__ uint64_t prefix[NC];
  __shared__ long long drawn;
  const int nc = a.challenges, m = a.routed / a.chunk, T = blockDim.x, t = threadIdx.x;
  if (t == 0) {
    drawn = (long long)(atomicAdd(a.ticket, 1ull) - a.ticket_base);
    if (drawn < 0 || drawn >= gridDim.x) __trap();  // another launch drew from this state
  }
  for (int i = t; i < nc * a.routed; i += T)
    beta_k[i / a.routed][i % a.routed] = gl::mul(a.betas[i / a.routed], a.k_shifts[i % a.routed]);
  if (t < nc) {
    beta[t] = a.betas[t];
    gamma[t] = a.gammas[t];
  }
  __syncthreads();
  const long long tile = drawn;
  const long long x = tile * T + t;
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
    // rat_pref[k] = prod_{l <= k} ratio_l in place for k < m - 1; the last is the row ratio
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j < nc) {
        uint64_t pref = qs[j * m];
        for (int kk = 1; kk < m; ++kk) {
          pref = gl::mul(pref, qs[j * m + kk]);
          if (kk + 1 < m) qs[j * m + kk] = pref;
        }
        row_ratio[j] = pref;
      }
    }
  }
  uint64_t total[NC];
  block_scan(row_ratio, total, warp_sums);
  // warp w looks back for challenges w, w + warps, ... (a tile of 32 has one warp)
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < nc && (t >> 5) == j % (T >> 5)) {
      const uint64_t p = look_back(a, j, tile, total[j]);
      if ((t & 31) == 0) prefix[j] = p;
    }
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j < nc) {
        uint64_t* o = a.out + (long long)j * m * a.n + x;
        const uint64_t z = gl::mul(prefix[j], row_ratio[j]);
        o[0] = z;
        for (int kk = 0; kk + 1 < m; ++kk)
          o[(long long)(kk + 1) * a.n] = gl::mul(z, q[(long long)(j * m + kk) * T]);
      }
    }
  }
}

}  // namespace

// One launch of perm_z_one_pass_kernel: Z and the partials for `challenges`
// challenges into `out` ((challenges * m, n), contiguous; it overlaps no
// input), in `grid` tiles of `tile` columns (a block each) with `shared`
// bytes of dynamic shared memory.  `state` is the look-back state of
// 1 + 3 * PERM_CHALLENGES * cap words (the ticket counter, then the statuses,
// the tiles' own products and their inclusive products, (PERM_CHALLENGES,
// cap) each), `ticket_base` the counter's value before this launch and
// `epoch` a number no earlier launch on the state used (perm_z_one_pass.py
// `state`): nothing is reset between launches.  perm_z_one_pass.py `plan`
// computes the sizes.
extern "C" int elp_perm_z_one_pass(const void* wires, long long wires_stride, const void* sigma,
                                   long long sigma_stride, const void* omega, const void* k_shifts,
                                   const void* betas, const void* gammas, long long n, int routed,
                                   int chunk, int challenges, void* out, void* state, long long cap,
                                   unsigned long long ticket_base, unsigned long long epoch,
                                   int tile, long long grid, long long shared, void* stream) {
  const int m = chunk > 0 ? routed / chunk : 0;
  if (n < 1 || chunk < 1 || routed < chunk || routed % chunk || routed > PERM_MAX_ROUTED ||
      m > PERM_MAX_CHUNKS || challenges < 1 || challenges > PERM_CHALLENGES || tile < 32 ||
      tile > PERM_Z_MAX_THREADS || tile % 32 || grid != (n + tile - 1) / tile ||
      grid > 0x7FFFFFFFll || shared != 2ll * challenges * m * tile * 8 || shared > 227 * 1024 ||
      cap < grid || epoch < 1 || epoch >= (1ull << 62))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(perm_z_one_pass_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  const auto w = [](const void* p) { return static_cast<const uint64_t*>(p); };
  uint64_t* st = static_cast<uint64_t*>(state);
  const long long rows = (long long)PERM_CHALLENGES * cap;
  const PermZArgs a{w(wires), wires_stride, w(sigma), sigma_stride, w(omega), w(k_shifts),
                    w(betas), w(gammas), static_cast<uint64_t*>(out),
                    reinterpret_cast<unsigned long long*>(st), st + 1, st + 1 + rows,
                    st + 1 + 2 * rows, n, cap, ticket_base, epoch, routed, chunk, challenges};
  perm_z_one_pass_kernel<<<(unsigned)grid, tile, (size_t)shared,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

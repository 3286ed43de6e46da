// Poseidon sponge (width 12, rate 8, capacity 4, no padding) over Goldilocks.
//
// Replaces the TPU kernel eth_lc_plonky2_tpu/ops/pallas/poseidon_pallas.py:
// sponge_columns (body _sponge_kernel, _permute_unrolled, _mds_cf, _sbox),
// which hashes every column of a channel-first (L, N) matrix with the whole
// sponge held in VMEM.  Here one thread runs one sponge with its 12-word
// state in registers.
//
// What bounds it: integer instruction throughput, not memory.  A 184-input
// leaf runs 23 permutations for 1.5 KB read.  A permutation is 4 + 22 + 4
// rounds with 118 x^7 S-boxes (4 field multiplies each); the linear layers
// and the reductions around the multiplies are the larger part of its
// instructions (PERF.md), and the design goes after those:
//   * the 22 partial rounds run in the sparse form of the Poseidon paper's
//     appendix B (as plonky2's prover does): constants folded to one vector
//     before the first partial round and one scalar per round, one dense
//     11 x 11 matrix up front, then per round a 12-term dot product for
//     s[0] and s[i] += v[i] * s[0].  That is 23 products of 64 x 64 bits a
//     round instead of a dense 12 x 12 layer, and the same permutation;
//   * state words are LAZY (goldilocks.cuh: any uint64_t congruent mod p)
//     from one step to the next; only the four digest words are made
//     canonical, where they leave the kernel.  A dot product is summed as
//     three 96-bit column sums of 32 x 32 partial products and reduced once,
//     and every reduction is a PTX carry chain (goldilocks.cuh);
//   * the 8 full rounds keep the dense circulant (entries <= 41), as two
//     length-6 correlations on 16-bit limbs: half the products, all of them
//     32-bit multiply-adds, which run at twice the rate of the wide ones;
//   * all constants (6,112 bytes, built by ops/poseidon.py: the source holds
//     none) live in __constant__ memory, filled once by
//     elp_poseidon_set_constants.  Every thread reads the same word at the
//     same time, which the constant cache serves as a broadcast;
//   * the code is kept small and the warps of a block together, for the
//     instruction cache: the rounds are rolled loops (one copy of a full
//     round, one of a partial round) and a barrier ends every permutation.
//
// Three entry points share the permutation:
//   * sponge_kernel: element (l, j) is in[l*stride_l + j*stride_n], so the
//     leaves of a channel-first LDE (C, 8n) are read through the transposed
//     view (stride_l = 8n, stride_n = 1; a warp reads 32 adjacent words) and
//     no copy is made.  A sponge with L inputs overwrites state[0:c] with
//     each chunk of c <= 8 inputs and permutes; the digest is state[0:4].
//   * merkle_level_kernel: one Merkle level, the contiguous (M, 8) view of a
//     (2M, 4) digest level ([left || right] of pair i is row i), read as four
//     16-byte loads a thread.  Its own name, so a profile tells levels from
//     leaves.
//   * merkle_tail_kernel: the small levels at the top of a tree in ONE
//     launch: one block compresses level after level with a barrier between,
//     each level stored (behind one another in `out`) for the Merkle paths.
// Threads past N store nothing, so N needs no rounding.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;

// ops/poseidon.py kernel_constants() builds this image.
struct PoseidonConsts {
  uint64_t rc_full[2 * HALF_FULL][WIDTH];  // the first four and the last four rounds
  uint64_t first[WIDTH];                   // added before the first partial round
  uint64_t init[WIDTH - 1][WIDTH - 1];     // s[1:] = init @ s[1:]
  uint64_t scalar[PARTIAL];                // added to s[0] after its S-box
  uint64_t row[PARTIAL][WIDTH];            // s[0]' = row . s  (row[0] = M[0][0])
  uint64_t col[PARTIAL][WIDTH - 1];        // s[i]' = s[i] + col[i-1] * s[0]
  int32_t mds_sum[WIDTH / 2];   // circ[i] + circ[i + 6] of the circulant's first row
  int32_t mds_diff[WIDTH / 2];  // circ[i] - circ[i + 6]
  uint32_t mds_diag0;
  uint32_t pad;
};

__constant__ PoseidonConsts C;

// lazy -> lazy
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul_lazy(x, x);
  const uint64_t x3 = gl::mul_lazy(x2, x);
  const uint64_t x6 = gl::mul_lazy(x3, x3);
  return gl::mul_lazy(x6, x);
}

// The linear layer: out[r] = sum_i circ[i] * s[(r+i) % 12], plus diag0 * s[0]
// in row 0 (the other diagonal entries are zero: ops/poseidon.py checks it),
// with half the products of the direct form and none of them wide.  With
// A = s[0:6] + s[6:12] and B = s[0:6] - s[6:12], out[r] + out[r+6] is the
// cyclic correlation of A with circ[0:6] + circ[6:12] and out[r] - out[r+6]
// the negacyclic correlation of B with circ[0:6] - circ[6:12] (length 6 each:
// 72 products where the direct form has 144).  On 16-bit limbs (four a word)
// every product and sum fits 32 bits with sign, so the products are 32-bit
// multiply-adds, which the card runs at twice the rate of 32 x 32 -> 64.
// lazy -> lazy.
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  constexpr int H = WIDTH / 2;
  int32_t A[H][4], B[H][4];
  int32_t d0[4];
#pragma unroll
  for (int j = 0; j < H; ++j) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int32_t a = (int32_t)((s[j] >> (16 * l)) & 0xFFFF);
      const int32_t b = (int32_t)((s[j + H] >> (16 * l)) & 0xFFFF);
      A[j][l] = a + b;
      B[j][l] = a - b;
      if (j == 0) d0[l] = a * (int32_t)C.mds_diag0;
    }
  }
#pragma unroll
  for (int r = 0; r < H; ++r) {
    uint32_t y[2][4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int32_t p = 0, q = 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        p += C.mds_sum[i] * A[(r + i) % H][l];
        if (r + i < H) q += C.mds_diff[i] * B[(r + i) % H][l];
        else q -= C.mds_diff[i] * B[(r + i) % H][l];
      }
      y[0][l] = (uint32_t)((p + q) >> 1) + (r == 0 ? (uint32_t)d0[l] : 0u);  // < 2^27
      y[1][l] = (uint32_t)((p - q) >> 1);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint64_t v01 = (uint64_t)y[k][0] + ((uint64_t)y[k][1] << 16);  // < 2^44
      const uint64_t v23 = (uint64_t)y[k][2] + ((uint64_t)y[k][3] << 16);  // at weight 2^32
      s[r + k * H] = gl::reduce_halves_lazy(v01, v23);
    }
  }
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(gl::add_lazy(s[i], C.rc_full[r][i]));
  mds(s);
}

__device__ __forceinline__ void partial_rounds(uint64_t s[WIDTH]) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::add_lazy(s[i], C.first[i]);
  uint64_t t[WIDTH - 1];
#pragma unroll
  for (int i = 0; i < WIDTH - 1; ++i) {
    gl::Acc acc;
#pragma unroll
    for (int j = 0; j < WIDTH - 1; ++j) acc.mac(C.init[i][j], s[j + 1]);
    t[i] = acc.reduce_lazy();
  }
#pragma unroll
  for (int i = 0; i < WIDTH - 1; ++i) s[i + 1] = t[i];
#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) {
    const uint64_t s0 = gl::add_lazy(sbox(s[0]), C.scalar[r]);
    gl::Acc acc;
    acc.mac(C.row[r][0], s0);
#pragma unroll
    for (int i = 1; i < WIDTH; ++i) acc.mac(C.row[r][i], s[i]);
#pragma unroll
    for (int i = 1; i < WIDTH; ++i) s[i] = gl::mul_add_lazy(C.col[r][i - 1], s0, s[i]);
    s[0] = acc.reduce_lazy();
  }
}

// lazy -> lazy.  One rolled loop, so the code holds one copy of a full round:
// the kernel is some 60 KB of instructions, and how well the instruction
// cache serves them counts beside the arithmetic.  `sync` (every thread
// of the block must then call this the same number of times) ends the
// permutation with a barrier, which keeps the block's warps on the same
// stretch of code: measured 12% faster at two 256-thread blocks an SM.
__device__ __forceinline__ void permute(uint64_t s[WIDTH], bool sync) {
#pragma unroll 1
  for (int r = 0; r < 2 * HALF_FULL; ++r) {
    full_round(s, r);
    if (r == HALF_FULL - 1) partial_rounds(s);
  }
  if (sync) __syncthreads();
}

// [left || right || 0^4] permuted; the digest, canonical, goes to out[0:4].
__device__ __forceinline__ void compress_pair(const uint64_t* pair, uint64_t* out, bool sync) {
  uint64_t s[WIDTH];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const ulonglong2 w = reinterpret_cast<const ulonglong2*>(pair)[q];
    s[2 * q] = w.x;
    s[2 * q + 1] = w.y;
  }
#pragma unroll
  for (int i = RATE; i < WIDTH; ++i) s[i] = 0;
  permute(s, sync);
  ulonglong2* o = reinterpret_cast<ulonglong2*>(out);
  o[0] = make_ulonglong2(gl::canon(s[0]), gl::canon(s[1]));
  o[1] = make_ulonglong2(gl::canon(s[2]), gl::canon(s[3]));
}

// Two 256-thread blocks an SM (at most 128 registers a thread, no spills):
// fewer registers spill, more leave the scheduler too few warps.  Threads past N
// hash sponge N - 1 again and store nothing, so that the whole block meets
// at the barriers.
__global__ void __launch_bounds__(256, 2)
sponge_kernel(const uint64_t* __restrict__ in, long long L, long long N, long long stride_l,
              long long stride_n, uint64_t* __restrict__ out) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < N;
  if (!live) j = N - 1;
  const uint64_t* col = in + j * stride_n;
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  for (long long start = 0; start < L; start += RATE) {
#pragma unroll
    for (int r = 0; r < RATE; ++r) {
      if (start + r < L) s[r] = col[(start + r) * stride_l];
    }
    permute(s, true);
  }
  if (!live) return;
  ulonglong2* o = reinterpret_cast<ulonglong2*>(out + j * 4);
  o[0] = make_ulonglong2(gl::canon(s[0]), gl::canon(s[1]));
  o[1] = make_ulonglong2(gl::canon(s[2]), gl::canon(s[3]));
}

// in: (M, 8) contiguous, out: (M, 4) contiguous, both 16-byte aligned.
__global__ void __launch_bounds__(256, 2)
merkle_level_kernel(const uint64_t* __restrict__ in, long long M, uint64_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  __align__(16) uint64_t digest[4];
  compress_pair(in + (i < M ? i : M - 1) * 8, digest, true);
  if (i < M) {
    ulonglong2* o = reinterpret_cast<ulonglong2*>(out + i * 4);
    o[0] = make_ulonglong2(digest[0], digest[1]);
    o[1] = make_ulonglong2(digest[2], digest[3]);
  }
}

// One block.  Level 0 compresses the M pairs of `in` into out[0 : 4M], level
// k the M >> k pairs of level k-1 into the words behind it.  The barrier
// makes a level's stores visible to the block before the next level loads
// them (no __restrict__ here: `src` walks into `out`).
__global__ void __launch_bounds__(256, 1)
merkle_tail_kernel(const uint64_t* in, long long M, int levels, uint64_t* out) {
  const uint64_t* src = in;
  uint64_t* dst = out;
  long long m = M;
  for (int k = 0; k < levels; ++k) {
    for (long long i = threadIdx.x; i < m; i += blockDim.x) compress_pair(src + i * 8, dst + i * 4, false);
    __syncthreads();
    src = dst;
    dst += m * 4;
    m >>= 1;
  }
}

}  // namespace

// image: host pointer to a PoseidonConsts image.  Copies it into the card's
// constant memory, in stream order before any later launch on `stream`.
extern "C" int elp_poseidon_set_constants(const void* image, long long bytes, void* stream) {
  if (bytes != (long long)sizeof(PoseidonConsts)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemcpyToSymbolAsync(C, image, sizeof(PoseidonConsts), 0,
                                                  cudaMemcpyHostToDevice,
                                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  // the image is pageable host memory the caller may free: wait for the copy
  return (int)cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
}

extern "C" int elp_poseidon_sponge(const void* in, long long L, long long N, long long stride_l,
                                   long long stride_n, void* out, int threads, void* stream) {
  const long long blocks = (N + threads - 1) / threads;
  sponge_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), L, N, stride_l, stride_n, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int elp_merkle_level(const void* in, long long M, void* out, int threads,
                                void* stream) {
  const long long blocks = (M + threads - 1) / threads;
  merkle_level_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), M, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int elp_merkle_tail(const void* in, long long M, int levels, void* out, int threads,
                               void* stream) {
  merkle_tail_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), M, levels, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

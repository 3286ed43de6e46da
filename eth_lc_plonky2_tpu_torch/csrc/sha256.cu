// SHA-256 of a batch: the compression function, and the two-to-one hash of a
// 64-byte pair, one thread a message.
//
// Replaces eth_lc_plonky2_tpu/ops/sha256.py:174 `compress` and :211
// `two_to_one`, jitted jnp with no Pallas kernel behind them: there the
// message schedule and the 64 rounds are `scan`s whose every step is an
// operation on whole-batch arrays, and a two-to-one is two such compressions
// with the padding block broadcast to the batch.  Here one thread takes one
// message from its loads to its store, with everything in between in
// registers.
//
// What bounds it: integer instructions, not memory.  A compression reads 96
// bytes and writes 32 (a two-to-one reads 64 and writes 32), but it runs 64
// rounds and 48 schedule words.  A round is Σ1 and Σ0 at 3 funnel shifts and
// one LOP3 each, Ch and Maj at one LOP3 each, and 4 adds; a schedule word is
// σ0 and σ1 at 3 shifts and one LOP3 each, and 2 adds.  That comes to some
// 1,400 instructions a compression and 2,300 a two-to-one (the SASS: 1,456
// and 2,400).  The shifts and the logic, about 1,000 and 1,660 of them, run on
// the integer pipe alone, 64 lanes a clock an SM; the compiler puts a third of
// the adds on the FMA pipe (IMAD) beside them.  That pipe is the floor, 1.6
// and 3.5 times the time of the bytes, and the design keeps the count at it:
//   * every word lives in a register: the 8 chaining words, a rolling window
//     of 16 schedule words (w[t] overwrites w[t - 16] in place) and the 8
//     working variables, which are renamed, not moved, from round to round:
//     the rounds run in bodies of 16 unrolled rounds, a multiple of 8, so a
//     body ends with every variable in the register it started in;
//   * rotations are funnel shifts (__funnelshift_r, one SHF each); each XOR
//     of three terms, Ch (g ^ (e & (f ^ g))) and Maj ((a & b) | (c & (a |
//     b))) is a function of three inputs, which the compiler makes one LOP3;
//   * the constants (544 bytes, built by ops/sha256.py kernel_constants(): the
//     source holds none) live in __constant__ memory, filled once a process
//     and card by elp_sha256_set_constants: the round constants K, the IV,
//     and K[t] + W[t] of the constant second block of a 64-byte message (0x80,
//     zeros, the bit length 512), so that the two-to-one's second compression
//     has no schedule at all.  Every thread reads the same word at the same
//     time, which the constant cache serves as a broadcast, and in unrolled
//     rounds a word is an operand of the add itself;
//   * a two-to-one runs both compressions in one launch, the state between
//     them in registers;
//   * a thread loads its 64-byte block as four 16-byte loads and its state
//     (a two-to-one: its left and right halves) as two each, and stores its
//     digest as two.
// BODIES_UNROLLED chooses between bodies of 16 rounds in rolled loops and all
// 64 rounds unrolled: the instruction cache against a rolled loop's branches
// and its indexed constant loads (PERF.md has the two timed).
// Threads past N return at once: no barrier, so N needs no rounding.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ops/sha256.py kernel_constants() builds this image.
struct Sha256Consts {
  uint32_t k[64];       // the round constants
  uint32_t pad_kw[64];  // k[t] + W[t], W the schedule of the padding block of a 64-byte message
  uint32_t iv[8];
};

__constant__ Sha256Consts C;

// The 16-round bodies that the loops over rounds 16..63 (and over the
// padding block's 64) unroll: 1 keeps each loop rolled around one body, 4
// unrolls every round.  4 ran 1.5% (compress) and 3% (two-to-one) faster on
// the H100 (tools/variants/sha256_rounds.py): 2,400 instructions fit the
// instruction cache, and the rolled loops load their constants by index.
constexpr int BODIES_UNROLLED = 4;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}

__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}

__device__ __forceinline__ uint32_t small_sigma0(uint32_t w) {
  return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3);
}

__device__ __forceinline__ uint32_t small_sigma1(uint32_t w) {
  return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10);
}

// (e & f) ^ (~e & g)
__device__ __forceinline__ uint32_t choose(uint32_t e, uint32_t f, uint32_t g) {
  return g ^ (e & (f ^ g));
}

// (a & b) ^ (a & c) ^ (b & c)
__device__ __forceinline__ uint32_t majority(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a | b));
}

// Round r (mod 8) on the working variables v: a is v[-r & 7], b v[(1 - r) &
// 7], ..., h v[(7 - r) & 7].  Only two words change: d takes the new e and h
// the new a, which is where round r + 1 looks for them.  r must be known at
// compile time, so that every index is a register.
__device__ __forceinline__ void sha_round(uint32_t v[8], int r, uint32_t kw) {
  const uint32_t a = v[(0 - r) & 7], b = v[(1 - r) & 7], c = v[(2 - r) & 7];
  const uint32_t e = v[(4 - r) & 7], f = v[(5 - r) & 7], g = v[(6 - r) & 7];
  uint32_t& d = v[(3 - r) & 7];
  uint32_t& h = v[(7 - r) & 7];
  const uint32_t t1 = h + big_sigma1(e) + choose(e, f, g) + kw;
  d += t1;
  h = t1 + big_sigma0(a) + majority(a, b, c);
}

// s: the chaining state, in and out; w: the block's 16 words, which become
// the rolling schedule window.
__device__ __forceinline__ void compress(uint32_t s[8], uint32_t w[16]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) sha_round(v, i, C.k[i] + w[i]);
#pragma unroll BODIES_UNROLLED
  for (int t = 16; t < 64; t += 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      w[i] += small_sigma1(w[(i + 14) & 15]) + w[(i + 9) & 15] + small_sigma0(w[(i + 1) & 15]);
      sha_round(v, i, C.k[t + i] + w[i]);
    }
  }
  // 64 rounds, a multiple of 8: a is v[0] again, b v[1], ...
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += v[i];
}

// The compression of the padding block of a 64-byte message: its schedule
// is a constant, so each round takes k[t] + W[t] from the table.
__device__ __forceinline__ void compress_padding(uint32_t s[8]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll BODIES_UNROLLED
  for (int t = 0; t < 64; t += 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sha_round(v, i, C.pad_kw[t + i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += v[i];
}

// 8 words at a 16-byte aligned address, as two 16-byte loads.
__device__ __forceinline__ void load8(const uint32_t* __restrict__ src, uint32_t* dst) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 x = q[j];
    dst[4 * j] = x.x;
    dst[4 * j + 1] = x.y;
    dst[4 * j + 2] = x.z;
    dst[4 * j + 3] = x.w;
  }
}

__device__ __forceinline__ void store8(const uint32_t* src, uint32_t* __restrict__ dst) {
  uint4* q = reinterpret_cast<uint4*>(dst);
  q[0] = make_uint4(src[0], src[1], src[2], src[3]);
  q[1] = make_uint4(src[4], src[5], src[6], src[7]);
}

// state: (N, 8), block: (N, 16), out: (N, 8), all contiguous and 16-byte aligned.
__global__ void __launch_bounds__(256)
sha256_compress_kernel(const uint32_t* __restrict__ state, const uint32_t* __restrict__ block,
                       long long N, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t s[8], w[16];
  load8(state + i * 8, s);
  load8(block + i * 16, w);
  load8(block + i * 16 + 8, w + 8);
  compress(s, w);
  store8(s, out + i * 8);
}

// left, right, out: (N, 8), contiguous and 16-byte aligned.  out[i] is the
// SHA-256 of the 64 bytes left[i] || right[i].
__global__ void __launch_bounds__(256)
sha256_two_to_one_kernel(const uint32_t* __restrict__ left, const uint32_t* __restrict__ right,
                         long long N, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t s[8], w[16];
  load8(left + i * 8, w);
  load8(right + i * 8, w + 8);
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = C.iv[j];
  compress(s, w);
  compress_padding(s);
  store8(s, out + i * 8);
}

}  // namespace

// image: host pointer to a Sha256Consts image.
extern "C" int elp_sha256_set_constants(const void* image, long long bytes, void* stream) {
  if (bytes != (long long)sizeof(Sha256Consts)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemcpyToSymbolAsync(C, image, sizeof(Sha256Consts), 0,
                                                  cudaMemcpyHostToDevice,
                                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  // the image is pageable host memory the caller may free: wait for the copy
  return (int)cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
}

extern "C" int elp_sha256_compress(const void* state, const void* block, long long N, void* out,
                                   int threads, void* stream) {
  const long long blocks = (N + threads - 1) / threads;
  sha256_compress_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint32_t*>(block), N,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int elp_sha256_two_to_one(const void* left, const void* right, long long N, void* out,
                                     int threads, void* stream) {
  const long long blocks = (N + threads - 1) / threads;
  sha256_two_to_one_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(left), static_cast<const uint32_t*>(right), N,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

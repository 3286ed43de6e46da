// Batched Goldilocks NTT pass: radix-8 butterflies in registers, exchanged
// through shared memory.
//
// Replaces the TPU kernel eth_lc_plonky2_tpu/ops/pallas/ntt_mxu.py:ntt_base
// (a length <= 256 NTT as a bf16 byte-plane matmul on the MXU) together
// with its composition eth_lc_plonky2_tpu/ops/ntt.py:_ntt_nat_tpu (a Bailey
// four-step over that base).  The card has 64-bit integer multiplies, so this
// computes the NTT itself, not the TPU's matmul formulation.
//
// One launch runs many independent sub-transforms of length m = 2^log_m
// (m <= 2^11).  Sub-transform s = b*K + k (b a batch row, k < K = 2^log_k: a
// shift and a mask, not a 64-bit division, find b and k) reads its
// element i at in[b*in_b + k*in_k + i*in_i] and writes its output j at
// out[b*out_b + k*out_k + j*out_j], so the same kernel serves
//   * a whole row (n <= 2^11): K = 1, contiguous, one pass;
//   * the column pass of a four-step (n = n1*n2 up to 2^22): strided reads,
//     output j of sub-transform k multiplied by the step twiddle w_n^(k*j);
//   * the row pass of the four-step, which writes natural order directly.
// The ops/ntt.py wrapper chooses the passes; callers see natural order in
// and out and never a bit reversal (it happens in shared memory on load).
//
// Optional modifiers fold the coset LDE and the inverse scaling into the
// passes: in_tab[pos] multiplies input position pos on load (shift^i),
// out_tab[pos] and a scalar (n^-1) multiply each output on store.
//
// What bounds it: by the roofline, memory traffic (a 16-polynomial LDE from
// 2^18 to 2^21 reads 34 MB and writes 268 MB, 0.09 ms at 3.35 TB/s; two
// passes move 839 MB, 0.25 ms), narrowly ahead of the multiply-adds of its
// 352 M butterflies.  As measured on an H100 (PERF.md) the kernel is bound by
// integer instruction throughput: a butterfly is a 64 x 64 product, its reduction
// and a modular add and subtract, about 40 instructions.  What the design
// does about both:
//   * zero padding is never stored or loaded.  log_pad says that only the
//     first m >> log_pad elements of every sub-transform are non-zero (the
//     LDE's padding seen from a column of the four-step).  In a decimation
//     in time the first log_pad stages then only copy: element i lands on
//     the 2^log_pad slots from bitrev(i) on, and the butterflies start at
//     stage log_pad;
//   * up to three stages run on 8 words in a thread's registers between two
//     barriers, so 2^11 takes 4 barriers and 4 trips through shared memory
//     where a radix-2 loop takes 11;
//   * the m/2 stage twiddles w_m^k sit in shared memory beside the tile; the
//     step twiddle w_n^(k*j) is the product of two entries of tables of at
//     most 2^11 words (k*j = a*2^11 + b), which stay in cache, and not a
//     gather over n words;
//   * the pass count stays at two for every n <= 2^22, global accesses run
//     along the contiguous axis (C >= 4 adjacent sub-transforms per block
//     when that axis is k, whole 32-byte sectors), and shared-memory
//     indices are swizzled for the bit-reversed scatter.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int STEP_BITS = 11;  // step twiddle: w_n^e = step_hi[e >> 11] * step_lo[e & 2047]

struct NttParams {
  const uint64_t* in;
  uint64_t* out;
  long long total;  // number of sub-transforms
  int log_k;        // K = 2^log_k sub-transforms per batch row
  long long in_b, in_k, in_i;
  long long out_b, out_k, out_j;
  const uint64_t* tw;       // w_m^k for k < m/2 (w inverted for the inverse NTT)
  const uint64_t* step_lo;  // w_n^b for b < 2^11, or null: no step twiddle
  const uint64_t* step_hi;  // w_n^(a * 2^11)
  const uint64_t* in_tab;
  const uint64_t* out_tab;
  uint64_t scalar;
  int log_m;
  int log_c;    // C = 2^log_c sub-transforms per block
  int log_pad;  // elements i >= m >> log_pad of every sub-transform are zero
  int has_scalar;
};

// XOR swizzle inside one sub-transform's m words: the low 4 bits of the
// index are mixed with its top 4 bits (a bijection on [0, m) for m >= 2^8).
__device__ __forceinline__ int swz(int r, int log_m) {
  return log_m >= 8 ? r ^ ((r >> (log_m - 4)) & 15) : r;
}

// Stages lh .. lh+R-1 of every sub-transform of the tile, 2^R words a thread.
// Stage s pairs (i0, i0 + 2^s) with the twiddle w_(2^(s+1))^(i0 mod 2^s)
// = tw[(i0 mod 2^s) << (log_m - s - 1)].  A thread owns the words
// base + t*h, t < 2^R, h = 2^lh, which are closed under these R stages.
// FIRST says lh = 0: the twiddle positions are then known when compiling, and
// the butterflies whose twiddle is 1 (7 of 12 in a group of three stages)
// multiply nothing.
template <int R, bool FIRST>
__device__ __forceinline__ void stage_group(uint64_t* sm, const uint64_t* tw, int lh, int log_m,
                                            int tile) {
  const int h = 1 << lh;
  const int m = 1 << log_m;
  for (int item = threadIdx.x; item < (tile >> R); item += blockDim.x) {
    const int z = item & ((m >> R) - 1);
    uint64_t* base = sm + ((item >> (log_m - R)) << log_m);
    const int q = z & (h - 1);
    const int first = ((z >> lh) << (lh + R)) + q;
    uint64_t x[1 << R];
#pragma unroll
    for (int t = 0; t < (1 << R); ++t) x[t] = base[swz(first + t * h, log_m)];
#pragma unroll
    for (int s = 0; s < R; ++s) {
#pragma unroll
      for (int t = 0; t < (1 << R); ++t) {
        if (t & (1 << s)) continue;
        const int pos = q + (t & ((1 << s) - 1)) * h;
        const uint64_t u = x[t];
        uint64_t v = x[t | (1 << s)];
        if (!(FIRST && (t & ((1 << s) - 1)) == 0)) v = gl::mul(v, tw[pos << (log_m - lh - s - 1)]);
        x[t] = gl::add(u, v);
        x[t | (1 << s)] = gl::sub(u, v);
      }
    }
#pragma unroll
    for (int t = 0; t < (1 << R); ++t) base[swz(first + t * h, log_m)] = x[t];
  }
}

__global__ void ntt_pass_kernel(const NttParams p) {
  extern __shared__ uint64_t sm[];
  const int log_m = p.log_m;
  const int m = 1 << log_m;
  const int tile = m << p.log_c;
  uint64_t* tw = sm + tile;
  const long long s0 = (long long)blockIdx.x << p.log_c;

  for (int e = threadIdx.x; e < (m >> 1); e += blockDim.x) tw[e] = p.tw[e];

  // Load the non-zero head of every sub-transform, bit-reversed, with the
  // input scale; each word fills the 2^log_pad slots the skipped stages
  // would have copied it to.  The fast thread index runs along whichever
  // axis is contiguous in memory.
  const int log_head = log_m - p.log_pad;
  const int copies = 1 << p.log_pad;
  for (int e = threadIdx.x; e < (tile >> p.log_pad); e += blockDim.x) {
    int c, i;
    if (p.in_k == 1) {
      c = e & ((1 << p.log_c) - 1);
      i = e >> p.log_c;
    } else {
      i = e & ((1 << log_head) - 1);
      c = e >> log_head;
    }
    const long long s = s0 + c;
    uint64_t x = 0;
    if (s < p.total) {
      const long long b = s >> p.log_k;
      const long long k = s - (b << p.log_k);
      const long long pos = k * p.in_k + (long long)i * p.in_i;
      x = p.in[b * p.in_b + pos];
      if (p.in_tab != nullptr) x = gl::mul(x, p.in_tab[pos]);
    }
    const int r = log_m == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - log_m));
    uint64_t* base = sm + (c << log_m);
    for (int t = 0; t < copies; ++t) base[swz(r + t, log_m)] = x;
  }
  __syncthreads();

  // Decimation in time from stage log_pad on, three stages between barriers.
  int lh = p.log_pad;
  while (lh < log_m) {
    const int left = log_m - lh;
    if (left >= 3) {
      if (lh == 0) stage_group<3, true>(sm, tw, lh, log_m, tile);
      else stage_group<3, false>(sm, tw, lh, log_m, tile);
      lh += 3;
    } else if (left == 2) {
      if (lh == 0) stage_group<2, true>(sm, tw, lh, log_m, tile);
      else stage_group<2, false>(sm, tw, lh, log_m, tile);
      lh += 2;
    } else {
      if (lh == 0) stage_group<1, true>(sm, tw, lh, log_m, tile);
      else stage_group<1, false>(sm, tw, lh, log_m, tile);
      lh += 1;
    }
    __syncthreads();
  }

  // Store in natural order, with the step twiddle and the output scales.
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int c, j;
    if (p.out_k == 1) {
      c = e & ((1 << p.log_c) - 1);
      j = e >> p.log_c;
    } else {
      j = e & (m - 1);
      c = e >> log_m;
    }
    const long long s = s0 + c;
    if (s >= p.total) continue;
    const long long b = s >> p.log_k;
    const long long k = s - (b << p.log_k);
    uint64_t x = sm[(c << log_m) + swz(j, log_m)];
    if (p.step_lo != nullptr) {
      const long long e2 = k * j;  // < n <= 2^22 in a four-step
      x = gl::mul(x, gl::mul_lazy(p.step_lo[e2 & ((1 << STEP_BITS) - 1)], p.step_hi[e2 >> STEP_BITS]));
    }
    const long long pos = k * p.out_k + (long long)j * p.out_j;
    if (p.out_tab != nullptr) x = gl::mul(x, p.out_tab[pos]);
    if (p.has_scalar) x = gl::mul(x, p.scalar);
    p.out[b * p.out_b + pos] = x;
  }
}

}  // namespace

extern "C" int elp_ntt_pass(const void* in, void* out, long long total, int log_k,
                            long long in_b, long long in_k, long long in_i,
                            long long out_b, long long out_k, long long out_j,
                            const void* tw, const void* step_lo, const void* step_hi,
                            const void* in_tab, const void* out_tab,
                            unsigned long long scalar, int has_scalar,
                            int log_m, int log_c, int log_pad, int threads, void* stream) {
  NttParams p;
  p.in = static_cast<const uint64_t*>(in);
  p.out = static_cast<uint64_t*>(out);
  p.total = total;
  p.log_k = log_k;
  p.in_b = in_b;
  p.in_k = in_k;
  p.in_i = in_i;
  p.out_b = out_b;
  p.out_k = out_k;
  p.out_j = out_j;
  p.tw = static_cast<const uint64_t*>(tw);
  p.step_lo = static_cast<const uint64_t*>(step_lo);
  p.step_hi = static_cast<const uint64_t*>(step_hi);
  p.in_tab = static_cast<const uint64_t*>(in_tab);
  p.out_tab = static_cast<const uint64_t*>(out_tab);
  p.scalar = scalar;
  p.has_scalar = has_scalar;
  p.log_m = log_m;
  p.log_c = log_c;
  p.log_pad = log_pad;
  const size_t smem = (sizeof(uint64_t) << (log_m + log_c)) + (sizeof(uint64_t) << log_m) / 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (total + (1ll << log_c) - 1) >> log_c;
  ntt_pass_kernel<<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Elementwise Goldilocks field operations: add, sub, mul of two operands
// with broadcasting, and the multiplicative inverse.
//
// Replaces eth_lc_plonky2_tpu/ops/goldilocks.py:143-301 (`add`, `sub`,
// `mul`, `square`, `inv`).  The JAX package has no Pallas kernel for them:
// XLA fuses the u32-limb arithmetic into its neighbours on the TPU.  Eager
// PyTorch does not fuse, and a product written as tensor ops is some 35
// launches and as many passes over the array, so on the card each operation
// is one launch here: one load an operand, one store an element.
//
// Addressing.  The output is a contiguous (rows, cols) array.  Each operand
// is read at base[r * stride_r + c * stride_c] (strides in words), so the
// wrapper passes 0 for a broadcast axis: a scalar is (0, 0), a row (1, n)
// against (r, n) is (0, 1), a column (r, 1) is (1, 0), and a strided slice
// keeps its own strides.  Threads run along cols, so neighbouring threads
// read neighbouring words of every operand that has stride_c = 1.
//
// What bounds it: memory traffic.  A binary op on same-shape operands moves
// 24 bytes an element (0.120 ms for (8, 2^21) at 3.35 TB/s) against one
// 64 x 64 product and its reduction, about 20 integer instructions.  The
// inverse is bound by operations: the Fermat power a^(p-2) is 63 squarings
// and 9 products in registers (the addition chain through a^(2^31 - 1)),
// against 16 bytes an element; as tensor ops it was about 125 products of
// 35 passes each.
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

// x^(2^n), lazy -> lazy.
__device__ __forceinline__ uint64_t square_times(uint64_t x, int n) {
  for (int i = 0; i < n; ++i) x = gl::mul_lazy(x, x);
  return x;
}

// canonical -> canonical a^(p-2), p - 2 = 2^64 - 2^32 - 1; the inverse of 0
// comes out as 0.  The chain: a^3, a^7, a^(2^6 - 1), a^(2^12 - 1),
// a^(2^24 - 1), a^(2^30 - 1), a^(2^31 - 1) = t31; t31^(2^32) * t31 =
// a^((2^31 - 1)(2^32 + 1)); its square times a.
__global__ void __launch_bounds__(256)
field_inv_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const uint64_t a = in[i];
    const uint64_t t2 = gl::mul_lazy(square_times(a, 1), a);
    const uint64_t t3 = gl::mul_lazy(square_times(t2, 1), a);
    const uint64_t t6 = gl::mul_lazy(square_times(t3, 3), t3);
    const uint64_t t12 = gl::mul_lazy(square_times(t6, 6), t6);
    const uint64_t t24 = gl::mul_lazy(square_times(t12, 12), t12);
    const uint64_t t30 = gl::mul_lazy(square_times(t24, 6), t6);
    const uint64_t t31 = gl::mul_lazy(square_times(t30, 1), a);
    const uint64_t t63 = gl::mul_lazy(square_times(t31, 32), t31);
    out[i] = gl::canon(gl::mul_lazy(square_times(t63, 1), a));
  }
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
  // the chain is 72 dependent products a word: many blocks of few words each
  field_inv_kernel<<<blocks_for(n, threads, 1ll << 30), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return (int)cudaGetLastError();
}

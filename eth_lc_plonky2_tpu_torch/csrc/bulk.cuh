// Bulk asynchronous copies into a ring of shared-memory stages, on Hopper's
// mbarriers: the helpers that field.cu's openings, G and permutation terms
// and gates.cu's generic gates share.
//
// A ring of stages: the producer thread waits for a stage's `empty` barrier
// (every consumer warp arrives once it has read the stage), announces the
// stage's bytes on its `full` barrier and issues cp.async.bulk copies that
// complete on it; the consumers wait for `full`.  Round r of a stage is
// phase r of both barriers, so a wait takes the parity r & 1.  Where no
// thread is only a producer, a slot's release is a count instead of an
// `empty` barrier (`last_to_release`): the warp that releases it last
// refills it, and nobody waits.  A stage of several rows of a tile can
// arrive by one copy of a 2-D tensor map (`rows_map`, `bulk_copy_rows`): the
// map is encoded on the host by cuTensorMapEncodeTiled, looked up at run
// time, so nothing links libcuda.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// after the barriers' init, before any thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t"
        ".reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t"
        "}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The calling warp has read a ring slot: true in lane 0 of the warp that
// releases it last of `warps` (the count is then reset for the slot's next
// round, and the slot's readers are ordered before the bulk copies that
// lane issues next: each warp's count is a release, the last one's an
// acquire too), false elsewhere.  Every lane of the warp calls it.
__device__ __forceinline__ bool last_to_release(int* count, int warps) {
  __syncwarp();
  bool last = false;
  if ((threadIdx.x & 31) == 0) {
    int before;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;"
                 : "=r"(before)
                 : "r"(smem_addr(count))
                 : "memory");
    last = before == warps - 1;
    if (last) {
      *count = 0;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
  }
  return last;
}

// One box of `map` (box_rows rows of box_cols words, as the map was made) at
// column c and row r into shared `dst` (128-byte aligned), completing on `bar`
// with the box's bytes.
__device__ __forceinline__ void bulk_copy_rows(void* dst, const CUtensorMap* map, int c, int r,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_addr(bar))
      : "memory");
}

// On the host: `map` over `rows` rows of `cols` 64-bit words, `stride` words
// apart from `base` (16-byte aligned, an even stride), read in boxes of
// box_rows x box_cols words (box_cols words of a row land contiguous, the
// rows one after another).  Returns a cudaError_t.
inline int rows_map(CUtensorMap* map, const void* base, long long rows, long long cols,
                    long long stride, int box_rows, int box_cols) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(rows > 1 ? stride : cols) * 8};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elements[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, const_cast<void*>(base), dims,
                            strides, box, elements, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

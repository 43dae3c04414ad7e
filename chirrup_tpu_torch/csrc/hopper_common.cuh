// Hopper building blocks shared by the hand-written kernels: shared-memory
// addresses, mbarriers, TMA tensor loads and the tensor-map encoder, wgmma
// descriptors and fences (the GEMMs, mm8_a8.cu and mm8_w16.cu), thread-block
// clusters (the GEMMs' split-K) and the error codes beyond the runtime's.
// Everything here needs sm_90a.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of `parity` to complete. A pipeline fault that would
// leave it waiting for good traps after ~2^34 cycles (seconds) instead, so
// the launch fails rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), layout type B128.
// Adding n to it advances the start address by 16 n bytes along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait
template <int R>
__device__ __forceinline__ void fence_acc(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; release then acquire
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library need not link libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// errors of these libraries beyond the runtime's codes
constexpr int ERR_NO_ENCODER = 10001, ERR_ENCODE = 10002, ERR_TILE = 10003, ERR_PLAN = 10004;

inline const char* error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found through the runtime";
    case ERR_ENCODE: return "cuTensorMapEncodeTiled refused the tensor map";
    case ERR_TILE: return "no GEMM kernel for this tile configuration";
    case ERR_PLAN: return "no kernel for this launch plan";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

// A 3-D tensor (d2, d1, d0) of `elem_bytes`-byte elements with d0 contiguous,
// read in (1, box1, box0) boxes of 128-byte rows (box0 * elem_bytes == 128)
// with 128-byte swizzle; out-of-range rows read as zeros.
inline int encode_3d(CUtensorMap* map, CUtensorMapDataType dtype, uint64_t elem_bytes,
                     const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t box0,
                     uint32_t box1) {
  EncodeTiled fn = encoder();
  if (!fn) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem_bytes, d0 * d1 * elem_bytes};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, dtype, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// The tensor map of stacked K-major int8 codes: q points at L layers of
// (M, K) bytes (the logical (L, K, M) with strides (K*M, 1, K)), read in
// (box_n, 128) tiles.
inline int encode_codes_map(CUtensorMap* map, const void* q, int L, int K, int M, int box_n) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, (uint64_t)K, (uint64_t)M,
                   (uint64_t)L, 128u, (uint32_t)box_n);
}

}  // namespace hopper

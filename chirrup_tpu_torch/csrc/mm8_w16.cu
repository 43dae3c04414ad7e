// mm8_w16_gemm: the inner product of the exact w8a16 mm8 matmul,
//   out[b, n] = sum_k xs[b, k] * q[k, n]      (float32 out)
// with xs (B, K) in bfloat16 or float32 and q the (K, M) int8 codes of one
// layer (a pointer offset into the stacked (L, K, M) codes, never a copy).
// The rank-1 dequantization corrections stay outside, in ops/mm8.py, as in
// the JAX package.
//
// Replaces: chirrup_tpu/ops/mm8_pallas.py::mm8_core_pallas (_mm8_kernel) and
//   mm8_core_pallas_stacked (its scalar-prefetch layer form). Both widen the
//   int8 tile to the activation dtype in VMEM and run the MXU dot with float32
//   accumulation. The JAX package falls back to an XLA dot when B*K exceeds
//   256*16384 (mm8_core_supported); the math is the same, and this kernel
//   serves every row count.
//
// Bound on the H100: at decode row counts (B <= 64) device memory, the K*M
// weight bytes read once (16 MiB for a 4096x4096 layer; 6.7 GB a 7.2B step,
// ~2.0 ms at 3.35 TB/s); at prefill row counts (2,048 rows) the bf16 tensor
// cores, 2*B*K*M operations at 989 TFLOP/s (26.4 TFLOP a 7.2B chunk, ~27 ms).
//
// Design, bfloat16 xs: the int8 GEMM's tiling (mm8_a8.cu). One block of 4
// warps per (32-column tile, 64-row tile); each warp owns 16 rows x 32 columns
// as two WMMA bf16 m16n16k16 fragments with float32 accumulators. The block
// stages 128-deep K slices of xs and of the codes in shared memory, widening
// the codes to bf16 on the way in (exact: |q| <= 128 fits bf16's 8-bit
// significand), and fetches the next slice into registers while the tensor
// cores work on the current one. Every product is exact in float32; only the
// float32 sums round.
//
// Design, float32 xs: true float32 FMAs, no TF32 (TF32 keeps 10 bits of xs
// and would miss a float32 reference by ~1e-3). Same block tile; each thread
// owns a 4x4 output patch and runs fmaf over 32-deep K slices held in shared
// memory (xs transposed, codes widened to float32). Simple, not fast: float32
// activations are the small test models' and the checks' dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 32;  // output tile of a block
constexpr int GT = 128;          // 4 warps

// ----------------------------------------------------------- bfloat16 xs

constexpr int BK = 128;                         // K slice
constexpr int XS = BK + 16;                     // shared row strides in elements:
constexpr int WS = BN + 16;                     //   32-byte multiples (WMMA)
constexpr int X_LOADS = BM * BK / 8 / GT;       // 16-byte loads (8 bf16) per thread: 8
constexpr int W_LOADS = BK * BN / 16 / GT;      // 16-byte loads (16 codes) per thread: 2

__global__ void __launch_bounds__(GT) w16_bf16_kernel(
    const __nv_bfloat16* __restrict__ xs, const int8_t* __restrict__ q,
    float* __restrict__ out, int B, int K, int M) {
  __shared__ __align__(128) __nv_bfloat16 smem[BM * XS + BK * WS];
  __nv_bfloat16* xs_t = smem;            // (BM, BK) activation slice
  __nv_bfloat16* ws_t = smem + BM * XS;  // (BK, BN) widened code slice

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int t = threadIdx.x, warp = t >> 5;

  uint4 xr[X_LOADS], wr[W_LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) {
      const int idx = t + i * GT, row = idx / (BK / 8), c8 = (idx % (BK / 8)) * 8;
      xr[i] = (m0 + row < B)
                  ? *reinterpret_cast<const uint4*>(xs + (size_t)(m0 + row) * K + k0 + c8)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = t + i * GT, row = idx / (BN / 16), c16 = (idx % (BN / 16)) * 16;
      wr[i] = *reinterpret_cast<const uint4*>(q + (size_t)(k0 + row) * M + n0 + c16);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) {
      const int idx = t + i * GT, row = idx / (BK / 8), c8 = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs_t + row * XS + c8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = t + i * GT, row = idx / (BN / 16), c16 = (idx % (BN / 16)) * 16;
      const int8_t* c = reinterpret_cast<const int8_t*>(&wr[i]);
      uint4 lo, hi;
      __nv_bfloat162* hl = reinterpret_cast<__nv_bfloat162*>(&lo);
      __nv_bfloat162* hh = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hl[e] = __floats2bfloat162_rn((float)c[2 * e], (float)c[2 * e + 1]);
        hh[e] = __floats2bfloat162_rn((float)c[8 + 2 * e], (float)c[9 + 2 * e]);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws_t + row * WS + c16);
      dst[0] = lo;
      dst[1] = hi;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);  // next slice in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::load_matrix_sync(fa, xs_t + warp * 16 * XS + kk, XS);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::load_matrix_sync(fb, ws_t + kk * WS + j * 16, WS);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }

  // rows past B are masked: the accumulators go through shared memory
  float* cs = reinterpret_cast<float*>(smem);  // (BM, BN), aliases the slices
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(cs + warp * 16 * BN + j * 16, acc[j], BN, wmma::mem_row_major);
  __syncthreads();
  for (int e = t; e < BM * BN; e += GT) {
    const int row = e / BN, col = e % BN;
    if (m0 + row < B) out[(size_t)(m0 + row) * M + n0 + col] = cs[e];
  }
}

// ------------------------------------------------------------ float32 xs

constexpr int FK = 32;  // K slice

__global__ void __launch_bounds__(GT) w16_f32_kernel(
    const float* __restrict__ xs, const int8_t* __restrict__ q, float* __restrict__ out,
    int B, int K, int M) {
  __shared__ __align__(16) float xs_t[FK][BM + 4];  // transposed: [k][row]
  __shared__ __align__(16) float ws_t[FK][BN];      // [k][col]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int t = threadIdx.x;
  const int tc = t % (BN / 4), tr = t / (BN / 4);  // 8 column groups x 16 row groups
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FK) {
    // xs slice: 64 rows x 32 floats, one float4 per thread per pass
#pragma unroll
    for (int i = 0; i < BM * FK / 4 / GT; ++i) {
      const int idx = t + i * GT, row = idx / (FK / 4), c4 = (idx % (FK / 4)) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + row < B) v = *reinterpret_cast<const float4*>(xs + (size_t)(m0 + row) * K + k0 + c4);
      xs_t[c4][row] = v.x;
      xs_t[c4 + 1][row] = v.y;
      xs_t[c4 + 2][row] = v.z;
      xs_t[c4 + 3][row] = v.w;
    }
    // code slice: 32 x 32 codes, 8 per thread
    {
      const int row = t / (BN / 8), c8 = (t % (BN / 8)) * 8;
      const uint2 u = *reinterpret_cast<const uint2*>(q + (size_t)(k0 + row) * M + n0 + c8);
      const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) ws_t[row][c8 + e] = (float)c[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs_t[kk][tr * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws_t[kk][tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + tr * 4 + i;
    if (b < B)
      *reinterpret_cast<float4*>(out + (size_t)b * M + n0 + tc * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// xs: (B, K) row-major, dtype code 0 = float32, 1 = bfloat16; q points at the
// layer's (K, M) codes; out: (B, M) float32. K % 256 == 0 and M % 32 == 0
// (the wrapper checks). Returns cudaGetLastError().
extern "C" int mm8_w16_gemm(const void* xs, const void* q, void* out, int B, int K, int M,
                            int dtype, void* stream) {
  const dim3 grid(M / BN, (B + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    w16_bf16_kernel<<<grid, GT, 0, s>>>((const __nv_bfloat16*)xs, (const int8_t*)q,
                                        (float*)out, B, K, M);
  else
    w16_f32_kernel<<<grid, GT, 0, s>>>((const float*)xs, (const int8_t*)q, (float*)out, B,
                                       K, M);
  return (int)cudaGetLastError();
}

extern "C" const char* mm8_w16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The w8a8 mm8 matmul as two kernels: per-row activation quantization, and an
// int8 x int8 -> int32 tensor-core GEMM with the mm8 dequantization (and an
// optional relu^2) in its epilogue.
//
// Replaces: chirrup_tpu/ops/mm8_pallas.py::mm8_fused_a8_multi_stacked
//   (_a8_fused_multi_kernel), mm8_fused_a8_stacked and mm8_fused_a8
//   (_fused_a8_call -> _a8_fused_kernel, with mul_ref for the TMix gate), and
//   mm8_fused_a8_ffn_stacked (_a8_ffn_kernel: two launches of each kernel here,
//   the relu^2 epilogue on the first GEMM, the intermediate rounded to bf16).
//   The row math is _quant_rows (mm8_pallas.py:176) and the epilogue
//   _dequant_tile (mm8_pallas.py:190).
//
// mm8_a8_quant_rows, one block per (row b, variant m):
//   x_m  = x                      (mode 0)
//        = x + xx * mu[m]         (mode 1, the token-shift mix of merged R/K/V)
//        = x * mul                (mode 2, the TMix gate before Wo)
//   xs   = x_m * (ry[m] * 16)     s = max(max|xs| / 127, 1e-20)
//   x8   = round_half_even(xs / s)
//   stats[m, b] = [s, sum xs, sum x_m, sum x_m * my[m]]
// Bound: device memory (the rows read once, int8 codes written once); a few
// flops per element. Each element is recomputed for the second pass instead
// of being kept, so a row of any width needs no shared memory.
//
// mm8_a8_gemm, one block per (32-column tile, 64-row tile):
//   acc[b, n] = sum_k x8[var(n), b, k] * q[layer, k, n]       (exact int32)
//   y = rx/16 * (s * acc + 128.5 * sum xs) + sum x*my + mx * sum x
// Bound: at decode row counts (B <= 64) device memory, the K*M weight bytes
// read once (16 MiB for Wo at 7.2B); the tensor-core work, 2*B*K*M int8 ops,
// is ~5x below that line. The design streams each weight byte exactly once
// per 64-row tile: 4 warps each own 16 rows x 32 columns of WMMA s8
// m16n16k16 fragments; the block stages 256-deep K slices of the codes (8
// KiB) and of the activations in shared memory, prefetching the next slice
// into registers while the tensor cores work on the current one. The layer of
// the stacked codes is a pointer offset, never a copy. Accumulation is exact,
// so acc equals any correct int8 GEMM bit for bit; the epilogue uses
// round-to-nearest intrinsics in the order above so that it also matches the
// plain PyTorch version's separately rounded operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------------ quantize

constexpr int QT = 256;  // threads of a quantize block

template <typename T>
__device__ __forceinline__ float mixed(const T* x, const T* aux, const T* mu, int kk,
                                       int mode) {
  const float xf = to_f32(x[kk]);
  if (mode == 1) return __fadd_rn(xf, __fmul_rn(to_f32(aux[kk]), to_f32(mu[kk])));
  if (mode == 2) return __fmul_rn(xf, to_f32(aux[kk]));
  return xf;
}

template <typename T>
__global__ void __launch_bounds__(QT) quant_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ aux, const T* __restrict__ mu,
    const float* __restrict__ ry, const float* __restrict__ my, int8_t* __restrict__ x8,
    float* __restrict__ stats, int B, int K, int mode) {
  __shared__ float red[4][QT / 32];
  __shared__ float s_scale;
  const int b = blockIdx.x, m = blockIdx.y;
  const T* xr = x + (size_t)b * K;
  const T* ar = aux ? aux + (size_t)b * K : nullptr;
  const T* mur = mode == 1 ? mu + (size_t)m * K : nullptr;
  const float* ryr = ry + (size_t)m * K;
  const float* myr = my + (size_t)m * K;

  float amax = 0.0f, sxs = 0.0f, sx = 0.0f, sxmy = 0.0f;
  for (int kk = threadIdx.x; kk < K; kk += QT) {
    const float xf = mixed(xr, ar, mur, kk, mode);
    const float xs = __fmul_rn(xf, __fmul_rn(ryr[kk], 16.0f));
    amax = fmaxf(amax, fabsf(xs));
    sxs += xs;
    sx += xf;
    sxmy += __fmul_rn(xf, myr[kk]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    sxs += __shfl_xor_sync(0xffffffffu, sxs, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    sxmy += __shfl_xor_sync(0xffffffffu, sxmy, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = amax; red[1][warp] = sxs; red[2][warp] = sx; red[3][warp] = sxmy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, p = 0.0f, q = 0.0f, r = 0.0f;
    for (int i = 0; i < QT / 32; ++i) {
      a = fmaxf(a, red[0][i]); p += red[1][i]; q += red[2][i]; r += red[3][i];
    }
    const float s = fmaxf(__fdiv_rn(a, 127.0f), 1e-20f);
    s_scale = s;
    float* st = stats + ((size_t)m * B + b) * 4;
    st[0] = s; st[1] = p; st[2] = q; st[3] = r;
  }
  __syncthreads();
  const float s = s_scale;
  int8_t* out = x8 + ((size_t)m * B + b) * K;
  for (int kk = threadIdx.x; kk < K; kk += QT) {
    const float xs = __fmul_rn(mixed(xr, ar, mur, kk, mode), __fmul_rn(ryr[kk], 16.0f));
    out[kk] = (int8_t)__float2int_rn(__fdiv_rn(xs, s));
  }
}

// ---------------------------------------------------------------------- GEMM

constexpr int BM = 64, BN = 32, BK = 256;
constexpr int GT = 128;                 // 4 warps
constexpr int XS = BK + 32;             // shared row strides (bytes), 32-byte multiples
constexpr int WS = BN + 32;
constexpr int X_LOADS = BM * BK / 16 / GT;  // 16-byte loads per thread per slice: 8
constexpr int W_LOADS = BK * BN / 16 / GT;  // 4

__global__ void __launch_bounds__(GT) gemm_kernel(
    const int8_t* __restrict__ x8, const float* __restrict__ stats,
    const int8_t* __restrict__ q, const float* __restrict__ mx, const float* __restrict__ rx,
    void* __restrict__ out, int B, int K, int M, int n_var, int out_mode, int relu2) {
  __shared__ __align__(128) int8_t smem[BM * XS + BK * WS];
  int8_t* xs_t = smem;            // (BM, BK) activation slice
  int8_t* ws_t = smem + BM * XS;  // (BK, BN) weight slice

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int var = n0 / (M / n_var);
  const int8_t* xv = x8 + (size_t)var * B * K;
  const float* sv = stats + (size_t)var * B * 4;
  const int t = threadIdx.x, warp = t >> 5;

  uint4 xr[X_LOADS], wr[W_LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) {
      const int idx = t + i * GT, rrow = idx / (BK / 16), c16 = (idx % (BK / 16)) * 16;
      xr[i] = (m0 + rrow < B)
                  ? *reinterpret_cast<const uint4*>(xv + (size_t)(m0 + rrow) * K + k0 + c16)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = t + i * GT, rrow = idx / (BN / 16), c16 = (idx % (BN / 16)) * 16;
      wr[i] = *reinterpret_cast<const uint4*>(q + (size_t)(k0 + rrow) * M + n0 + c16);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) {
      const int idx = t + i * GT, rrow = idx / (BK / 16), c16 = (idx % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(xs_t + rrow * XS + c16) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = t + i * GT, rrow = idx / (BN / 16), c16 = (idx % (BN / 16)) * 16;
      *reinterpret_cast<uint4*>(ws_t + rrow * WS + c16) = wr[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);  // next slice in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::load_matrix_sync(fa, (const signed char*)(xs_t + warp * 16 * XS + kk), XS);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::load_matrix_sync(fb, (const signed char*)(ws_t + kk * WS + j * 16), WS);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: accumulators through shared memory, then one element per thread step
  int* cs = reinterpret_cast<int*>(smem);  // (BM, BN) int32, aliases the slices
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(cs + warp * 16 * BN + j * 16, acc[j], BN, wmma::mem_row_major);
  __syncthreads();
  for (int e = t; e < BM * BN; e += GT) {
    const int rrow = e / BN, col = e % BN, b = m0 + rrow, n = n0 + col;
    if (b >= B) continue;
    const int a = cs[e];
    const size_t o = (size_t)b * M + n;
    if (out_mode == 2) {
      reinterpret_cast<int*>(out)[o] = a;
      continue;
    }
    const float* st = sv + (size_t)b * 4;
    float y = __fmul_rn(__fmul_rn(rx[n], 0.0625f),
                        __fadd_rn(__fmul_rn((float)a, st[0]), __fmul_rn(128.5f, st[1])));
    y = __fadd_rn(__fadd_rn(y, st[3]), __fmul_rn(mx[n], st[2]));
    if (relu2) {
      y = fmaxf(y, 0.0f);
      y = __fmul_rn(y, y);
    }
    if (out_mode == 1)
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    else
      reinterpret_cast<float*>(out)[o] = y;
  }
}

}  // namespace

// x, aux, mu: dtype code 0 = float32, 1 = bfloat16 (all three alike).
// aux is xx (mode 1) or mul (mode 2), null in mode 0; mu is null unless mode 1.
extern "C" int mm8_a8_quant_rows(const void* x, const void* aux, const void* mu,
                                 const void* ry, const void* my, void* x8, void* stats,
                                 int B, int K, int n_var, int mode, int dtype,
                                 void* stream) {
  const dim3 grid(B, n_var);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    quant_rows_kernel<__nv_bfloat16><<<grid, QT, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)aux, (const __nv_bfloat16*)mu,
        (const float*)ry, (const float*)my, (int8_t*)x8, (float*)stats, B, K, mode);
  else
    quant_rows_kernel<float><<<grid, QT, 0, s>>>(
        (const float*)x, (const float*)aux, (const float*)mu, (const float*)ry,
        (const float*)my, (int8_t*)x8, (float*)stats, B, K, mode);
  return (int)cudaGetLastError();
}

// q points at the layer's (K, M) codes. out_mode: 0 = float32 y, 1 = bfloat16 y,
// 2 = the raw int32 accumulators (a debug entry for exactness checks).
extern "C" int mm8_a8_gemm(const void* x8, const void* stats, const void* q, const void* mx,
                           const void* rx, void* out, int B, int K, int M, int n_var,
                           int out_mode, int relu2, void* stream) {
  const dim3 grid(M / BN, (B + BM - 1) / BM);
  gemm_kernel<<<grid, GT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x8, (const float*)stats, (const int8_t*)q, (const float*)mx,
      (const float*)rx, out, B, K, M, n_var, out_mode, relu2);
  return (int)cudaGetLastError();
}

extern "C" const char* mm8_a8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// mm8_a8_quant_rows, per (row b, variant m):
//   x_m  = x                      (mode 0)
//        = x + xx * mu[m]         (mode 1, the token-shift mix of merged R/K/V)
//        = x * mul                (mode 2, the TMix gate before Wo)
//   xs   = x_m * (ry[m] * 16)     s = max(max|xs| / 127, 1e-20)
//   x8   = round_half_even(xs / s)
//   stats[m, b] = [s, sum xs, sum x_m, sum x_m * my[m]]
// Bound: device memory, each input byte read once and each code and stat
// written once (64 rows of 4,096: under 1 us at 3.35 TB/s); a few
// operations per element. At decode row counts the time is latency, a few
// microseconds a launch whatever the bytes, so a thread must not walk a
// chain of loads or pass over its row twice; at prefill row counts it is
// the instructions per code.
// Design: one pass with the row in registers. A CTA takes one (row,
// variant); each thread holds 8, 16 or 32 elements in 8-element chunks t,
// t + threads, ... (16-byte loads of x, xx or mul, and mu; float4 loads of
// ry and my), forms the mixed value and xs, keeps xs in registers and its
// partial max and three partial sums. The block reduces
// the four values once (warp shuffles, then one shared-memory round), in a
// fixed order. Each thread then writes its codes 8 to a store. The codes
// are round-half-even of the IEEE quotient xs / s bit for bit: a multiply
// by rn(1/s) decides them except within 2^-15 of a half-integer, where the
// kernel divides (codes4 below). The plan (mm8_cuda.quant_plan) picks the
// elements a thread; s and the codes do not depend on it, the three sums
// only through their order. (All three R/K/V variants in one CTA, reading x
// and xx once, was slower at every row count on the H100: at 16 elements a
// thread it spills within the 64 registers that 1,024 threads leave.)
//
// mm8_a8_gemm, one CTA (or one cluster of CTAs) per (BM-row, BN-column) tile:
//   acc[b, n] = sum_k x8[var(n), b, k] * q[layer, k, n]       (exact int32)
//   y = rx/16 * (s * acc + 128.5 * sum xs) + sum x*my + mx * sum x
// The codes are stored K-major (q[layer] has strides (1, K)): wgmma reads
// 8-bit operands from shared memory K-major only.
// Bound: at decode row counts (B <= 64) device memory, the K*M weight bytes
// read once (16 MiB for Wo at 7.2B, 5 us at 3.35 TB/s); at prefill row counts
// (512-2,048) the int8 tensor cores, 2*B*K*M operations (2,048 rows of R/K/V:
// 0.21 TOP, 104 us at 1,979 TOP/s).
// Design: warp-specialised. One producer thread keeps a ring of STAGES
// shared-memory stages full with TMA (cp.async.bulk.tensor) loads of a
// (BM, 128) activation tile and a (BN, 128) code tile, 128-byte swizzled, each
// stage guarded by a full and an empty mbarrier; one or two consumer
// warpgroups run wgmma m64nBNk32 s8.s8 -> s32 (four per stage) with the
// accumulators in registers and release a stage as soon as the wgmma reading
// it retires. The activations come through a 3-D map (n, B, K), so a row tile
// past B reads zeros and never a neighbouring R/K/V variant's rows; the codes
// through a 3-D map (L, M, K) whose layer is a coordinate, encoded once per
// weight tensor by the wrapper. Two tile configurations:
// - prefill (B > 64): 128 x 256 tiles, or 128 x 128 where those fill the
//   card's waves better (the wrapper's plan), two consumer warpgroups, 4 (6)
//   stages of 48 (32) KiB, setmaxnreg giving the consumers 232 registers;
//   each code byte is read once per 128 rows;
// - decode (B <= 64): 64 x 128 tiles, one consumer warpgroup, 4 stages of 24
//   KiB, two CTAs per SM (128 KiB of codes in flight per SM). Where the column
//   tiles number fewer than 128 (R/K/V, Wo, FFN Wv at 7.2B), K is split across
//   the 2 or 4 CTAs of a thread-block cluster: each sums its K slice, then
//   owns 1/split of the tile's columns, adds the others' int32 partials of
//   those columns through distributed shared memory and runs their epilogue.
//   Integer sums are exact in any order, so this changes no bit and needs no
//   workspace.
// The epilogue runs from registers: each thread reads the stats of its two
// rows and rx, mx of its column pairs once, applies the round-to-nearest
// intrinsics in the order above (the plain PyTorch version's separately
// rounded operations, so y matches it bit for bit), and stores column pairs
// (4 or 8 bytes). Rows >= B are not stored. A tile never straddles an R/K/V
// variant: each variant's width is a multiple of BN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

using namespace hopper;

namespace {

// ------------------------------------------------------------------ quantize

// 8 consecutive elements of a row: one 16-byte load (bf16) or two (float32),
// kept as loaded until they are needed as floats
template <typename T> struct Raw8 { uint4 u[sizeof(T) / 2]; };

template <typename T>
__device__ __forceinline__ Raw8<T> load_raw8(const T* p) {
  Raw8<T> r;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = __ldg(q + i);
  return r;
}

__device__ __forceinline__ void to_floats(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u[0]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void to_floats(const Raw8<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(&r.u[0]);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = f[e];
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// [max, sum, sum, sum] of every thread's v over the block (warp shuffles,
// then one shared-memory round read by warp 0), in a fixed order; every
// thread gets the result. red holds 32 float4, out one.
__device__ __forceinline__ float4 block_stats(float4 v, float4* red, float4* out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x = fmaxf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x = fmaxf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
    }
    if (lane == 0) *out = v;
  }
  __syncthreads();
  return *out;
}

// The codes of 4 elements xs, packed into one word (byte e = element e):
// round-half-even of the IEEE quotient xs / s, bit for bit, without a
// division for almost every element. |xs / s| <= 127 (s >= max|xs| / 127 up
// to its rounding), and q = xs * rn(1/s) has a relative error below 2^-23,
// so |q - xs / s| < 1.6e-5 and |q - rn(xs / s)| < 2e-5. Where q lies farther
// than 2^-15 from every half-integer, no half-integer separates the two and
// they round to the same integer; where one of the four lies within 2^-15
// (about 6 in 10^5 of uniformly spread quotients) the kernel takes the IEEE
// division for all four. q - rint(q) and 0.5 - |that| are exact where the
// test can be close.
__device__ __forceinline__ uint32_t codes4(const float* xs, float s, float inv) {
  float q[4];
  bool near = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    q[e] = __fmul_rn(xs[e], inv);
    near |= 0.5f - fabsf(q[e] - rintf(q[e])) <= 0x1p-15f;
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < 4; ++e) q[e] = __fdiv_rn(xs[e], s);
  }
  return __byte_perm(__byte_perm(__float2int_rn(q[0]), __float2int_rn(q[1]), 0x0040),
                     __byte_perm(__float2int_rn(q[2]), __float2int_rn(q[3]), 0x0040), 0x5410);
}

// One CTA quantizes variant m of row b. Thread t holds the 8-element chunks
// t, t + blockDim.x, ... (E/8 of them) of the row: x (and xx or mul) as
// loaded, then xs in registers between the row statistics and the codes.
// MODE 0: x; 1: x + xx * mu[m]; 2: x * mul.
template <typename T, int E, int MODE>
__global__ void __launch_bounds__(E <= 16 ? 1024 : 512) quant_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ aux, const T* __restrict__ mu,
    const float* __restrict__ ry, const float* __restrict__ my, int8_t* __restrict__ x8,
    float* __restrict__ stats, int B, int K) {
  constexpr int J = E / 8;
  __shared__ float4 red[32];
  __shared__ float4 total;
  const int m = blockIdx.x, b = blockIdx.y, chunks = K / 8;

  Raw8<T> xr[J], ar[J];
  int kk[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    kk[j] = c < chunks ? 8 * c : -1;
    if (kk[j] < 0) continue;
    xr[j] = load_raw8(x + (size_t)b * K + kk[j]);
    if (MODE != 0) ar[j] = load_raw8(aux + (size_t)b * K + kk[j]);
  }
  float xs[J][8];
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (kk[j] < 0) continue;
    float xf[8], r8[8], m8[8];
    to_floats(xr[j], xf);
    load8(ry + (size_t)m * K + kk[j], r8);
    load8(my + (size_t)m * K + kk[j], m8);
    if (MODE != 0) {
      float af[8];
      to_floats(ar[j], af);
      if (MODE == 1) {
        float u8[8];
        to_floats(load_raw8(mu + (size_t)m * K + kk[j]), u8);
#pragma unroll
        for (int e = 0; e < 8; ++e) xf[e] = __fadd_rn(xf[e], __fmul_rn(af[e], u8[e]));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xf[e] = __fmul_rn(xf[e], af[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = __fmul_rn(xf[e], __fmul_rn(r8[e], 16.0f));
      xs[j][e] = v;
      st.x = fmaxf(st.x, fabsf(v));
      st.y += v;
      st.z += xf[e];
      st.w += __fmul_rn(xf[e], m8[e]);
    }
  }
  st = block_stats(st, red, &total);
  const float s = fmaxf(__fdiv_rn(st.x, 127.0f), 1e-20f), inv = __frcp_rn(s);
  if (threadIdx.x == 0)
    *reinterpret_cast<float4*>(stats + ((size_t)m * B + b) * 4) = make_float4(s, st.y, st.z, st.w);
  int8_t* out = x8 + ((size_t)m * B + b) * K;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (kk[j] >= 0)
      *reinterpret_cast<uint2*>(out + kk[j]) =
          make_uint2(codes4(xs[j], s, inv), codes4(xs[j] + 4, s, inv));
}

template <typename T, int E, int MODE>
int launch_quant(const void* x, const void* aux, const void* mu, const void* ry, const void* my,
                 void* x8, void* stats, int B, int K, int n_var, int threads,
                 cudaStream_t stream) {
  quant_rows_kernel<T, E, MODE><<<dim3(n_var, B, 1), threads, 0, stream>>>(
      (const T*)x, (const T*)aux, (const T*)mu, (const float*)ry, (const float*)my, (int8_t*)x8,
      (float*)stats, B, K);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_quant(int elems, int mode, const void* x, const void* aux, const void* mu,
                   const void* ry, const void* my, void* x8, void* stats, int B, int K,
                   int n_var, int threads, cudaStream_t stream) {
#define MM8_A8_QUANT(E, MODE)                                                                \
  if (elems == E && mode == MODE)                                                            \
    return launch_quant<T, E, MODE>(x, aux, mu, ry, my, x8, stats, B, K, n_var, threads, stream);
#define MM8_A8_QUANT_E(E) MM8_A8_QUANT(E, 0) MM8_A8_QUANT(E, 1) MM8_A8_QUANT(E, 2)
  MM8_A8_QUANT_E(8) MM8_A8_QUANT_E(16) MM8_A8_QUANT_E(32)
#undef MM8_A8_QUANT_E
#undef MM8_A8_QUANT
  return ERR_PLAN;
}

// ---------------------------------------------------------------------- GEMM

constexpr int BK = 128;  // K bytes per stage: one 128-byte swizzle row

__device__ __forceinline__ void wgmma_n128(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int32_t (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Tile configuration: BM rows (64 per consumer warpgroup) x BN columns, a
// ring of STAGES stages, and MIN_CTAS CTAs per SM for the register budget.
template <int BM_, int BN_, int STAGES_, int MIN_CTAS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, MIN_CTAS = MIN_CTAS_;
  static constexpr int NC = BM / 64;  // consumer warpgroups
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // stages, full and empty barriers, and slack to align the base to 1024
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(NC * 128 * (BN / 2) * 4 <= STAGES * STAGE_BYTES, "split-K partials fit the ring");
};

using PrefillWide = Tile<128, 256, 4, 1>;
using PrefillNarrow = Tile<128, 128, 6, 1>;
using Decode = Tile<64, 128, 4, 2>;

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_CTAS) gemm_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    const float* __restrict__ stats, const float* __restrict__ mx,
    const float* __restrict__ rx, void* __restrict__ out, int B, int K, int M, int width,
    int layer, int split, int out_mode, int relu2) {
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES, NC = T::NC, R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * T::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto tile_a = [&](int s) { return base + (uint32_t)(s * T::STAGE_BYTES); };
  auto tile_b = [&](int s) { return tile_a(s) + T::A_BYTES; };

  const int rank = split > 1 ? (int)cluster_rank() : 0;
  const int m0 = (blockIdx.x / split) * BM, n0 = blockIdx.y * BN;
  const int var = n0 / width;
  const int kb_n = K / BK / split, kb0 = rank * kb_n;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------------------------------------------------- producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NC * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < kb_n; ++kb) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), T::STAGE_BYTES);
        const int k0 = (kb0 + kb) * BK;
        tma_load_3d(tile_a(s), &xmap, full(s), k0, m0, var);
        tma_load_3d(tile_b(s), &qmap, full(s), k0, n0, layer);
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
    }
    __syncwarp();
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ---------------------------------------------------------- consumers
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    int32_t acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < kb_n; ++kb) {
      mbar_wait(full(s), phase);
      const uint64_t da = smem_desc(tile_a(s) + wg * 64 * BK), db = smem_desc(tile_b(s));
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {  // 32 bytes of K per wgmma: +2 in 16-byte units
        if constexpr (BN == 256) wgmma_n256(acc, da + 2 * kk, db + 2 * kk);
        else wgmma_n128(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      fence_acc(acc);
      if (kb > 0) {  // the previous stage's wgmmas have retired: release it
        wgmma_wait<1>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty(prev));
      }
      prev = s;
      if (++s == STAGES) { s = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // split-K: each CTA of the cluster owns 1/split of the tile's 8-column
    // groups (accumulator quads): it adds the others' partials of those
    // groups, read through distributed shared memory, and stores them. The
    // ring is free here: every load into it has landed and been read.
    const int groups = BN / 8 / split;
    if (split > 1) {
      const uint32_t part = base + (uint32_t)(wg * 128 * R * 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (j / groups != rank)
          asm volatile("st.shared.v4.s32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(part + (uint32_t)((j * 128 + t) * 16)), "r"(acc[4 * j]),
                       "r"(acc[4 * j + 1]), "r"(acc[4 * j + 2]), "r"(acc[4 * j + 3])
                       : "memory");
      cluster_sync();
      for (int r = 1; r < split; ++r) {
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote) : "r"(part), "r"((rank + r) % split));
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if (j / groups != rank) continue;
          int32_t v0, v1, v2, v3;
          asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                       : "r"(remote + (uint32_t)((j * 128 + t) * 16)) : "memory");
          acc[4 * j] += v0; acc[4 * j + 1] += v1; acc[4 * j + 2] += v2; acc[4 * j + 3] += v3;
        }
      }
      cluster_sync();  // the partials stay readable until every CTA has its sums
    }

    // ---------------------------------------------------------- epilogue
    // wgmma's accumulator layout: acc[4j + 2h + e] is row 16*warp + lane/4
    // + 8h, column 8j + 2*(lane%4) + e of this warpgroup's 64 x BN tile
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const float* sv = stats + (size_t)var * B * 4;
    float4 st[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      st[h] = row < B ? *reinterpret_cast<const float4*>(sv + (size_t)row * 4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j / groups != rank) continue;
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const float2 rx2 = *reinterpret_cast<const float2*>(rx + n);
      const float2 mx2 = *reinterpret_cast<const float2*>(mx + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= B) continue;
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        const size_t o = (size_t)row * M + n;
        if (out_mode == 2) {
          *reinterpret_cast<int2*>(reinterpret_cast<int32_t*>(out) + o) = make_int2(a0, a1);
          continue;
        }
        const float4 sr = st[h];
        const float sxs = __fmul_rn(128.5f, sr.y);
        float y0 = __fmul_rn(__fmul_rn(rx2.x, 0.0625f),
                             __fadd_rn(__fmul_rn(__int2float_rn(a0), sr.x), sxs));
        float y1 = __fmul_rn(__fmul_rn(rx2.y, 0.0625f),
                             __fadd_rn(__fmul_rn(__int2float_rn(a1), sr.x), sxs));
        y0 = __fadd_rn(__fadd_rn(y0, sr.w), __fmul_rn(mx2.x, sr.z));
        y1 = __fadd_rn(__fadd_rn(y1, sr.w), __fmul_rn(mx2.y, sr.z));
        if (relu2) {
          y0 = fmaxf(y0, 0.0f);
          y1 = fmaxf(y1, 0.0f);
          y0 = __fmul_rn(y0, y0);
          y1 = __fmul_rn(y1, y1);
        }
        if (out_mode == 1)
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(y0, y1);
        else
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(y0, y1);
      }
    }
  }
}

// ------------------------------------------------------------- host side

template <class T>
int launch(const CUtensorMap& xmap, const CUtensorMap& qmap, const float* stats,
           const float* mx, const float* rx, void* out, int B, int K, int M, int width,
           int layer, int split, int out_mode, int relu2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * ((B + T::BM - 1) / T::BM), M / T::BN, 1);
  cfg.blockDim = dim3(T::THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_kernel<T>, xmap, qmap, stats, mx, rx, out,
                                           B, K, M, width, layer, split, out_mode, relu2);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// x, aux, mu: dtype code 0 = float32, 1 = bfloat16 (all three alike).
// aux is xx (mode 1) or mul (mode 2), null in mode 0; mu is null unless mode 1.
// The launch shape from the wrapper's plan (mm8_cuda.quant_plan): `threads`
// a CTA, each holding `elems` (8, 16 or 32) elements of a row. Rows 16-byte
// aligned.
extern "C" int mm8_a8_quant_rows(const void* x, const void* aux, const void* mu,
                                 const void* ry, const void* my, void* x8, void* stats,
                                 int B, int K, int n_var, int mode, int dtype, int threads,
                                 int elems, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return dispatch_quant<__nv_bfloat16>(elems, mode, x, aux, mu, ry, my, x8, stats, B, K,
                                         n_var, threads, s);
  return dispatch_quant<float>(elems, mode, x, aux, mu, ry, my, x8, stats, B, K, n_var,
                               threads, s);
}

// The tensor map of stacked K-major codes: q points at L layers of (M, K)
// bytes (the logical (L, K, M) with strides (K*M, 1, K)), read in (box_n, 128)
// tiles. map_out: 128 bytes of host memory, handed back to mm8_a8_gemm.
extern "C" int mm8_a8_codes_map(const void* q, int L, int K, int M, int box_n, void* map_out) {
  return encode_codes_map(reinterpret_cast<CUtensorMap*>(map_out), q, L, K, M, box_n);
}

// x8 (n_var, B, K) int8; qmap from mm8_a8_codes_map with box_n = bn; the tile
// configuration (bm, bn, stages, split) from the wrapper's plan. out_mode:
// 0 = float32 y, 1 = bfloat16 y, 2 = the raw int32 accumulators (for exactness
// checks).
extern "C" int mm8_a8_gemm(const void* x8, const void* stats, const void* qmap, const void* mx,
                           const void* rx, void* out, int B, int K, int M, int n_var, int layer,
                           int out_mode, int relu2, int bm, int bn, int stages, int split,
                           void* stream) {
  CUtensorMap xmap;
  const int err = encode_3d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x8, (uint64_t)K, (uint64_t)B,
                            (uint64_t)n_var, (uint32_t)BK, (uint32_t)bm);
  if (err) return err;
  const CUtensorMap& q = *reinterpret_cast<const CUtensorMap*>(qmap);
  const int width = M / n_var;
  cudaStream_t s = (cudaStream_t)stream;
  const float *st = (const float*)stats, *mxp = (const float*)mx, *rxp = (const float*)rx;
#define MM8_A8_LAUNCH(T)                                                                   \
  if (bm == T::BM && bn == T::BN && stages == T::STAGES)                                   \
    return launch<T>(xmap, q, st, mxp, rxp, out, B, K, M, width, layer, split, out_mode, relu2, \
                     s);
  MM8_A8_LAUNCH(PrefillWide)
  MM8_A8_LAUNCH(PrefillNarrow)
  MM8_A8_LAUNCH(Decode)
#undef MM8_A8_LAUNCH
  return ERR_TILE;
}

extern "C" const char* mm8_a8_error_string(int code) { return error_string(code); }

// Helpers shared by the WKV7 kernels (wkv7_step.cu, wkv7_chunk.cu,
// wkv7_batch.cu): dtype conversion, 16-byte loads and stores of one 64-wide
// state row and of 8 consecutive elements, the decay with its dither, and the
// packed bf16 arithmetic of precision="bf16".

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv7 {

constexpr int N = 64;  // head size

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load_row(const float* p, float* s) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int v = 0; v < N / 4; ++v) {
    const float4 f = q[v];
    s[4 * v] = f.x; s[4 * v + 1] = f.y; s[4 * v + 2] = f.z; s[4 * v + 3] = f.w;
  }
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* s) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int v = 0; v < N / 8; ++v) {
    uint4 u = q[v];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      s[8 * v + 2 * e] = f.x;
      s[8 * v + 2 * e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store_row(float* p, const float* s) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int v = 0; v < N / 4; ++v)
    q[v] = make_float4(s[4 * v], s[4 * v + 1], s[4 * v + 2], s[4 * v + 3]);
}

__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* s) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int v = 0; v < N / 8; ++v) {
    uint4 u;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h2[e] = __floats2bfloat162_rn(s[8 * v + 2 * e], s[8 * v + 2 * e + 1]);
    q[v] = u;
  }
}

// 8 consecutive elements as floats (16-byte aligned), and back
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// d = exp(-e^-1/2 * sigmoid(w)) - 1, plus rotator1's dither of the token
// counter: 2^-41 * float(int32(2654435769 * step)), uint32 wrap-around.
__device__ __forceinline__ float decay(float w, unsigned int step, int use_dither) {
  const float sig = 1.0f / (1.0f + expf(-w));
  float d = expf(-0.6065306597126334f * sig) - 1.0f;
  if (use_dither) d += (float)(int)(2654435769u * step) * 0x1p-41f;
  return d;
}

// ---- precision="bf16": a state element pair as one packed __nv_bfloat162
// (a uint32_t, the lower column in the low half, as in memory)
//
// The JAX package's bf16 mode (wkv7_pallas._token_update with bf16_state)
// rounds every elementwise operation to bf16. Each helper is one packed
// operation rounded once to nearest: fma.rn.bf16x2 with a -0 addend is the
// product and with a 1 multiplier the sum, the forms cuda_bf16.h uses for
// __hmul2 and __hadd2. Nothing here is left to the compiler to contract: an
// FMA of the product and the sum would round once where the reference
// rounds twice.
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("{ .reg .b32 z;\n mov.b32 z, 0x80008000;\n fma.rn.bf16x2 %0, %1, %2, z;\n}"
      : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("{ .reg .b32 o;\n mov.b32 o, 0x3f803f80;\n fma.rn.bf16x2 %0, %1, o, %2;\n}"
      : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// two floats, each rounded to nearest: x in the low half, y in the high
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// the halves as floats (exact)
__device__ __forceinline__ float lo_f32(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f32(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }
// float32 sum of the two bf16 products s * x
__device__ __forceinline__ float dot2(uint32_t s, uint32_t x) {
  const uint32_t p = bmul2(s, x);
  return lo_f32(p) + hi_f32(p);
}
// the delta form of one pair: s + ((s * d + v * k) + sa * b), every
// operation rounded to bf16, d = bf16(d1 - 1)
__device__ __forceinline__ uint32_t delta_update(uint32_t s, uint32_t d, uint32_t v, uint32_t k,
                                                 uint32_t sa, uint32_t b) {
  return badd2(s, badd2(badd2(bmul2(s, d), bmul2(v, k)), bmul2(sa, b)));
}

}  // namespace wkv7

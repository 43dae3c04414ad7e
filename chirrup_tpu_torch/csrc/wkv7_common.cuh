// Helpers shared by the WKV7 kernels (wkv7_step.cu, wkv7_chunk.cu,
// wkv7_batch.cu): dtype conversion, 16-byte loads and stores of one 64-wide
// state row and of 8 consecutive elements, the decay with its dither, the
// packed bf16 arithmetic of precision="bf16", and the two recurrences that
// two kernels share: the row core of the step layout (rows_f32, rows_bf16:
// wkv7_step.cu and wkv7_batch.cu at T = 1) and the bf16-mode token of the
// chunk layout (bf16_token_rows: wkv7_chunk.cu and wkv7_batch.cu's bf16
// mode at T > 1).

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


// 16 bytes global -> shared without going through registers (cp.async, L2
// only); `dst` a shared-memory address. Each thread's copies of a tile form
// one group (copy_commit); copy_wait<n> waits until at most n of its groups
// are in flight.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ---- the step layout (wkv7_step.cu; wkv7_batch.cu at T = 1): P neighbouring
// lanes hold one state row, 8 consecutive columns each, RI rows a thread

// the sum over the P neighbouring lanes that hold one state row's columns;
// every one of them gets the same bits (a butterfly of commutative adds)
template <int P>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 consecutive state elements as loaded: bf16 stays packed (4 registers a
// row) until its row's turn. Loads and stores are evict-first (.cs): the
// slab is not touched again before the next token.
template <typename TS> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint4 u; };
template <> struct Raw8<float> { float4 lo, hi; };

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, Raw8<__nv_bfloat16>& r) {
  r.u = __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_raw(const float* p, Raw8<float>& r) {
  r.lo = __ldcs(reinterpret_cast<const float4*>(p));
  r.hi = __ldcs(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, const uint4& u) {
  __stcs(reinterpret_cast<uint4*>(p), u);
}
__device__ __forceinline__ void store_cs(float* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}

// 8 consecutive activations as floats: one vector load where p is 16-byte
// aligned (the rows of the merged R/K/V output are), else one at a time
template <typename T>
__device__ __forceinline__ void load8_any(const T* p, float (&v)[8]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    load8(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = to_f32(p[e]);
  }
}

// One token of the float32 recurrence on a thread's RI rows (raw, rows
// srow + q * ld), this thread's 8 columns of d1, -kk (na), k~ (kt), kk*a
// (nb) and r: row by row, sa_i and y_i joined over the row's P lanes, the
// row updated and, where `store`, stored at once. Returns y_i in yv.
template <int P, int RI, typename TS>
__device__ __forceinline__ void rows_f32(const Raw8<TS> (&raw)[RI], TS* srow, size_t ld,
                                         const float (&d1)[8], const float (&na)[8],
                                         const float (&kt)[8], const float (&nb)[8],
                                         const float (&rr)[8], const float (&vv)[RI],
                                         float (&yv)[RI], bool store) {
#pragma unroll
  for (int q = 0; q < RI; ++q) {
    float s[8];
    unpack(raw[q], s);
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      p0 += na[e] * s[e];
      p1 += na[e + 1] * s[e + 1];
    }
    const float sa = lanes_sum<P>(p0 + p1);
    p0 = p1 = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      s[e] = s[e] * d1[e] + vv[q] * kt[e] + sa * nb[e];
      s[e + 1] = s[e + 1] * d1[e + 1] + vv[q] * kt[e + 1] + sa * nb[e + 1];
      p0 += s[e] * rr[e];
      p1 += s[e + 1] * rr[e + 1];
    }
    yv[q] = lanes_sum<P>(p0 + p1);
    if (store) store_cs(srow + (size_t)q * ld, s);
  }
}

// The same token in precision="bf16" on a bf16 state: this thread's 4
// column pairs of -kk (a2), kk*a (b2), k~ (k2), d = d1 - 1 (d2) and d1*r
// (dr2), each rounded to bf16, and the head's <r, k~> (rk) and <r, b> (rb)
// in float32. One row at a time: sa_i and the S-part of y_i from the old
// row, then the delta update, stored at once where `store`.
template <int P, int RI>
__device__ __forceinline__ void rows_bf16(const Raw8<__nv_bfloat16> (&raw)[RI],
                                          __nv_bfloat16* srow, size_t ld,
                                          const uint32_t (&a2)[4], const uint32_t (&b2)[4],
                                          const uint32_t (&k2)[4], const uint32_t (&d2)[4],
                                          const uint32_t (&dr2)[4], float rk, float rb,
                                          const float (&vv)[RI], float (&yv)[RI], bool store) {
#pragma unroll
  for (int q = 0; q < RI; ++q) {
    uint32_t sp[4] = {raw[q].u.x, raw[q].u.y, raw[q].u.z, raw[q].u.w};
    float p0 = 0.0f, p1 = 0.0f, y0 = 0.0f, y1 = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t pa = bmul2(sp[e], a2[e]), py = bmul2(sp[e], dr2[e]);
      p0 += lo_f32(pa);
      p1 += hi_f32(pa);
      y0 += lo_f32(py);
      y1 += hi_f32(py);
    }
    const float sa = lanes_sum<P>(p0 + p1);
    const uint32_t sa2 = pack2(sa, sa), v2 = pack2(vv[q], vv[q]);
#pragma unroll
    for (int e = 0; e < 4; ++e) sp[e] = delta_update(sp[e], d2[e], v2, k2[e], sa2, b2[e]);
    yv[q] = lanes_sum<P>(y0 + y1) + vv[q] * rk + sa * rb;
    if (store) store_cs(srow + (size_t)q * ld, make_uint4(sp[0], sp[1], sp[2], sp[3]));
  }
}

// ---- the chunk layout (wkv7_chunk.cu; wkv7_batch.cu's bf16 mode at T > 1):
// RI state rows a thread, P threads a row, each holding G float4 column
// groups g * P + part of its rows (in precision="bf16" as two packed pairs)

// One token of precision="bf16" on a thread's rows S: the token's bf16 rows
// of -kk (ha), d = d1 - 1 (hd), k~ (hk), kk*a (hb) and d1*r (hr) in shared
// memory as uint2 pairs, each pointer already at this thread's first group
// of the token; v_i of its rows at v (float32, rows i0 ..); rk = <r, k~>,
// rb = <r, b>. sa_i and the S-part of y_i from the old rows, then the delta
// update; y_i to y[r] by the row's first lane (part 0).
template <int RI, int G, int P>
__device__ __forceinline__ void bf16_token_rows(uint2 (&S)[RI][G], const uint2* ha,
                                                const uint2* hd, const uint2* hk,
                                                const uint2* hb, const uint2* hr,
                                                const float* v, float rk, float rb, float* y,
                                                int part) {
  uint2 f[G];
#pragma unroll
  for (int g = 0; g < G; ++g) f[g] = ha[g * P];
  float sa[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      p0 += dot2(S[r][g].x, f[g].x);
      p1 += dot2(S[r][g].y, f[g].y);
    }
    sa[r] = p0 + p1;
  }
#pragma unroll
  for (int r = 0; r < RI; ++r) sa[r] = lanes_sum<P>(sa[r]);
  float vi[RI];
  uint32_t v2[RI], sa2[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    vi[r] = v[r];
    v2[r] = pack2(vi[r], vi[r]);
    sa2[r] = pack2(sa[r], sa[r]);
  }
  float y0[RI], y1[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) y0[r] = y1[r] = 0.0f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint2 fd = hd[g * P], fk = hk[g * P], fb = hb[g * P], fr = hr[g * P];
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      uint2& q = S[r][g];
      y0[r] += dot2(q.x, fr.x);
      y1[r] += dot2(q.y, fr.y);
      q.x = delta_update(q.x, fd.x, v2[r], fk.x, sa2[r], fb.x);
      q.y = delta_update(q.y, fd.y, v2[r], fk.y, sa2[r], fb.y);
    }
  }
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const float yi = lanes_sum<P>(y0[r] + y1[r]) + vi[r] * rk + sa[r] * rb;
    if (part == 0) y[r] = yi;
  }
}

}  // namespace wkv7

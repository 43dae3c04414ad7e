// penalty_tail: one pass over the (B, V) decode tail.
//
// Replaces: chirrup_tpu/ops/sampling_pallas.py::penalty_tail
//   (kernel body _penalty_tail_kernel).
//
// Per row b (decode rows only decay; the record of the previous sample is
// deferred to this step, see sampling_pallas.py's module note):
//   hit   = upd[b] && v == last[b]
//   occ2  = dec[b] ? (occ + hit) * decay[b] : occ            (written in place)
//   pres2 = hit ? presence_penalty[b] : pres                  (written in place)
//   adj   = logits - pres2 - occ2 * freq[b]
//   cval[b, c], cidx[b, c] = max of adj over columns [128c, 128c + 128) and
//                            the lowest column that attains it
//   lse[b] = logsumexp(adj)
// Columns past V in a last partial chunk take no part.
//
// Bound on the H100: device memory, ~18 bytes per (row, column) at bf16
// logits (logits read, occ and pres read and written); the arithmetic is a
// handful of flops and one exp per element.
//
// Design: one block of 16 warps per row, looping over V; each warp owns whole
// 128-column chunks (4 columns per lane, neighbouring lanes on neighbouring
// columns), reduces their maximum and first argmax with shuffles, and keeps
// an online (max, sum-exp) pair that the block merges at the end. Any B runs:
// the grid is one-dimensional over rows and uses no row-count-sized shared
// memory. adj uses round-to-nearest intrinsics in the reference's operation
// order, so cval and cidx match the plain version exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int PT = 512;  // threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (m, s) <- online merge of a partial sum-exp s2 taken relative to m2
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  const float nm = fmaxf(m, m2);
  s = s * expf(m - nm) + s2 * expf(m2 - nm);
  m = nm;
}

template <typename TL>
__global__ void __launch_bounds__(PT) penalty_tail_kernel(
    const TL* __restrict__ logits, float* __restrict__ occ, float* __restrict__ pres,
    const float* __restrict__ decay, const float* __restrict__ freq,
    const float* __restrict__ pp, const int32_t* __restrict__ last,
    const uint8_t* __restrict__ upd, const uint8_t* __restrict__ dec,
    float* __restrict__ cval, int32_t* __restrict__ cidx, float* __restrict__ lse, int V) {
  __shared__ float red_m[PT / 32], red_s[PT / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (V + CHUNK - 1) / CHUNK;
  const float dcy = decay[b], fq = freq[b], ppen = pp[b];
  const int lt = upd[b] ? last[b] : -1;
  const bool dd = dec[b] != 0;
  const size_t base = (size_t)b * V;

  float run_m = -INFINITY, run_s = 0.0f;
  for (int ch = warp; ch < n_chunks; ch += PT / 32) {
    float vals[CHUNK / 32];
    float best = -INFINITY;
    int best_i = ch * CHUNK + lane;
#pragma unroll
    for (int e = 0; e < CHUNK / 32; ++e) {
      const int col = ch * CHUNK + e * 32 + lane;
      float adj = -INFINITY;
      if (col < V) {
        const size_t idx = base + col;
        const bool hit = col == lt;
        float o = occ[idx];
        if (dd) o = __fmul_rn(__fadd_rn(o, hit ? 1.0f : 0.0f), dcy);
        const float p = hit ? ppen : pres[idx];
        occ[idx] = o;
        pres[idx] = p;
        adj = __fsub_rn(__fsub_rn(to_f32(logits[idx]), p), __fmul_rn(o, fq));
      }
      vals[e] = adj;
      if (e == 0 || adj > best) {  // columns rise with e: strict > keeps the lowest
        best = adj;
        best_i = col;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ov > best || (ov == best && oi < best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    float cs = 0.0f;
    if (best != -INFINITY) {
#pragma unroll
      for (int e = 0; e < CHUNK / 32; ++e) cs += expf(vals[e] - best);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cs += __shfl_xor_sync(0xffffffffu, cs, o);
    if (lane == 0) {
      cval[(size_t)b * n_chunks + ch] = best;
      cidx[(size_t)b * n_chunks + ch] = best_i;
      lse_merge(run_m, run_s, best, cs);
    }
  }
  if (lane == 0) {
    red_m[warp] = run_m;
    red_s[warp] = run_s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = -INFINITY, s = 0.0f;
    for (int i = 0; i < PT / 32; ++i) lse_merge(m, s, red_m[i], red_s[i]);
    lse[b] = m + logf(s);
  }
}

}  // namespace

// logits_dtype: 0 = float32, 1 = bfloat16. upd/dec are bool (one byte each).
extern "C" int penalty_tail(const void* logits, void* occ, void* pres, const void* decay,
                            const void* freq, const void* pp, const void* last,
                            const void* upd, const void* dec, void* cval, void* cidx,
                            void* lse, int B, int V, int logits_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (logits_dtype == 1)
    penalty_tail_kernel<__nv_bfloat16><<<B, PT, 0, s>>>(
        (const __nv_bfloat16*)logits, (float*)occ, (float*)pres, (const float*)decay,
        (const float*)freq, (const float*)pp, (const int32_t*)last, (const uint8_t*)upd,
        (const uint8_t*)dec, (float*)cval, (int32_t*)cidx, (float*)lse, V);
  else
    penalty_tail_kernel<float><<<B, PT, 0, s>>>(
        (const float*)logits, (float*)occ, (float*)pres, (const float*)decay,
        (const float*)freq, (const float*)pp, (const int32_t*)last, (const uint8_t*)upd,
        (const uint8_t*)dec, (float*)cval, (int32_t*)cidx, (float*)lse, V);
  return (int)cudaGetLastError();
}

extern "C" const char* penalty_tail_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

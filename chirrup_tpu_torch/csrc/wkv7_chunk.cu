// wkv7_chunk_fused: a prefill chunk of the RWKV-7 WKV recurrence on layer
// `layer` of the stacked state, up to T tokens per request, with the TMix
// prologue and epilogue fused in.
//
// Replaces: chirrup_tpu/ops/wkv7_pallas.py::wkv7_pallas_chunk_fused
//   (kernel bodies _wkv7_kernel_chunk_fused and _wkv7_kernel_tblocked_fused,
//   with _fused_tmix_group, _token_update_pre and _decay_group).
//
// Math per request b, head h and token t < lengths[b] (S is the head's 64x64
// state, row i = value dim, column j = key dim, at state[layer, b, i, h*64+j]):
//   kk    = l2norm_head(k * k_k)            k~ = k * (1 + (a - 1) * k_a)
//   d1_j  = exp(-e^-1/2 * sigmoid(w_j)) + rotator1(elapsed[b] + t)
//   S_ij <- S_ij * d1_j + v_i * k~_j + (sum_j' -kk_j' S_ij') * (kk_j * a_j)
//   out_i = GroupNorm_head(S r)_i * ln_w + ln_b + (sum_j r_j k~_j r_k_j) * v_i
// out is 0 for t >= lengths[b]. S stays in float32 across the chunk and is
// stored once, in the state dtype, at the end; a row with lengths[b] == 0
// keeps its state bit for bit. Other layers are never touched.
//
// Bound on the H100: the arithmetic. A token costs ~9 float32 operations per
// state element (64 * C per request), 4.8 GFLOP for a layer of 2,048 prompt
// tokens at C 4096, ~0.07 ms at 67 TFLOP/s; its bytes (the state slab once
// each way, five input rows and one output row per token) take about half
// that. What the recurrence adds is latency: each token depends on the last.
//
// Design: one block of 64 threads per (head, request), as the decode step.
// Thread i keeps state row i in registers for the whole chunk, so the slab
// crosses device memory once each way. The chunk goes in tiles of TT tokens,
// each in three phases split by __syncthreads:
//   A. everything that does not depend on S, for the tile's tokens at once:
//      each warp takes every other token, each lane two channels, and the
//      per-head sums (the kk norm, the bonus) are warp shuffles. The rows the
//      recurrence reads (d1, k~, -kk, kk*a, r, v) land in shared memory.
//   B. the serial recurrence: per token, thread i updates its row from
//      shared-memory broadcasts (16-byte reads) and leaves raw y_i there.
//   C. GroupNorm and the bonus, token-parallel again as in A, and the store.
// So only the S update and y = S r are serial; the block synchronises three
// times per tile instead of several times per token.

#include "wkv7_common.cuh"

namespace {

using namespace wkv7;

constexpr int TT = 16;  // tokens per tile: 7 arrays of (TT, 64) floats, 28 KiB

// element strides of the five (B, T, C) input rows r, w, k, a, v (columns
// contiguous): per request and per token
struct RowStrides {
  int b[5], t[5];
};

template <typename TA, typename TS>
__global__ void __launch_bounds__(N) wkv7_chunk_fused_kernel(
    TS* __restrict__ state, const TA* __restrict__ r, const TA* __restrict__ w,
    const TA* __restrict__ k, const TA* __restrict__ a, const TA* __restrict__ v,
    const TA* __restrict__ k_k, const TA* __restrict__ k_a, const TA* __restrict__ r_k,
    const TA* __restrict__ ln_w, const TA* __restrict__ ln_b,
    const int32_t* __restrict__ elapsed, const int32_t* __restrict__ lengths,
    TA* __restrict__ y, int B, int T, int C, int layer, int use_dither, RowStrides ld) {
  __shared__ __align__(16) float s_d1[TT][N], s_k[TT][N], s_a[TT][N], s_b[TT][N];
  __shared__ __align__(16) float s_r[TT][N], s_v[TT][N], s_y[TT][N];
  __shared__ float s_bonus[TT];

  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const int n_tok = min(max(lengths[b], 0), T);
  // phases A and C: lane `lane` of a warp owns channels c0 and c1 of the head
  const int c0 = h * N + lane, c1 = c0 + 32;
  const float kkp0 = to_f32(k_k[c0]), kkp1 = to_f32(k_k[c1]);
  const float kap0 = to_f32(k_a[c0]), kap1 = to_f32(k_a[c1]);
  const float rkp0 = to_f32(r_k[c0]), rkp1 = to_f32(r_k[c1]);
  const float lw0 = to_f32(ln_w[c0]), lw1 = to_f32(ln_w[c1]);
  const float lb0 = to_f32(ln_b[c0]), lb1 = to_f32(ln_b[c1]);
  const unsigned int el = (unsigned int)elapsed[b];

  TS* srow = state + (((size_t)layer * B + b) * N + i) * C + h * N;
  float S[N];
  if (n_tok > 0) load_row(srow, S);

  for (int t0 = 0; t0 < n_tok; t0 += TT) {
    const int nt = min(TT, n_tok - t0);

    // A: the S-independent prologue, one token per warp at a time
    for (int tt = warp; tt < nt; tt += 2) {
      const int t = t0 + tt;
      auto row = [&](const TA* p, int q) { return p + (size_t)b * ld.b[q] + (size_t)t * ld.t[q]; };
      const TA *rr = row(r, 0), *wr = row(w, 1), *kr = row(k, 2), *ar = row(a, 3),
               *vr = row(v, 4);
      const float r0 = to_f32(rr[c0]), r1 = to_f32(rr[c1]);
      const float k0 = to_f32(kr[c0]), k1 = to_f32(kr[c1]);
      const float a0 = to_f32(ar[c0]), a1 = to_f32(ar[c1]);
      const float kp0 = k0 * kkp0, kp1 = k1 * kkp1;
      const float inv = 1.0f / fmaxf(sqrtf(warp_sum(kp0 * kp0 + kp1 * kp1)), 1e-12f);
      const float kk0 = kp0 * inv, kk1 = kp1 * inv;
      const float kt0 = k0 * (1.0f + (a0 - 1.0f) * kap0);
      const float kt1 = k1 * (1.0f + (a1 - 1.0f) * kap1);
      const float bonus = warp_sum(r0 * kt0 * rkp0 + r1 * kt1 * rkp1);
      const unsigned int step = el + (unsigned int)t;
      s_d1[tt][lane] = 1.0f + decay(to_f32(wr[c0]), step, use_dither);
      s_d1[tt][lane + 32] = 1.0f + decay(to_f32(wr[c1]), step, use_dither);
      s_k[tt][lane] = kt0;
      s_k[tt][lane + 32] = kt1;
      s_a[tt][lane] = -kk0;
      s_a[tt][lane + 32] = -kk1;
      s_b[tt][lane] = kk0 * a0;
      s_b[tt][lane + 32] = kk1 * a1;
      s_r[tt][lane] = r0;
      s_r[tt][lane + 32] = r1;
      s_v[tt][lane] = to_f32(vr[c0]);
      s_v[tt][lane + 32] = to_f32(vr[c1]);
      if (lane == 0) s_bonus[tt] = bonus;
    }
    __syncthreads();

    // B: the recurrence, state row i per thread
    for (int tt = 0; tt < nt; ++tt) {
      const float4* a4 = reinterpret_cast<const float4*>(s_a[tt]);
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 f = a4[q];
        p0 += f.x * S[4 * q];
        p1 += f.y * S[4 * q + 1];
        p2 += f.z * S[4 * q + 2];
        p3 += f.w * S[4 * q + 3];
      }
      const float sa = (p0 + p1) + (p2 + p3);
      const float vi = s_v[tt][i];
      const float4 *d4 = reinterpret_cast<const float4*>(s_d1[tt]),
                   *k4 = reinterpret_cast<const float4*>(s_k[tt]),
                   *b4 = reinterpret_cast<const float4*>(s_b[tt]),
                   *r4 = reinterpret_cast<const float4*>(s_r[tt]);
      p0 = p1 = p2 = p3 = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 fd = d4[q], fk = k4[q], fb = b4[q], fr = r4[q];
        S[4 * q] = S[4 * q] * fd.x + vi * fk.x + sa * fb.x;
        S[4 * q + 1] = S[4 * q + 1] * fd.y + vi * fk.y + sa * fb.y;
        S[4 * q + 2] = S[4 * q + 2] * fd.z + vi * fk.z + sa * fb.z;
        S[4 * q + 3] = S[4 * q + 3] * fd.w + vi * fk.w + sa * fb.w;
        p0 += S[4 * q] * fr.x;
        p1 += S[4 * q + 1] * fr.y;
        p2 += S[4 * q + 2] * fr.z;
        p3 += S[4 * q + 3] * fr.w;
      }
      s_y[tt][i] = (p0 + p1) + (p2 + p3);
    }
    __syncthreads();

    // C: per-head GroupNorm (eps 64e-5) and the bonus, one token per warp
    for (int tt = warp; tt < nt; tt += 2) {
      const float y0 = s_y[tt][lane], y1 = s_y[tt][lane + 32];
      const float mu = warp_sum(y0 + y1) * (1.0f / N);
      const float dy0 = y0 - mu, dy1 = y1 - mu;
      const float rs = rsqrtf(warp_sum(dy0 * dy0 + dy1 * dy1) * (1.0f / N) + 64e-5f);
      const float bonus = s_bonus[tt];
      TA* out = y + ((size_t)b * T + t0 + tt) * C;
      out[c0] = from_f32<TA>(dy0 * rs * lw0 + lb0 + bonus * s_v[tt][lane]);
      out[c1] = from_f32<TA>(dy1 * rs * lw1 + lb1 + bonus * s_v[tt][lane + 32]);
    }
    __syncthreads();  // the next tile's phase A overwrites what C read
  }
  if (n_tok > 0) store_row(srow, S);
  for (int t = n_tok; t < T; ++t) y[((size_t)b * T + t) * C + h * N + i] = from_f32<TA>(0.0f);
}

template <typename TA, typename TS>
void launch(void* state, const void* r, const void* w, const void* k, const void* a,
            const void* v, const void* k_k, const void* k_a, const void* r_k,
            const void* ln_w, const void* ln_b, const void* elapsed, const void* lengths,
            void* y, int B, int T, int C, int layer, int use_dither, const RowStrides& ld,
            cudaStream_t stream) {
  const dim3 grid(C / N, B);
  wkv7_chunk_fused_kernel<TA, TS><<<grid, N, 0, stream>>>(
      (TS*)state, (const TA*)r, (const TA*)w, (const TA*)k, (const TA*)a, (const TA*)v,
      (const TA*)k_k, (const TA*)k_a, (const TA*)r_k, (const TA*)ln_w, (const TA*)ln_b,
      (const int32_t*)elapsed, (const int32_t*)lengths, (TA*)y, B, T, C, layer, use_dither,
      ld);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. sb_*, st_*: element strides per
// request and per token of the (B, T, C) inputs r, w, k, a, v, whose columns
// are contiguous; y is a contiguous (B, T, C). Returns cudaGetLastError().
extern "C" int wkv7_chunk_fused(void* state, const void* r, const void* w, const void* k,
                                const void* a, const void* v, const void* k_k,
                                const void* k_a, const void* r_k, const void* ln_w,
                                const void* ln_b, const void* elapsed, const void* lengths,
                                void* y, int B, int T, int C, int layer, int use_dither,
                                int sb_r, int st_r, int sb_w, int st_w, int sb_k, int st_k,
                                int sb_a, int st_a, int sb_v, int st_v, int act_dtype,
                                int state_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const RowStrides ld = {{sb_r, sb_w, sb_k, sb_a, sb_v}, {st_r, st_w, st_k, st_a, st_v}};
  if (act_dtype == 1 && state_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b,
                                         elapsed, lengths, y, B, T, C, layer, use_dither, ld, s);
  else if (act_dtype == 1 && state_dtype == 0)
    launch<__nv_bfloat16, float>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed,
                                 lengths, y, B, T, C, layer, use_dither, ld, s);
  else if (act_dtype == 0 && state_dtype == 1)
    launch<float, __nv_bfloat16>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed,
                                 lengths, y, B, T, C, layer, use_dither, ld, s);
  else
    launch<float, float>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed, lengths,
                         y, B, T, C, layer, use_dither, ld, s);
  return (int)cudaGetLastError();
}

extern "C" const char* wkv7_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

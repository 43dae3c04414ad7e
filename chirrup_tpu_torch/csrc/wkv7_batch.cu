// wkv7_batch: the bare RWKV-7 WKV recurrence on layer `layer` of the stacked
// state, T >= 1 tokens per request, with ragged lengths. No TMix prologue or
// epilogue: a = -kk and b = kk * a_iclr come in precomputed, k is k~, and raw
// y = S r goes out (GroupNorm and the bonus run outside, in models/rwkv7.py).
//
// Replaces: chirrup_tpu/ops/wkv7_pallas.py::_wkv7_pallas_call_t1
//   (_wkv7_kernel_t1, T = 1) and _wkv7_pallas_call (_wkv7_kernel and
//   _wkv7_kernel_tblocked, T > 1), both reached through wkv7_pallas_batch.
//   One kernel serves every T here, and T is not padded.
//
// Math per request b, head h and token t < lengths[b] (S is the head's 64x64
// state, row i = value dim, column j = key dim, at state[layer, b, i, h*64+j]):
//   d1_j  = exp(-e^-1/2 * sigmoid(w_j)) + rotator1(elapsed[b] + t)
//   S_ij <- S_ij * d1_j + v_i * k_j + (sum_j' a_j' S_ij') * b_j
//   y_i   = sum_j S_ij r_j
// y is 0 for t >= lengths[b], in r's dtype. S stays in float32 across the
// chunk (the JAX precisions "highest" and "default") and is stored once, in
// the state dtype; a row with lengths[b] == 0 keeps its state bit for bit.
//
// Bound on the H100: for a decode step (T = 1) device memory, the state slab
// read and written once (2 * 64 * C elements per request); for a chunk the
// arithmetic, ~9 float32 operations per state element per token. The serial
// dependence between tokens adds latency on top.
//
// Design: wkv7_chunk.cu's, without its per-head sums. One block of 64
// threads per (head, request); thread i keeps state row i in registers for
// the whole chunk, so the slab crosses device memory once each way. Tokens go
// in tiles of TT: first each thread loads channel i of the tile's six rows
// (coalesced) and writes d1, k, a, b, r and v into shared memory; then the
// serial recurrence reads them as 16-byte broadcasts and each thread stores
// its own y_i.

#include "wkv7_common.cuh"

namespace {

using namespace wkv7;

constexpr int TT = 16;  // tokens per tile: 6 arrays of (TT, 64) floats, 24 KiB

// element strides of the six (B, T, C) input rows r, w, k, v, a, b (columns
// contiguous): per request and per token
struct RowStrides {
  int b[6], t[6];
};

template <typename TA, typename TS>
__global__ void __launch_bounds__(N) wkv7_batch_kernel(
    TS* __restrict__ state, const TA* __restrict__ r, const TA* __restrict__ w,
    const TA* __restrict__ k, const TA* __restrict__ v, const TA* __restrict__ a,
    const TA* __restrict__ bb, const int32_t* __restrict__ elapsed,
    const int32_t* __restrict__ lengths, TA* __restrict__ y, int B, int T, int C, int layer,
    int use_dither, RowStrides ld) {
  __shared__ __align__(16) float s_d1[TT][N], s_k[TT][N], s_a[TT][N], s_b[TT][N];
  __shared__ __align__(16) float s_r[TT][N], s_v[TT][N];

  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const int n_tok = min(max(lengths[b], 0), T);
  const int c = h * N + i;
  const unsigned int el = (unsigned int)elapsed[b];

  TS* srow = state + (((size_t)layer * B + b) * N + i) * C + h * N;
  float S[N];
  if (n_tok > 0) load_row(srow, S);

  for (int t0 = 0; t0 < n_tok; t0 += TT) {
    const int nt = min(TT, n_tok - t0);
    // channel c of each token's rows; no value depends on S
    for (int tt = 0; tt < nt; ++tt) {
      const int t = t0 + tt;
      auto at = [&](const TA* p, int q) {
        return to_f32(p[(size_t)b * ld.b[q] + (size_t)t * ld.t[q] + c]);
      };
      s_r[tt][i] = at(r, 0);
      s_d1[tt][i] = 1.0f + decay(at(w, 1), el + (unsigned int)t, use_dither);
      s_k[tt][i] = at(k, 2);
      s_v[tt][i] = at(v, 3);
      s_a[tt][i] = at(a, 4);
      s_b[tt][i] = at(bb, 5);
    }
    __syncthreads();

    // the recurrence, state row i per thread
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
      y[((size_t)b * T + t0 + tt) * C + c] = from_f32<TA>((p0 + p1) + (p2 + p3));
    }
    __syncthreads();  // the next tile overwrites what this one read
  }
  if (n_tok > 0) store_row(srow, S);
  for (int t = n_tok; t < T; ++t) y[((size_t)b * T + t) * C + c] = from_f32<TA>(0.0f);
}

template <typename TA, typename TS>
void launch(void* state, const void* r, const void* w, const void* k, const void* v,
            const void* a, const void* b, const void* elapsed, const void* lengths, void* y,
            int B, int T, int C, int layer, int use_dither, const RowStrides& ld,
            cudaStream_t stream) {
  const dim3 grid(C / N, B);
  wkv7_batch_kernel<TA, TS><<<grid, N, 0, stream>>>(
      (TS*)state, (const TA*)r, (const TA*)w, (const TA*)k, (const TA*)v, (const TA*)a,
      (const TA*)b, (const int32_t*)elapsed, (const int32_t*)lengths, (TA*)y, B, T, C, layer,
      use_dither, ld);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. sb_*, st_*: element strides per
// request and per token of the (B, T, C) inputs r, w, k, v, a, b, whose
// columns are contiguous; y is a contiguous (B, T, C). Returns
// cudaGetLastError().
extern "C" int wkv7_batch(void* state, const void* r, const void* w, const void* k,
                          const void* v, const void* a, const void* b, const void* elapsed,
                          const void* lengths, void* y, int B, int T, int C, int layer,
                          int use_dither, int sb_r, int st_r, int sb_w, int st_w, int sb_k,
                          int st_k, int sb_v, int st_v, int sb_a, int st_a, int sb_b, int st_b,
                          int act_dtype, int state_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const RowStrides ld = {{sb_r, sb_w, sb_k, sb_v, sb_a, sb_b},
                         {st_r, st_w, st_k, st_v, st_a, st_b}};
  if (act_dtype == 1 && state_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(state, r, w, k, v, a, b, elapsed, lengths, y, B, T,
                                         C, layer, use_dither, ld, s);
  else if (act_dtype == 1 && state_dtype == 0)
    launch<__nv_bfloat16, float>(state, r, w, k, v, a, b, elapsed, lengths, y, B, T, C, layer,
                                 use_dither, ld, s);
  else if (act_dtype == 0 && state_dtype == 1)
    launch<float, __nv_bfloat16>(state, r, w, k, v, a, b, elapsed, lengths, y, B, T, C, layer,
                                 use_dither, ld, s);
  else
    launch<float, float>(state, r, w, k, v, a, b, elapsed, lengths, y, B, T, C, layer,
                         use_dither, ld, s);
  return (int)cudaGetLastError();
}

extern "C" const char* wkv7_batch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// precision="bf16" on a bf16 state (the BF instances; the JAX package's
// _token_update with bf16_state) keeps S in bf16, rounded every token, and
// takes the delta form, every elementwise operation a bf16 one rounded to
// nearest (wkv7_common.cuh; d = d1 - 1):
//   S_ij <- S_ij + ((S_ij * d_j + v_i * k_j) + sa_i * b_j)
//   y_i   = sum_j S_ij * bf16(d1_j r_j) + v_i <r, k> + sa_i <r, b>
// sa_i and y_i float32 sums of bf16 products of the old S.
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
// its own y_i. The BF instances keep the row as 32 packed pairs and stage
// the rows the recurrence reads as bf16, with each token's <r, k> and <r,
// b> summed over the block's two warps.

#include "wkv7_common.cuh"

namespace {

using namespace wkv7;

constexpr int TT = 16;  // tokens per tile: 6 arrays of (TT, 64) floats, 24 KiB

// element strides of the six (B, T, C) input rows r, w, k, v, a, b (columns
// contiguous): per request and per token
struct RowStrides {
  int b[6], t[6];
};

// precision="bf16": the recurrence on thread i's state row as packed pairs,
// reusing the kernel's tile arrays: d = d1 - 1, k, a, b and d1*r as bf16 in
// the first half of s_d1, s_k, s_a, s_b and s_r, v as float32 in s_v, and the
// two warps' parts of <r, k> and <r, b> in the second half of s_a
template <typename TA>
__device__ __forceinline__ void batch_rows_bf16(
    __nv_bfloat16* srow, const TA* __restrict__ r, const TA* __restrict__ w,
    const TA* __restrict__ k, const TA* __restrict__ v, const TA* __restrict__ a,
    const TA* __restrict__ bb, TA* __restrict__ y, float (*s_d1)[N], float (*s_k)[N],
    float (*s_a)[N], float (*s_b)[N], float (*s_r)[N], float (*s_v)[N], int b, int i, int c,
    int n_tok, int T, int C, unsigned int el, int use_dither, const RowStrides& ld) {
  const auto bf = [](float (*p)[N]) { return reinterpret_cast<__nv_bfloat16(*)[N]>(p); };
  __nv_bfloat16(*h_d)[N] = bf(s_d1), (*h_k)[N] = bf(s_k), (*h_a)[N] = bf(s_a);
  __nv_bfloat16(*h_b)[N] = bf(s_b), (*h_r)[N] = bf(s_r);
  float(*s_part)[4] = reinterpret_cast<float(*)[4]>(&s_a[TT / 2][0]);
  const int lane = i & 31, warp = i >> 5;

  uint32_t S[N / 2];
  if (n_tok > 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(srow)[q];
      S[4 * q] = u.x; S[4 * q + 1] = u.y; S[4 * q + 2] = u.z; S[4 * q + 3] = u.w;
    }
  }
  for (int t0 = 0; t0 < n_tok; t0 += TT) {
    const int nt = min(TT, n_tok - t0);
    for (int tt = 0; tt < nt; ++tt) {
      const int t = t0 + tt;
      auto at = [&](const TA* p, int q) {
        return to_f32(p[(size_t)b * ld.b[q] + (size_t)t * ld.t[q] + c]);
      };
      const float rr = at(r, 0), kv = at(k, 2), bv = at(bb, 5);
      const float d1 = 1.0f + decay(at(w, 1), el + (unsigned int)t, use_dither);
      h_d[tt][i] = __float2bfloat16_rn(d1 - 1.0f);
      h_k[tt][i] = __float2bfloat16_rn(kv);
      h_a[tt][i] = __float2bfloat16_rn(at(a, 4));
      h_b[tt][i] = __float2bfloat16_rn(bv);
      h_r[tt][i] = __float2bfloat16_rn(d1 * rr);
      s_v[tt][i] = at(v, 3);
      float rk = rr * kv, rb = rr * bv;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        rk += __shfl_xor_sync(0xffffffffu, rk, o);
        rb += __shfl_xor_sync(0xffffffffu, rb, o);
      }
      if (lane == 0) {
        s_part[tt][warp] = rk;
        s_part[tt][2 + warp] = rb;
      }
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const uint4 *a4 = reinterpret_cast<const uint4*>(h_a[tt]),
                  *r4 = reinterpret_cast<const uint4*>(h_r[tt]);
      float p0 = 0.0f, p1 = 0.0f, y0 = 0.0f, y1 = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        const uint4 fa = a4[q], fr = r4[q];
        p0 += dot2(S[4 * q], fa.x) + dot2(S[4 * q + 2], fa.z);
        p1 += dot2(S[4 * q + 1], fa.y) + dot2(S[4 * q + 3], fa.w);
        y0 += dot2(S[4 * q], fr.x) + dot2(S[4 * q + 2], fr.z);
        y1 += dot2(S[4 * q + 1], fr.y) + dot2(S[4 * q + 3], fr.w);
      }
      const float sa = p0 + p1, vi = s_v[tt][i];
      const uint32_t sa2 = pack2(sa, sa), v2 = pack2(vi, vi);
      const uint4 *d4 = reinterpret_cast<const uint4*>(h_d[tt]),
                  *k4 = reinterpret_cast<const uint4*>(h_k[tt]),
                  *b4 = reinterpret_cast<const uint4*>(h_b[tt]);
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        const uint4 fd = d4[q], fk = k4[q], fb = b4[q];
        S[4 * q] = delta_update(S[4 * q], fd.x, v2, fk.x, sa2, fb.x);
        S[4 * q + 1] = delta_update(S[4 * q + 1], fd.y, v2, fk.y, sa2, fb.y);
        S[4 * q + 2] = delta_update(S[4 * q + 2], fd.z, v2, fk.z, sa2, fb.z);
        S[4 * q + 3] = delta_update(S[4 * q + 3], fd.w, v2, fk.w, sa2, fb.w);
      }
      const float rk = s_part[tt][0] + s_part[tt][1], rb = s_part[tt][2] + s_part[tt][3];
      y[((size_t)b * T + t0 + tt) * C + c] = from_f32<TA>((y0 + y1) + vi * rk + sa * rb);
    }
    __syncthreads();  // the next tile overwrites what this one read
  }
  if (n_tok > 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
      reinterpret_cast<uint4*>(srow)[q] = make_uint4(S[4 * q], S[4 * q + 1], S[4 * q + 2],
                                                     S[4 * q + 3]);
  }
  for (int t = n_tok; t < T; ++t) y[((size_t)b * T + t) * C + c] = from_f32<TA>(0.0f);
}

template <typename TA, typename TS, bool BF>
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
  if constexpr (BF) {
    static_assert(sizeof(TS) == 2, "precision bf16 runs on a bf16 state");
    batch_rows_bf16<TA>(srow, r, w, k, v, a, bb, y, s_d1, s_k, s_a, s_b, s_r, s_v, b, i, c,
                        n_tok, T, C, el, use_dither, ld);
    return;
  }
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

template <typename TA, typename TS, bool BF>
void launch(void* state, const void* r, const void* w, const void* k, const void* v,
            const void* a, const void* b, const void* elapsed, const void* lengths, void* y,
            int B, int T, int C, int layer, int use_dither, const RowStrides& ld,
            cudaStream_t stream) {
  const dim3 grid(C / N, B);
  wkv7_batch_kernel<TA, TS, BF><<<grid, N, 0, stream>>>(
      (TS*)state, (const TA*)r, (const TA*)w, (const TA*)k, (const TA*)v, (const TA*)a,
      (const TA*)b, (const int32_t*)elapsed, (const int32_t*)lengths, (TA*)y, B, T, C, layer,
      use_dither, ld);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. sb_*, st_*: element strides per
// request and per token of the (B, T, C) inputs r, w, k, v, a, b, whose
// columns are contiguous; y is a contiguous (B, T, C). bf16_mode:
// precision="bf16", on a bf16 state only (a float32 state runs the float32
// update, as the JAX package does). Returns cudaGetLastError().
extern "C" int wkv7_batch(void* state, const void* r, const void* w, const void* k,
                          const void* v, const void* a, const void* b, const void* elapsed,
                          const void* lengths, void* y, int B, int T, int C, int layer,
                          int use_dither, int sb_r, int st_r, int sb_w, int st_w, int sb_k,
                          int st_k, int sb_v, int st_v, int sb_a, int st_a, int sb_b, int st_b,
                          int act_dtype, int state_dtype, int bf16_mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const RowStrides ld = {{sb_r, sb_w, sb_k, sb_v, sb_a, sb_b},
                         {st_r, st_w, st_k, st_v, st_a, st_b}};
#define WKV7_BATCH_LAUNCH(TA, TS, BF) \
  launch<TA, TS, BF>(state, r, w, k, v, a, b, elapsed, lengths, y, B, T, C, layer, use_dither, ld, s)
  if (bf16_mode && state_dtype == 1 && act_dtype == 1)
    WKV7_BATCH_LAUNCH(__nv_bfloat16, __nv_bfloat16, true);
  else if (bf16_mode && state_dtype == 1)
    WKV7_BATCH_LAUNCH(float, __nv_bfloat16, true);
  else if (act_dtype == 1 && state_dtype == 1)
    WKV7_BATCH_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
  else if (act_dtype == 1 && state_dtype == 0)
    WKV7_BATCH_LAUNCH(__nv_bfloat16, float, false);
  else if (act_dtype == 0 && state_dtype == 1)
    WKV7_BATCH_LAUNCH(float, __nv_bfloat16, false);
  else
    WKV7_BATCH_LAUNCH(float, float, false);
#undef WKV7_BATCH_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* wkv7_batch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// wkv7_step_fused: one decode token of the RWKV-7 WKV recurrence on layer
// `layer` of the stacked state, with the TMix prologue and epilogue fused in.
//
// Replaces: chirrup_tpu/ops/wkv7_pallas.py::wkv7_pallas_step_fused
//   (kernel body _wkv7_kernel_t1_fused with _fused_tmix_token, _token_update
//   and _decay_row).
//
// Math per request b and head h (state S is 64x64, row i = value dim,
// column j = key dim; stored at state[layer, b, i, h*64 + j]):
//   kk    = l2norm_head(k * k_k)            k~ = k * (1 + (a - 1) * k_a)
//   d1_j  = exp(-e^-1/2 * sigmoid(w_j)) + rotator1(elapsed[b])
//   S_ij <- S_ij * d1_j + v_i * k~_j + (sum_j' -kk_j' S_ij') * (kk_j * a_j)
//   y_i   = sum_j S_ij r_j
//   out_i = GroupNorm_head(y)_i * ln_w + ln_b + (sum_j r_j k~_j r_k_j) * v_i
// Rows with lengths[b] == 0 keep S bit-unchanged and output 0.
//
// Bound on the H100: device memory. Each call reads and writes layer
// `layer`'s state slab once (2 * B * 64 * C * sizeof(state) bytes, 64 MiB at
// B=64, C=4096, bf16); the arithmetic is ~10 flops per state element.
//
// Design: one block of 64 threads per (head, request). Thread i keeps state
// row i (64 floats) in registers for the whole token, so the slab crosses
// device memory exactly once each way; the head's r, d1, k~, -kk, kk*a rows
// sit in shared memory and are read as broadcasts. The per-head reductions
// (the kk norm, the bonus sum and the GroupNorm statistics) are 64-thread
// block sums. Everything is head-local, so there is no cross-block step.
// Loads and stores of a state row are 16-byte vectors.

#include "wkv7_common.cuh"

namespace {

using namespace wkv7;

template <typename TA, typename TS>
__global__ void __launch_bounds__(N) wkv7_step_fused_kernel(
    TS* __restrict__ state, const TA* __restrict__ r, const TA* __restrict__ w,
    const TA* __restrict__ k, const TA* __restrict__ a, const TA* __restrict__ v,
    const TA* __restrict__ k_k, const TA* __restrict__ k_a, const TA* __restrict__ r_k,
    const TA* __restrict__ ln_w, const TA* __restrict__ ln_b,
    const int32_t* __restrict__ elapsed, const int32_t* __restrict__ lengths,
    TA* __restrict__ y, int B, int C, int layer, int use_dither, int ld_r, int ld_w,
    int ld_k, int ld_a, int ld_v) {
  __shared__ float s_r[N], s_d1[N], s_k[N], s_a[N], s_b[N];
  __shared__ float red[2];

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int c = h * N + t;                  // channel of lane j = t (and of row i = t)
  const size_t row = (size_t)b * C + c;     // offset into the (B, C) output rows
  const bool active = lengths[b] > 0;

  // prologue, lane j = t
  const float kr = to_f32(k[(size_t)b * ld_k + c]);
  const float ai = to_f32(a[(size_t)b * ld_a + c]);
  const float rr = to_f32(r[(size_t)b * ld_r + c]);
  const float kk_pre = kr * to_f32(k_k[c]);
  const float norm2 = block_sum64(kk_pre * kk_pre, red);
  const float kk = kk_pre * (1.0f / fmaxf(sqrtf(norm2), 1e-12f));
  const float kt = kr * (1.0f + (ai - 1.0f) * to_f32(k_a[c]));
  const float bonus = block_sum64(rr * kt * to_f32(r_k[c]), red);

  const float d = decay(to_f32(w[(size_t)b * ld_w + c]), (unsigned int)elapsed[b], use_dither);
  // row-folded activity mask: d1 = 1, k~ = 0, b = 0 leave S unchanged
  s_r[t] = rr;
  s_d1[t] = active ? 1.0f + d : 1.0f;
  s_k[t] = active ? kt : 0.0f;
  s_a[t] = -kk;
  s_b[t] = active ? kk * ai : 0.0f;
  __syncthreads();

  // recurrence, row i = t
  TS* srow = state + (((size_t)layer * B + b) * N + t) * C + h * N;
  float S[N];
  load_row(srow, S);
  float sa = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) sa += s_a[j] * S[j];
  const float vi = to_f32(v[(size_t)b * ld_v + c]);
  float yi = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    S[j] = S[j] * s_d1[j] + vi * s_k[j] + sa * s_b[j];
    yi += S[j] * s_r[j];
  }
  if (active) store_row(srow, S);

  // epilogue: per-head GroupNorm (eps 64e-5) over the 64 rows, plus the bonus
  const float mu = block_sum64(yi, red) * (1.0f / N);
  const float dy = yi - mu;
  const float var = block_sum64(dy * dy, red) * (1.0f / N);
  const float out = dy * rsqrtf(var + 64e-5f) * to_f32(ln_w[c]) + to_f32(ln_b[c]) + bonus * vi;
  y[row] = from_f32<TA>(active ? out : 0.0f);
}

template <typename TA, typename TS>
void launch(void* state, const void* r, const void* w, const void* k, const void* a,
            const void* v, const void* k_k, const void* k_a, const void* r_k,
            const void* ln_w, const void* ln_b, const void* elapsed, const void* lengths,
            void* y, int B, int C, int layer, int use_dither, const int* ld,
            cudaStream_t stream) {
  const dim3 grid(C / N, B);
  wkv7_step_fused_kernel<TA, TS><<<grid, N, 0, stream>>>(
      (TS*)state, (const TA*)r, (const TA*)w, (const TA*)k, (const TA*)a, (const TA*)v,
      (const TA*)k_k, (const TA*)k_a, (const TA*)r_k, (const TA*)ln_w, (const TA*)ln_b,
      (const int32_t*)elapsed, (const int32_t*)lengths, (TA*)y, B, C, layer, use_dither, ld[0],
      ld[1], ld[2], ld[3], ld[4]);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. ld_*: row strides (elements) of the
// (B, C) inputs r, w, k, a, v, whose columns are contiguous. Returns
// cudaGetLastError().
extern "C" int wkv7_step_fused(void* state, const void* r, const void* w, const void* k,
                               const void* a, const void* v, const void* k_k,
                               const void* k_a, const void* r_k, const void* ln_w,
                               const void* ln_b, const void* elapsed, const void* lengths,
                               void* y, int B, int C, int layer, int use_dither, int ld_r,
                               int ld_w, int ld_k, int ld_a, int ld_v, int act_dtype,
                               int state_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ld[5] = {ld_r, ld_w, ld_k, ld_a, ld_v};
  if (act_dtype == 1 && state_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b,
                                         elapsed, lengths, y, B, C, layer, use_dither, ld, s);
  else if (act_dtype == 1 && state_dtype == 0)
    launch<__nv_bfloat16, float>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed,
                                 lengths, y, B, C, layer, use_dither, ld, s);
  else if (act_dtype == 0 && state_dtype == 1)
    launch<float, __nv_bfloat16>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed,
                                 lengths, y, B, C, layer, use_dither, ld, s);
  else
    launch<float, float>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed, lengths,
                         y, B, C, layer, use_dither, ld, s);
  return (int)cudaGetLastError();
}

extern "C" const char* wkv7_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// Rows with lengths[b] == 0 keep S bit-unchanged (it is neither read nor
// written) and output 0.
//
// precision="bf16" on a bf16 state (the BF instances; the JAX package's
// _token_update with bf16_state): the state stays bf16 and the update takes
// the delta form, every elementwise operation a bf16 one rounded to nearest
// (wkv7_common.cuh's packed helpers; d = bf16(d1 - 1), sa rounded to bf16
// where it meets b):
//   S_ij <- S_ij + ((S_ij * d_j + v_i * k~_j) + sa_i * b_j)
//   y_i   = sum_j S_ij * bf16(d1_j r_j) + v_i <r, k~> + sa_i <r, b>
// with sa_i and y_i float32 sums of bf16 products of the OLD S. The launch
// is the same; each thread keeps its 16 x 8 slice packed, 64 registers, and
// never widens it: the sums widen each pair's products.
//
// Bound on the H100: device memory. Each call reads and writes layer
// `layer`'s state slab once (2 * B * 64 * C * sizeof(state) bytes, 64 MiB at
// B=64, C=4096, bf16); the arithmetic is ~10 flops per state element. In a
// decode step every call finds its slab cold: the step walks all the layers
// (1 GiB of state at B=64) and the weights between two calls on one layer.
//
// Design: one block of NT = HB * 64 / RI * P = 128 threads per HB = 4
// neighbouring heads of one request, RI = 16 state rows a thread and P = 8
// threads a row (wkv7_cuda.step_plan describes the launch). Lane group g of
// warp w (8 neighbouring lanes) holds rows 16w .. 16w + 15 of head g, each
// lane 8 consecutive columns, so one warp load instruction reads one state
// row of four heads: 512 contiguous bytes in bf16 (16 bytes a lane). Every
// thread issues the loads of its RI rows first, into registers (bf16 kept
// packed, 4 registers a row), so that their DRAM latency overlaps the
// prologue; a warp has 8 KiB in flight and an SM runs 12 warps. The loads
// and stores of the state are evict-first (ld/st .cs): the slab is not
// touched again before the next token. The prologue (kk norm, k~, decay,
// bonus) needs no state: each thread computes it for its own 8 columns, the
// head's sums joined over the row's P lanes with __shfl_xor (every lane gets
// the same bits), with no shared memory and no barrier. Then row by row:
// sa_i and y_i are P-lane shuffle sums, the row is updated and stored at
// once. The GroupNorm over a head's 64 rows sums its four warps' partial
// sums in shared memory. A head never spans blocks; a head slot past the
// last head (H not a multiple of HB) computes on a valid head and stores
// nothing. Of the launch shapes timed with cold state at batch 64 on the
// H100 (1, 2 or 4 heads a block, 8 or 16 rows a thread, with and without
// the evict-first hints, with register caps that allow more warps an SM),
// this one was the fastest (PERF.md).
// The row core (rows_f32, rows_bf16) is wkv7_common.cuh's, shared with
// the bare kernel's T = 1 launch (wkv7_batch.cu).

#include "hopper_common.cuh"
#include "wkv7_common.cuh"

namespace {

using namespace wkv7;

// the launch: HB heads a block, RI state rows a thread, P threads a row (G
// row groups of P lanes a warp), NT threads a block
constexpr int HB = 4, RI = 16, P = 8, G = 32 / P, NT = HB * N / RI * P, NW = NT / 32;
static_assert(P * 8 == N && G % HB == 0 && NT % 32 == 0, "launch shape");

// the sum over the P neighbouring lanes that hold one state row's columns
__device__ __forceinline__ float row_sum(float v) { return lanes_sum<P>(v); }

// the sum over a head's row groups of a value that each group's P lanes
// hold alike: the warp's groups of that head (lane group g holds head g % HB)
// by shuffles, then the block's warps through shared memory
__device__ __forceinline__ float head_sum(float v, float* red) {
#pragma unroll
  for (int o = P * HB; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (NW > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // red may still be read from the previous call
    if (lane % P == 0 && lane / P < HB) red[warp * HB + lane / P] = v;
    __syncthreads();
    v = 0.0f;
#pragma unroll
    for (int q = 0; q < NW; ++q) v += red[q * HB + lane / P % HB];
  }
  return v;
}

template <typename TA, typename TS, bool BF>
__global__ void __launch_bounds__(NT) wkv7_step_fused_kernel(
    TS* __restrict__ state, const TA* __restrict__ r, const TA* __restrict__ w,
    const TA* __restrict__ k, const TA* __restrict__ a, const TA* __restrict__ v,
    const TA* __restrict__ k_k, const TA* __restrict__ k_a, const TA* __restrict__ r_k,
    const TA* __restrict__ ln_w, const TA* __restrict__ ln_b,
    const int32_t* __restrict__ elapsed, const int32_t* __restrict__ lengths,
    TA* __restrict__ y, int B, int C, int layer, int use_dither, int ld_r, int ld_w,
    int ld_k, int ld_a, int ld_v) {
  __shared__ float red[NW * HB];
  const int b = blockIdx.y, tid = threadIdx.x;
  // lane group gi of the block: head slot gi % HB, rows i0 .. i0 + RI - 1;
  // each lane columns 8 part .. 8 part + 7
  const int gi = tid / P, part = tid % P, i0 = gi / HB * RI;
  const int h = blockIdx.x * HB + gi % HB, H = C / N;
  const bool hv = h < H;  // a slot past the last head computes, stores nothing
  const int c0 = (hv ? h : H - 1) * N;  // the head's first channel
  TA* yh = y + (size_t)b * C + c0;
  if (lengths[b] <= 0) {  // an idle row: its state is neither read nor written
    const int first = blockIdx.x * HB * N;  // the block's first channel
    for (int q = tid; q < HB * N && first + q < C; q += NT)
      y[(size_t)b * C + first + q] = from_f32<TA>(0.0f);
    return;
  }

  // the state rows first: their DRAM latency overlaps the prologue
  TS* srow = state + (((size_t)layer * B + b) * N + i0) * C + c0 + 8 * part;
  Raw8<TS> raw[RI];
#pragma unroll
  for (int q = 0; q < RI; ++q) load_raw(srow + (size_t)q * C, raw[q]);

  // prologue on this thread's 8 columns j (the row's P lanes hold the head)
  const int cj = c0 + 8 * part;
  float rr[8], wr[8], kr[8], ar[8], kkp[8], kap[8], rkp[8], vv[RI];
  load8_any(r + (size_t)b * ld_r + cj, rr);
  load8_any(w + (size_t)b * ld_w + cj, wr);
  load8_any(k + (size_t)b * ld_k + cj, kr);
  load8_any(a + (size_t)b * ld_a + cj, ar);
  load8_any(k_k + cj, kkp);
  load8_any(k_a + cj, kap);
  load8_any(r_k + cj, rkp);
  const TA* vh = v + (size_t)b * ld_v + c0 + i0;  // v_i of this thread's rows
  if constexpr (RI % 8 == 0) {
#pragma unroll
    for (int q = 0; q < RI; q += 8) load8_any(vh + q, *reinterpret_cast<float(*)[8]>(vv + q));
  } else {
#pragma unroll
    for (int q = 0; q < RI; ++q) vv[q] = to_f32(vh[q]);
  }
  const unsigned int step = (unsigned int)elapsed[b];

  float kp[8], kt[8], ss = 0.0f, bs = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    kp[e] = kr[e] * kkp[e];
    ss += kp[e] * kp[e];
    kt[e] = kr[e] * (1.0f + (ar[e] - 1.0f) * kap[e]);
    bs += rr[e] * kt[e] * rkp[e];
  }
  const float inv = 1.0f / fmaxf(sqrtf(row_sum(ss)), 1e-12f);
  const float bonus = row_sum(bs);
  float yv[RI];
  if constexpr (BF) {
    static_assert(sizeof(TS) == 2, "precision bf16 runs on a bf16 state");
    // this thread's 4 column pairs of -kk, b = kk*a, k~, d = d1 - 1 and d1*r,
    // each rounded to bf16; the head's <r, k~> and <r, b> in float32
    uint32_t a2[4], b2[4], k2[4], d2[4], dr2[4];
    float rk = 0.0f, rb = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const float d1x = 1.0f + decay(wr[e], step, use_dither);
      const float d1y = 1.0f + decay(wr[e + 1], step, use_dither);
      const float kx = kp[e] * inv, ky = kp[e + 1] * inv;
      const float bx = kx * ar[e], by = ky * ar[e + 1];
      a2[e / 2] = pack2(-kx, -ky);
      b2[e / 2] = pack2(bx, by);
      k2[e / 2] = pack2(kt[e], kt[e + 1]);
      d2[e / 2] = pack2(d1x - 1.0f, d1y - 1.0f);
      dr2[e / 2] = pack2(d1x * rr[e], d1y * rr[e + 1]);
      rk += rr[e] * kt[e] + rr[e + 1] * kt[e + 1];
      rb += rr[e] * bx + rr[e + 1] * by;
    }
    rk = row_sum(rk);
    rb = row_sum(rb);
    // one row at a time: sa_i and the S-part of y_i from the old row, then
    // the delta update, stored at once (wkv7_common.cuh)
    rows_bf16<P, RI>(raw, srow, C, a2, b2, k2, d2, dr2, rk, rb, vv, yv, hv);
  } else {
    float d1[8], na[8], nb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      d1[e] = 1.0f + decay(wr[e], step, use_dither);
      na[e] = -(kp[e] * inv);
      nb[e] = kp[e] * inv * ar[e];
    }
    // the recurrence, one row at a time (wkv7_common.cuh; shared with the
    // bare kernel's T = 1 path)
    rows_f32<P, RI>(raw, srow, C, d1, na, kt, nb, rr, vv, yv, hv);
  }

  // epilogue: per-head GroupNorm (eps 64e-5) over the 64 rows, plus the bonus
  float sy = 0.0f;
#pragma unroll
  for (int q = 0; q < RI; ++q) sy += yv[q];
  const float mu = head_sum(sy, red) * (1.0f / N);
  float sd = 0.0f;
#pragma unroll
  for (int q = 0; q < RI; ++q) sd += (yv[q] - mu) * (yv[q] - mu);
  const float rs = rsqrtf(head_sum(sd, red) * (1.0f / N) + 64e-5f);
  // lane `part` of a row group writes its rows i0 + q with q % P == part
#pragma unroll
  for (int q = 0; q < RI; ++q) {
    if (q % P != part || !hv) continue;
    const int i = i0 + q;
    yh[i] = from_f32<TA>((yv[q] - mu) * rs * to_f32(ln_w[c0 + i]) + to_f32(ln_b[c0 + i]) +
                         bonus * vv[q]);
  }
}

template <typename TA, typename TS, bool BF>
int launch(void* state, const void* r, const void* w, const void* k, const void* a,
           const void* v, const void* k_k, const void* k_a, const void* r_k,
           const void* ln_w, const void* ln_b, const void* elapsed, const void* lengths,
           void* y, int B, int C, int layer, int use_dither, const int* ld,
           cudaStream_t stream) {
  wkv7_step_fused_kernel<TA, TS, BF><<<dim3((C / N + HB - 1) / HB, B), NT, 0, stream>>>(
      (TS*)state, (const TA*)r, (const TA*)w, (const TA*)k, (const TA*)a, (const TA*)v,
      (const TA*)k_k, (const TA*)k_a, (const TA*)r_k, (const TA*)ln_w, (const TA*)ln_b,
      (const int32_t*)elapsed, (const int32_t*)lengths, (TA*)y, B, C, layer, use_dither, ld[0],
      ld[1], ld[2], ld[3], ld[4]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. ld_*: row strides (elements) of the
// (B, C) inputs r, w, k, a, v, whose columns are contiguous; the state is
// 16-byte aligned. bf16_mode: precision="bf16", on a bf16 state only (a
// float32 state runs the float32 update, as the JAX package does).
// heads_per_block .. threads: the launch the wrapper's plan
// (wkv7_cuda.step_plan) describes, refused with ERR_PLAN unless it is this
// file's. Returns the launch's error code.
extern "C" int wkv7_step_fused(void* state, const void* r, const void* w, const void* k,
                               const void* a, const void* v, const void* k_k,
                               const void* k_a, const void* r_k, const void* ln_w,
                               const void* ln_b, const void* elapsed, const void* lengths,
                               void* y, int B, int C, int layer, int use_dither, int ld_r,
                               int ld_w, int ld_k, int ld_a, int ld_v, int act_dtype,
                               int state_dtype, int bf16_mode, int heads_per_block,
                               int rows_per_thread,
                               int threads_per_row, int threads, void* stream) {
  if (heads_per_block != HB || rows_per_thread != RI || threads_per_row != P || threads != NT)
    return hopper::ERR_PLAN;
  cudaStream_t s = (cudaStream_t)stream;
  const int ld[5] = {ld_r, ld_w, ld_k, ld_a, ld_v};
#define WKV7_STEP_DISPATCH(TA, TS, BF)                                                      \
  return launch<TA, TS, BF>(state, r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed, lengths, \
                            y, B, C, layer, use_dither, ld, s)
  if (bf16_mode && state_dtype == 1) {
    if (act_dtype == 1) WKV7_STEP_DISPATCH(__nv_bfloat16, __nv_bfloat16, true);
    WKV7_STEP_DISPATCH(float, __nv_bfloat16, true);
  }
  if (act_dtype == 1 && state_dtype == 1) WKV7_STEP_DISPATCH(__nv_bfloat16, __nv_bfloat16, false);
  if (act_dtype == 1 && state_dtype == 0) WKV7_STEP_DISPATCH(__nv_bfloat16, float, false);
  if (act_dtype == 0 && state_dtype == 1) WKV7_STEP_DISPATCH(float, __nv_bfloat16, false);
  WKV7_STEP_DISPATCH(float, float, false);
#undef WKV7_STEP_DISPATCH
}

extern "C" const char* wkv7_step_error_string(int code) { return hopper::error_string(code); }

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
// precision="bf16" on a bf16 state (the BF instances; the JAX package's
// _token_update_pre with bf16_state): S stays bf16 in registers and is
// rounded every token; the update takes the delta form with every
// elementwise operation a bf16 one rounded to nearest (wkv7_common.cuh),
//   S_ij <- S_ij + ((S_ij * d_j + v_i * k~_j) + sa_i * b_j),  d = d1 - 1,
//   y_i   = sum_j S_ij * bf16(d1_j r_j) + v_i <r, k~> + sa_i <r, b>,
// sa_i and y_i float32 sums of bf16 products of the old S. Phase A then
// stores the rows the recurrence reads as bf16 (half the shared-memory
// traffic a token) and the two per-head sums <r, k~>, <r, b>. The token
// (bf16_token_rows) is wkv7_common.cuh's, shared with the bare kernel's
// bf16 mode at T > 1 (wkv7_batch.cu).
//
// Bound on the H100: the arithmetic. A token costs ~9 float32 operations per
// state element (64 * C per request), 4.8 GFLOP for a layer of 2,048 prompt
// tokens at C 4096, ~0.07 ms at 67 TFLOP/s; its bytes (the state slab once
// each way, five input rows and one output row per token) take about half
// that. What the recurrence adds is latency: each token depends on the last,
// so a chunk cannot take less than its longest row's tokens times the time
// of one token of the chain (the serial floor, which chip_smoke.py measures).
// At 8 requests and more the card runs several blocks an SM, and what limits
// a token is its traffic through shared memory: every thread reads the
// token's row vectors for its columns, so the reads a token scale with the
// threads that share a column (measured on the H100 with launch shapes that
// split the state differently).
//
// Design: one block of 128 threads per (head, request): RI = 4 state rows a
// thread and P = 8 threads a row (wkv7_cuda.chunk_plan describes the launch;
// of nine shapes with 1-4 rows a thread, 2-8 threads a row and 8-32 tokens a
// tile, this one was the fastest or within the spread at every prefill
// variant on the H100). A row's P threads are neighbouring lanes, each
// holding 64 / P of its columns (float4 groups p, p + P, ... so that they
// read neighbouring banks) for RI rows, in registers for the whole chunk, so
// the slab crosses device memory once each way and each vector element read
// from shared memory serves RI rows. The chunk goes in tiles of TT = 16
// tokens (a shorter chunk leaves the tile part empty):
//   copies. A tile's inputs (each token's 64-element head segment of r, w,
//      k, a and v; r, k, v are strided views of the merged R/K/V output)
//      arrive by 16-byte cp.async copies, spread over every thread, into a
//      double-buffered shared-memory ring. Tile t + 2's copies go out as
//      soon as tile t's phase A has read its stage, so they overlap tile t's
//      recurrence. (1-D cp.async.bulk copies of the 128-byte rows, issued by
//      one warp, serialised in the copy unit and held that warp up.)
//   A. everything that does not depend on S, from shared memory, eight lanes
//      a token (8 channels each, 4 tokens a warp at once); the per-head sums
//      (the kk norm, the bonus) are shuffles within the eight. The rows the
//      recurrence reads (d1, k~, -kk, kk*a, r, v) are stored as float32.
//   B. the serial recurrence: per token, each thread takes its part of
//      sa_i = sum_j -kk_j S_ij for its rows, the row's P threads join it
//      with __shfl_xor (every one gets the same bits), update their columns
//      and join y_i the same way.
//   C. GroupNorm and the bonus, token-parallel again as in A, 8 channels a
//      lane stored at once.
// The block synchronises three times per tile. Shared memory: 7 float32
// arrays of (TT, 64), TT bonus values, the head's 5 parameter vectors, a ring
// of 2 x 5 x (TT, 64) inputs (50,496 bytes with bf16 inputs, 70,976 with
// float32: dynamic, above the 48 KB default, allowed at every launch).

#include <type_traits>

#include "hopper_common.cuh"
#include "wkv7_common.cuh"

namespace {

using namespace wkv7;
using hopper::smem_u32;

// the five (B, T, C) input rows r, w, k, a, v (columns contiguous): base
// pointers and element strides per request and per token
struct Rows {
  const void* p[5];
  int b[5], t[5];
};

// the four columns 4g..4g+3 of a state row
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the launch: RI state rows a thread, P threads a state row, TT tokens a
// tile, NT threads a block
constexpr int RI = 4, P = 8, TT = 16, NT = N / RI * P;

// shared-memory bytes of a block: 7 float32 (TT, 64) arrays, TT bonus
// values (and, for precision="bf16", TT of <r, k~> and of <r, b>), the
// head's 5 parameter vectors in float32, the ring of 2 x 5 x (TT, 64)
// inputs (every array a multiple of 16 bytes: the ring's 16-byte copies)
template <typename TA, bool BF>
constexpr int smem_bytes() {
  return (7 * TT * N + (BF ? 3 : 1) * TT + 5 * N) * 4 + 10 * TT * N * (int)sizeof(TA);
}

// phases A and C: a token's 64 channels on LG lanes of 8 channels each, 32 /
// LG tokens a warp at once; the per-head sums over the LG lanes
constexpr int LG = 8;
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < LG; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the P neighbouring lanes that hold one state row's columns;
// every one of them gets the same bits (a butterfly of commutative adds)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TA, typename TS, bool BF>
__global__ void __launch_bounds__(NT) wkv7_chunk_fused_kernel(
    TS* __restrict__ state, const Rows rows, const TA* __restrict__ k_k,
    const TA* __restrict__ k_a, const TA* __restrict__ r_k, const TA* __restrict__ ln_w,
    const TA* __restrict__ ln_b, const int32_t* __restrict__ elapsed,
    const int32_t* __restrict__ lengths, TA* __restrict__ y, int B, int T, int C, int layer,
    int use_dither) {
  constexpr int NW = NT / 32;   // warps
  constexpr int G = N / 4 / P;  // float4 column groups a thread holds of each of its rows
  static_assert(NT % 32 == 0 && 32 % P == 0 && N % RI == 0 && TT % 4 == 0, "launch shape");
  static_assert(!BF || sizeof(TS) == 2, "precision bf16 runs on a bf16 state");
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_d1 = reinterpret_cast<float*>(smem);
  float *s_k = s_d1 + TT * N, *s_a = s_k + TT * N, *s_b = s_a + TT * N;
  float *s_r = s_b + TT * N, *s_v = s_r + TT * N, *s_y = s_v + TT * N;
  float* s_bonus = s_y + TT * N;
  // precision="bf16": <r, k~> and <r, b> a token; d, k~, -kk, b and d1*r as
  // bf16 in the first half of s_d1, s_k, s_a, s_b and s_r
  [[maybe_unused]] float *s_rk = s_bonus + TT, *s_rb = s_rk + TT;
  float* s_par = s_bonus + (BF ? 3 : 1) * TT;  // k_k, k_a, r_k, ln_w, ln_b of the head
  TA* ring = reinterpret_cast<TA*>(s_par + 5 * N);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i0 = tid / P * RI, part = tid % P;  // rows i0 .. i0 + RI - 1
  const int n_tok = min(max(lengths[b], 0), T);
  const int n_tiles = (n_tok + TT - 1) / TT;
  // phases A and C: lane group `grp` of a warp takes a token, each lane
  // channels ch .. ch + 7 of the head
  constexpr int TPW = 32 / LG;
  const int grp = lane / LG, ch = lane % LG * 8;
  const unsigned int el = (unsigned int)elapsed[b];
  for (int q = tid; q < N; q += NT) {  // read after the first tile's barrier
    s_par[q] = to_f32(k_k[h * N + q]);
    s_par[N + q] = to_f32(k_a[h * N + q]);
    s_par[2 * N + q] = to_f32(r_k[h * N + q]);
    s_par[3 * N + q] = to_f32(ln_w[h * N + q]);
    s_par[4 * N + q] = to_f32(ln_b[h * N + q]);
  }

  // tile `tile`'s rows of r, w, k, a, v into ring stage tile & 1, 16 bytes
  // a copy spread over every thread; one group per tile in every thread
  // (empty past the last tile), so "all but one" is always this tile's
  auto issue = [&](int tile) {
    constexpr int PIECES = N * sizeof(TA) / 16;  // copies a 64-element row
    const int s = tile & 1, t0 = tile * TT, n = max(min(TT, n_tok - t0), 0) * PIECES;
#pragma unroll
    for (int in = 0; in < 5; ++in) {
      const uint8_t* src = static_cast<const uint8_t*>(rows.p[in]) +
                           ((size_t)b * rows.b[in] + (size_t)t0 * rows.t[in] + h * N) * sizeof(TA);
      const uint32_t dst = smem_u32(ring + (s * 5 + in) * TT * N);
      for (int q = tid; q < n; q += NT) {
        const int tt = q / PIECES, piece = q % PIECES;
        copy16(dst + (tt * N * sizeof(TA) + 16 * piece),
               src + ((size_t)tt * rows.t[in] * sizeof(TA) + 16 * piece));
      }
    }
    copy_commit();
  };
  issue(0);
  issue(1);

  TS* srow = state + (((size_t)layer * B + b) * N + i0) * C + h * N;
  // four columns of a row: float32, or two packed bf16 pairs (BF)
  std::conditional_t<BF, uint2, float4> S[RI][G];
  if (n_tok > 0) {
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if constexpr (BF)
          S[r][g] = *reinterpret_cast<const uint2*>(srow + (size_t)r * C + 4 * (g * P + part));
        else
          S[r][g] = load4(srow + (size_t)r * C + 4 * (g * P + part));
      }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile & 1, t0 = tile * TT, nt = min(TT, n_tok - t0);
    copy_wait<1>();  // all but the next tile's group
    __syncthreads();  // this tile's rows from every thread; C of the last is done

    // A: the S-independent prologue from the staged rows, TPW tokens a warp
    // at once (every lane takes part in the group sums; a group past nt
    // reads a valid token and stores nothing)
    const TA* st = ring + s * 5 * TT * N + ch;
    for (int base = warp * TPW; base < nt; base += NW * TPW) {
      const int tt = base + grp, tq = tt < nt ? tt : base;
      float rr[8], wr[8], kr[8], ar[8], vr[8], kkp[8], kap[8], rkp[8];
      load8(st + tq * N, rr);
      load8(st + (TT + tq) * N, wr);
      load8(st + (2 * TT + tq) * N, kr);
      load8(st + (3 * TT + tq) * N, ar);
      load8(st + (4 * TT + tq) * N, vr);
      load8(s_par + ch, kkp);
      load8(s_par + N + ch, kap);
      load8(s_par + 2 * N + ch, rkp);
      float kp[8], kt[8], ss = 0.0f, bs = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kp[e] = kr[e] * kkp[e];
        ss += kp[e] * kp[e];
        kt[e] = kr[e] * (1.0f + (ar[e] - 1.0f) * kap[e]);
        bs += rr[e] * kt[e] * rkp[e];
      }
      const float inv = 1.0f / fmaxf(sqrtf(group_sum(ss)), 1e-12f);
      const float bonus = group_sum(bs);
      if constexpr (BF) {
        float rk = 0.0f, rb = 0.0f, nb[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          nb[e] = kp[e] * inv * ar[e];
          rk += rr[e] * kt[e];
          rb += rr[e] * nb[e];
        }
        rk = group_sum(rk);
        rb = group_sum(rb);
        if (tt < nt) {
          const unsigned int step = el + (unsigned int)(t0 + tt);
          const int o = tt * N + ch;
          uint32_t d2[4], k2[4], a2[4], b2[4], r2[4];
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const float d1x = 1.0f + decay(wr[e], step, use_dither);
            const float d1y = 1.0f + decay(wr[e + 1], step, use_dither);
            d2[e / 2] = pack2(d1x - 1.0f, d1y - 1.0f);
            k2[e / 2] = pack2(kt[e], kt[e + 1]);
            a2[e / 2] = pack2(-(kp[e] * inv), -(kp[e + 1] * inv));
            b2[e / 2] = pack2(nb[e], nb[e + 1]);
            r2[e / 2] = pack2(d1x * rr[e], d1y * rr[e + 1]);
          }
          const auto put = [&](float* base, const uint32_t (&x)[4]) {
            *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(base) + o) =
                make_uint4(x[0], x[1], x[2], x[3]);
          };
          put(s_d1, d2);
          put(s_k, k2);
          put(s_a, a2);
          put(s_b, b2);
          put(s_r, r2);
          store8(s_v + o, vr);
          if (ch == 0) {
            s_bonus[tt] = bonus;
            s_rk[tt] = rk;
            s_rb[tt] = rb;
          }
        }
      } else if (tt < nt) {
        const unsigned int step = el + (unsigned int)(t0 + tt);
        const int o = tt * N + ch;
        float d1[8], na[8], nb[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          d1[e] = 1.0f + decay(wr[e], step, use_dither);
          na[e] = -(kp[e] * inv);
          nb[e] = kp[e] * inv * ar[e];
        }
        store8(s_d1 + o, d1);
        store8(s_k + o, kt);
        store8(s_a + o, na);
        store8(s_b + o, nb);
        store8(s_r + o, rr);
        store8(s_v + o, vr);
        if (ch == 0) s_bonus[tt] = bonus;
      }
    }
    __syncthreads();
    // stage s is read: tile + 2's copies overlap this tile's recurrence
    issue(tile + 2);

    // B: the recurrence; each thread holds G column groups of RI rows, the
    // row's P threads join its sums
    if constexpr (BF) {
      const uint2 *ha = reinterpret_cast<const uint2*>(s_a) + part,
                  *hd = reinterpret_cast<const uint2*>(s_d1) + part,
                  *hk = reinterpret_cast<const uint2*>(s_k) + part,
                  *hb = reinterpret_cast<const uint2*>(s_b) + part,
                  *hr = reinterpret_cast<const uint2*>(s_r) + part;
      for (int tt = 0; tt < nt; ++tt) {
        const int o = tt * N / 4;  // a token's 64 bf16 as uint2
        bf16_token_rows<RI, G, P>(S, ha + o, hd + o, hk + o, hb + o, hr + o,
                                  s_v + tt * N + i0, s_rk[tt], s_rb[tt], s_y + tt * N + i0,
                                  part);
      }
    } else  // the float32 recurrence
    for (int tt = 0; tt < nt; ++tt) {
      const float4* a4 = reinterpret_cast<const float4*>(s_a + tt * N) + part;
      float4 f[G];
#pragma unroll
      for (int g = 0; g < G; ++g) f[g] = a4[g * P];
      float sa[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          p0 += f[g].x * S[r][g].x;
          p1 += f[g].y * S[r][g].y;
          p2 += f[g].z * S[r][g].z;
          p3 += f[g].w * S[r][g].w;
        }
        sa[r] = (p0 + p1) + (p2 + p3);
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) sa[r] = row_sum(sa[r]);
      float vi[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) vi[r] = s_v[tt * N + i0 + r];
      const float4 *d4 = reinterpret_cast<const float4*>(s_d1 + tt * N) + part,
                   *k4 = reinterpret_cast<const float4*>(s_k + tt * N) + part,
                   *b4 = reinterpret_cast<const float4*>(s_b + tt * N) + part,
                   *r4 = reinterpret_cast<const float4*>(s_r + tt * N) + part;
      float y0[RI], y1[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) y0[r] = y1[r] = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 fd = d4[g * P], fk = k4[g * P], fb = b4[g * P], fr = r4[g * P];
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          float4& q = S[r][g];
          q.x = q.x * fd.x + vi[r] * fk.x + sa[r] * fb.x;
          q.y = q.y * fd.y + vi[r] * fk.y + sa[r] * fb.y;
          q.z = q.z * fd.z + vi[r] * fk.z + sa[r] * fb.z;
          q.w = q.w * fd.w + vi[r] * fk.w + sa[r] * fb.w;
          y0[r] += q.x * fr.x + q.z * fr.z;
          y1[r] += q.y * fr.y + q.w * fr.w;
        }
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const float yi = row_sum(y0[r] + y1[r]);
        if (part == 0) s_y[tt * N + i0 + r] = yi;
      }
    }
    __syncthreads();

    // C: per-head GroupNorm (eps 64e-5) and the bonus, TPW tokens a warp at
    // once as in A, 8 channels a lane stored at once
    for (int base = warp * TPW; base < nt; base += NW * TPW) {
      const int tt = base + grp, tq = tt < nt ? tt : base;
      float yv[8], vv[8], lw[8], lb[8];
      load8(s_y + tq * N + ch, yv);
      load8(s_v + tq * N + ch, vv);
      load8(s_par + 3 * N + ch, lw);
      load8(s_par + 4 * N + ch, lb);
      float sy = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sy += yv[e];
      const float mu = group_sum(sy) * (1.0f / N);
      float sd = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        yv[e] -= mu;
        sd += yv[e] * yv[e];
      }
      const float rs = rsqrtf(group_sum(sd) * (1.0f / N) + 64e-5f);
      const float bonus = s_bonus[tq];
#pragma unroll
      for (int e = 0; e < 8; ++e) yv[e] = yv[e] * rs * lw[e] + lb[e] + bonus * vv[e];
      if (tt < nt) store8(y + ((size_t)b * T + t0 + tt) * C + h * N + ch, yv);
    }
  }
  if (n_tok > 0) {
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if constexpr (BF)
          *reinterpret_cast<uint2*>(srow + (size_t)r * C + 4 * (g * P + part)) = S[r][g];
        else
          store4(srow + (size_t)r * C + 4 * (g * P + part), S[r][g]);
      }
  }
  // zeros past the row's length, 16 bytes a store
  constexpr int PER = N * sizeof(TA) / 16;
  for (int q = tid; q < (T - n_tok) * PER; q += NT) {
    const int t = n_tok + q / PER;
    *reinterpret_cast<uint4*>(y + ((size_t)b * T + t) * C + h * N + (q % PER) * (16 / sizeof(TA))) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename TA, typename TS, bool BF>
int launch(void* state, const Rows& rows, const void* k_k, const void* k_a, const void* r_k,
           const void* ln_w, const void* ln_b, const void* elapsed, const void* lengths,
           void* y, int B, int T, int C, int layer, int use_dither, cudaStream_t stream) {
  const auto kernel = wkv7_chunk_fused_kernel<TA, TS, BF>;
  // per device, and cheap beside a launch: set before every one
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem_bytes<TA, BF>());
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(C / N, B), NT, smem_bytes<TA, BF>(), stream>>>(
      (TS*)state, rows, (const TA*)k_k, (const TA*)k_a, (const TA*)r_k, (const TA*)ln_w,
      (const TA*)ln_b, (const int32_t*)elapsed, (const int32_t*)lengths, (TA*)y, B, T, C,
      layer, use_dither);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. sb_*, st_*: element strides per
// request and per token of the (B, T, C) inputs r, w, k, a, v, whose columns
// are contiguous and whose rows start on 16-byte boundaries; y is a
// contiguous (B, T, C). bf16_mode: precision="bf16", on a bf16 state only (a
// float32 state runs the float32 update, as the JAX package does). Returns
// cudaGetLastError().
extern "C" int wkv7_chunk_fused(void* state, const void* r, const void* w, const void* k,
                                const void* a, const void* v, const void* k_k,
                                const void* k_a, const void* r_k, const void* ln_w,
                                const void* ln_b, const void* elapsed, const void* lengths,
                                void* y, int B, int T, int C, int layer, int use_dither,
                                int sb_r, int st_r, int sb_w, int st_w, int sb_k, int st_k,
                                int sb_a, int st_a, int sb_v, int st_v, int act_dtype,
                                int state_dtype, int bf16_mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Rows rows = {{r, w, k, a, v},
                     {sb_r, sb_w, sb_k, sb_a, sb_v},
                     {st_r, st_w, st_k, st_a, st_v}};
#define WKV7_CHUNK_DISPATCH(TA, TS, BF)                                                       \
  return launch<TA, TS, BF>(state, rows, k_k, k_a, r_k, ln_w, ln_b, elapsed, lengths, y, B, T, \
                            C, layer, use_dither, s)
  if (bf16_mode && state_dtype == 1) {
    if (act_dtype == 1) WKV7_CHUNK_DISPATCH(__nv_bfloat16, __nv_bfloat16, true);
    WKV7_CHUNK_DISPATCH(float, __nv_bfloat16, true);
  }
  if (act_dtype == 1 && state_dtype == 1) WKV7_CHUNK_DISPATCH(__nv_bfloat16, __nv_bfloat16, false);
  if (act_dtype == 1 && state_dtype == 0) WKV7_CHUNK_DISPATCH(__nv_bfloat16, float, false);
  if (act_dtype == 0 && state_dtype == 1) WKV7_CHUNK_DISPATCH(float, __nv_bfloat16, false);
  WKV7_CHUNK_DISPATCH(float, float, false);
#undef WKV7_CHUNK_DISPATCH
}

extern "C" const char* wkv7_chunk_error_string(int code) { return hopper::error_string(code); }

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
// Bound on the H100: device memory. What the function must move is the
// logits, occ and pres read once, occ written back on decaying rows (the
// only ones where it changes) and pres at the one hit column: 14 bytes per
// (row, column) at bf16 logits where every row decays. The arithmetic is a
// handful of flops and one exp per element.
//
// Design: each row is split over the `split` CTAs (at most 8) of a
// thread-block cluster, each owning a contiguous run of whole 128-column
// chunks (sampling_cuda.tail_plan: 2 to 8 CTAs a row up to batch 128, about
// one CTA an SM in all, so batch 64 runs 128 CTAs, not 64). A warp takes
// U = 4 chunks at a time and issues all their loads before it uses any:
// each lane holds 4 consecutive columns, one 16-byte load each of occ and
// pres and one 8-byte load of bf16 logits a chunk. Per chunk, the lane's maximum and first argmax in ascending column
// order (strict >), then shuffles that keep the lower column on ties, give
// cval and cidx; an online (max, sum-exp) pair runs over the warp's chunks
// and is merged over the CTA's warps, then over the cluster: every CTA
// writes its pair into rank 0's shared memory (distributed shared memory,
// after a cluster barrier that CTA 0 has started), and rank 0 merges them in
// rank order and writes lse. occ is written only on decaying rows, pres only
// at the hit column. adj uses round-to-nearest intrinsics in the reference's
// operation order, so occ, pres, cval and cidx match the plain version bit
// for bit. Rows of a V that is not a multiple of 4, or pointers off 16 bytes,
// take the same path with one load an element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int CHUNK = 128;
constexpr int PT = 256, NW = PT / 32;  // threads a CTA, warps
constexpr int U = 4;                   // chunks a warp has in flight
constexpr int MAX_SPLIT = 8;           // the portable cluster size

// (m, s) <- online merge of a partial sum-exp s2 taken relative to m2
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  const float nm = fmaxf(m, m2);
  s = s * expf(m - nm) + s2 * expf(m2 - nm);
  m = nm;
}

// 4 consecutive columns: one vector load (VEC), else one element at a time
// (those past V read as `pad`)
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int col, int V, float pad, float (&v)[4]) {
  if constexpr (VEC) {
    const float4 f = *reinterpret_cast<const float4*>(p + col);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = col + e < V ? p[col + e] : pad;
  }
}
template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int col, int V, float pad,
                                      float (&v)[4]) {
  if constexpr (VEC) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + col);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = col + e < V ? __bfloat162float(p[col + e]) : pad;
  }
}

template <typename TL, bool VEC>
__global__ void __launch_bounds__(PT) penalty_tail_kernel(
    const TL* __restrict__ logits, float* __restrict__ occ, float* __restrict__ pres,
    const float* __restrict__ decay, const float* __restrict__ freq,
    const float* __restrict__ pp, const int32_t* __restrict__ last,
    const uint8_t* __restrict__ upd, const uint8_t* __restrict__ dec,
    float* __restrict__ cval, int32_t* __restrict__ cidx, float* __restrict__ lse, int V,
    int split, int per_cta) {
  __shared__ float red_m[NW], red_s[NW];
  __shared__ float part_m[MAX_SPLIT], part_s[MAX_SPLIT];  // rank 0's: every CTA's pair
  // every CTA of the cluster has started before any writes into rank 0's
  // shared memory: arrive now, wait before that write
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  const int b = blockIdx.x / split, rank = blockIdx.x % split;  // 1-D clusters of `split`
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (V + CHUNK - 1) / CHUNK;
  const int c_end = min((rank + 1) * per_cta, n_chunks);
  const float dcy = decay[b], fq = freq[b], ppen = pp[b];
  const int lt = upd[b] ? last[b] : -1;
  const bool dd = dec[b] != 0;
  const float* orow = occ + (size_t)b * V;
  const float* prow = pres + (size_t)b * V;
  const TL* lrow = logits + (size_t)b * V;

  float run_m = -INFINITY, run_s = 0.0f;
  for (int c0 = rank * per_cta + warp * U; c0 < c_end; c0 += NW * U) {
    // the loads of U chunks first
    float o[U][4], p[U][4], lg[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = (c0 + u) * CHUNK + 4 * lane;
      if (c0 + u < c_end && col < V) {
        load4<VEC>(orow, col, V, 0.0f, o[u]);
        load4<VEC>(prow, col, V, 0.0f, p[u]);
        load4<VEC>(lrow, col, V, 0.0f, lg[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ch = c0 + u;
      if (ch >= c_end) break;  // the same for every lane
      const int col = ch * CHUNK + 4 * lane;
      float adj[4], best = -INFINITY;
      int best_i = col;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = col + e;
        adj[e] = -INFINITY;
        if (cc < V) {
          const bool hit = cc == lt;
          float oe = o[u][e];
          if (dd) oe = __fmul_rn(__fadd_rn(oe, hit ? 1.0f : 0.0f), dcy);
          o[u][e] = oe;
          const float pe = hit ? ppen : p[u][e];
          adj[e] = __fsub_rn(__fsub_rn(lg[u][e], pe), __fmul_rn(oe, fq));
        }
        if (e == 0 || adj[e] > best) {  // columns rise with e: strict > keeps the lowest
          best = adj[e];
          best_i = cc;
        }
      }
      if (dd && col < V) {
        float* dst = occ + (size_t)b * V + col;
        if constexpr (VEC) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[u][0], o[u][1], o[u][2], o[u][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < V) dst[e] = o[u][e];
        }
      }
      if (lt >= col && lt < col + 4 && lt < V) pres[(size_t)b * V + lt] = ppen;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (ov > best || (ov == best && oi < best_i)) {
          best = ov;
          best_i = oi;
        }
      }
      float cs = 0.0f;
      if (best != -INFINITY) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cs += expf(adj[e] - best);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cs += __shfl_xor_sync(0xffffffffu, cs, off);
      if (lane == 0) {
        cval[(size_t)b * n_chunks + ch] = best;
        cidx[(size_t)b * n_chunks + ch] = best_i;
        lse_merge(run_m, run_s, best, cs);
      }
    }
  }
  if (lane == 0) {
    red_m[warp] = run_m;
    red_s[warp] = run_s;
  }
  __syncthreads();
  float m = -INFINITY, s = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NW; ++i) lse_merge(m, s, red_m[i], red_s[i]);
  }
  if (split == 1) {
    if (threadIdx.x == 0) lse[b] = m + logf(s);
    return;
  }
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if (threadIdx.x == 0) {  // this CTA's pair into rank 0's shared memory
    uint32_t dm, ds;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dm) : "r"(hopper::smem_u32(&part_m[rank])), "r"(0));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(ds) : "r"(hopper::smem_u32(&part_s[rank])), "r"(0));
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(dm), "f"(m) : "memory");
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(ds), "f"(s) : "memory");
  }
  hopper::cluster_sync();  // release the pairs; rank 0 acquires them
  if (rank == 0 && threadIdx.x == 0) {
    m = -INFINITY;
    s = 0.0f;
    for (int i = 0; i < split; ++i) lse_merge(m, s, part_m[i], part_s[i]);
    lse[b] = m + logf(s);
  }
}

template <typename TL, bool VEC>
int launch(const void* logits, void* occ, void* pres, const void* decay, const void* freq,
           const void* pp, const void* last, const void* upd, const void* dec, void* cval,
           void* cidx, void* lse, int B, int V, int split, int per_cta, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * B, 1, 1);
  cfg.blockDim = dim3(PT, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, penalty_tail_kernel<TL, VEC>, (const TL*)logits, (float*)occ, (float*)pres,
      (const float*)decay, (const float*)freq, (const float*)pp, (const int32_t*)last,
      (const uint8_t*)upd, (const uint8_t*)dec, (float*)cval, (int32_t*)cidx, (float*)lse, V,
      split, per_cta);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// logits_dtype: 0 = float32, 1 = bfloat16. upd/dec are bool (one byte each).
// The launch from the wrapper's plan (sampling_cuda.tail_plan or tail_shape):
// `split` CTAs a row in one cluster (1 to 8), each owning `per_cta` chunks of
// 128 columns (the last CTA the rest); `threads` and `in_flight` must be this
// file's PT and U. Returns the launch's error code (ERR_PLAN for a plan the
// kernel does not run).
extern "C" int penalty_tail(const void* logits, void* occ, void* pres, const void* decay,
                            const void* freq, const void* pp, const void* last,
                            const void* upd, const void* dec, void* cval, void* cidx,
                            void* lse, int B, int V, int logits_dtype, int split, int per_cta,
                            int threads, int in_flight, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads != PT || in_flight != U || split < 1 || split > MAX_SPLIT || per_cta < 1 ||
      (long long)split * per_cta * CHUNK < V || (long long)(split - 1) * per_cta * CHUNK >= V)
    return hopper::ERR_PLAN;
  const int esize = logits_dtype == 1 ? 2 : 4;
  const bool vec = V % 4 == 0 && ((uintptr_t)occ | (uintptr_t)pres) % 16 == 0 &&
                   (uintptr_t)logits % (4 * esize) == 0;
#define PENALTY_TAIL_LAUNCH(TL, VEC)                                                        \
  return launch<TL, VEC>(logits, occ, pres, decay, freq, pp, last, upd, dec, cval, cidx, lse, \
                         B, V, split, per_cta, s)
  if (logits_dtype == 1) {
    if (vec) PENALTY_TAIL_LAUNCH(__nv_bfloat16, true);
    PENALTY_TAIL_LAUNCH(__nv_bfloat16, false);
  }
  if (vec) PENALTY_TAIL_LAUNCH(float, true);
  PENALTY_TAIL_LAUNCH(float, false);
#undef PENALTY_TAIL_LAUNCH
}

extern "C" const char* penalty_tail_error_string(int code) {
  return hopper::error_string(code);
}

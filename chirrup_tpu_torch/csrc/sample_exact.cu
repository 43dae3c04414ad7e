// sample_exact_rows: the exact rwkv-pip draw for the rows that the
// candidate sampler flags, one cluster of SPLIT CTAs a row; a row whose flag
// is false returns at once.
//
// Replaces: chirrup_tpu/ops/sampling_pallas.py::sample_from_chunks's
//   fix_rows (the exact fallback: flagged rows gathered 8 at a time in an
//   on-device while_loop, their penalized logits rebuilt, then
//   chirrup_tpu/ops/sampling.py::sample_logits_rwkv_pip_compatible).
//
// Per flagged row b (need[b] true), with the tail's post-record state:
//   adj   = logits - pres2 - occ2 * freq[b]          (the tail's order)
//   p     = exp(adj - lse[b])                        (softmax; lse from the tail)
//   temperature 0 -> temperature 1, top_p 0 (greedy)
//   tau   = the probability at the first position of the descending order
//           where the cumulative sum reaches top_p (the last position when
//           it never does); every p < tau is dropped, ties with tau kept
//   top-k = the first top_k positions of the stable descending order (ties
//           to the lower token id) are kept, the rest dropped (top_k <= 0:
//           no cut)
//   token = argmax over kept p > 0 of log(p) / temperature + g[v] (the
//           lowest id on ties; 0 when nothing is kept), g Gumbel noise:
//           handed in (gumbel, (B, V) float32) or drawn here from a
//           counter-based generator (Philox4x32-10, key seeds[b], counter
//           v / 4, word v % 4: u = (x >> 9 + 0.5) 2^-23, g = -log(-log u)).
// tokens[b] is written for flagged rows only; the others keep the
// candidate sampler's token.
//
// Bound on the H100: device memory. A flagged row must read its logits
// and pres2 and occ2 once: 10 bytes a column at bf16 logits (64 rows at V
// 65,536: 42 MB, 12.5 us at 3.35 TB/s). With no flagged row the work is one
// launch of SPLIT * B CTAs that each read one flag.
//
// Design: no sort. A 65,536-wide float32 row (256 KB) does not fit in
// shared memory, so the first pass writes p to a (B, V) scratch row that
// stays in L2, and two radix selects over p's float bits (non-negative
// floats order as their bits) find tau and the top_k-th value, three
// digits each (11, 11 and 10 bits), one pass over the row a digit; the
// first pass also takes the first digit's histogram, and the top_k select
// reuses its counts, so a row takes 4 passes (6 with a top_k cut). A row is
// split over the SPLIT CTAs of a thread-block cluster, each owning a
// contiguous slice: every pass histograms its slice, and each CTA sums the
// cluster's histograms through distributed shared memory, so all CTAs of
// a row choose the same bins. A pass histograms the elements that match
// the prefix so far: per-bin counts and per-bin masses in 2^-48 fixed
// point, both integer, so the sums are exact and the same on every run.
// Most elements of a row fall in a few bins, so a thread sums its runs of
// elements in two bins in registers and adds one to shared memory when a
// third bin replaces it; at the end of the pass the warp sums its runs by
// bin (match_any, then redux over the 24-bit halves) and adds once a bin.
// The CTA then scans the bins from the top (two bins a thread, warp and
// block prefix sums) for the first bin where the mass (or the count)
// reaches the target. Every pass keeps 8 loads a thread in flight. The
// last pass walks each slice in index order: ties at the top_k-th value
// are ranked by a block-wide scan of their positions after the ties of
// the slices before it, and each CTA's best (score, id) is merged in rank
// 0 of the cluster. The fixed-point cumulative sum reaches top_p within
// 2^-48 a column of float32's: rows whose float32 cumulative sum lies
// within rounding of top_p at the cutoff may keep one more or one fewer
// value than a float32 sort would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int PT = 1024, NW = PT / 32;  // threads a CTA, warps (choose scans NW = 32)
constexpr int SPLIT = 4;                // CTAs a row: one cluster
constexpr int U = 8;                    // elements a thread has in flight
constexpr int TILE = U * PT;            // elements a CTA takes per iteration
constexpr int BINS = 2048;              // the widest digit: 11 bits
constexpr int NDIG = 3;  // digits of 11, 11 and 10 bits, from the top
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NEVER = ~0ull;  // a mass target no row reaches

__device__ __forceinline__ int dig_shift(int d) { return d == 0 ? 21 : d == 1 ? 10 : 0; }
__device__ __forceinline__ int dig_bits(int d) { return d == 2 ? 10 : 11; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// p in 2^-48 fixed point: exact for p >= 2^-24, rounded below
__device__ __forceinline__ unsigned long long fixed48(float p) {
  return __float2ull_rn(p * 0x1p48f);
}

// Philox4x32-10 (Salmon et al., SC'11) of counter (c0, 0, 0, 0) under key (k0, k1)
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t k0, uint32_t k1) {
  uint32_t x0 = c0, x1 = 0, x2 = 0, x3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * x0, hi0 = __umulhi(0xD2511F53u, x0);
    const uint32_t lo1 = 0xCD9E8D57u * x2, hi1 = __umulhi(0xCD9E8D57u, x2);
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(x0, x1, x2, x3);
}

__device__ __forceinline__ float philox_gumbel(int v, uint32_t k0, uint32_t k1) {
  const uint4 w = philox((uint32_t)(v >> 2), k0, k1);
  const uint32_t x = (v & 3) == 0 ? w.x : (v & 3) == 1 ? w.y : (v & 3) == 2 ? w.z : w.w;
  const float u = ((float)(x >> 9) + 0.5f) * 0x1p-23f;  // in (0, 1), exact
  return -logf(-logf(u));
}

struct Select {  // one radix select's state
  uint32_t prefix, mask;       // the digits chosen so far
  unsigned long long above_m;  // mass of the elements above the prefix's range
  uint32_t above_c;            // their count
  uint32_t bin_c;              // count of the chosen bin (after the last digit)
  int found;
};

struct Shared {
  uint32_t cnt[BINS];  // this CTA's histogram of its slice
  unsigned long long mass[BINS];
  uint32_t mcnt[BINS];  // the cluster's: the row's
  unsigned long long mmass[BINS];
  uint32_t cnt0[BINS];  // the first digit's counts over the whole row
  Select sel;
  uint32_t warp_c[NW];  // block scans
  unsigned long long warp_m[NW];
  int first;
  int tie_off[U * NW];
  int tie_total;
  float best_s[NW];
  int best_i[NW];
  uint32_t slice_ties;  // this slice's elements equal to the top_k-th value
  float rank_s[SPLIT];  // in rank 0: each CTA's best
  int rank_i[SPLIT];
};

// distributed shared memory: `p` in the shared memory of cluster rank `r`
__device__ __forceinline__ uint32_t at_rank(const void* p, uint32_t r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(hopper::smem_u32(p)), "r"(r));
  return a;
}
__device__ __forceinline__ uint32_t ld_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long ld_u64(uint32_t a) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void clear_bins(Shared& sh) {
  for (int i = threadIdx.x; i < BINS; i += PT) {
    sh.cnt[i] = 0;
    sh.mass[i] = 0;
  }
}

// A thread's runs of elements in two bins: counted (and with `with_mass`
// weighed) in registers, and added to the shared histogram when a third
// bin takes the place of the one used less recently, and by the warp at
// the end of a pass (flush). Most elements of a row share a few bins (the
// first digit's quarter-octaves, or the two on either side of a flat row's
// probability), which shared-memory atomics would otherwise serialize on.
struct Runs {
  int bin0 = BINS, bin1 = BINS;  // BINS: empty
  uint32_t c0 = 0, c1 = 0;
  unsigned long long m0 = 0, m1 = 0;
  bool last1 = false;  // entry 1 was used last
};

__device__ __forceinline__ void add_run(Shared& sh, int bin, uint32_t c, unsigned long long m,
                                        bool with_mass) {
  if (bin == BINS) return;
  atomicAdd(&sh.cnt[bin], c);
  if (with_mass) atomicAdd(&sh.mass[bin], m);
}

__device__ __forceinline__ void tally(Shared& sh, Runs& r, int bin, float x, bool with_mass) {
  const unsigned long long m = with_mass ? fixed48(x) : 0ull;
  if (bin == r.bin0) {
    ++r.c0;
    r.m0 += m;
    r.last1 = false;
  } else if (bin == r.bin1) {
    ++r.c1;
    r.m1 += m;
    r.last1 = true;
  } else if (r.last1) {  // entry 0 was used less recently
    add_run(sh, r.bin0, r.c0, r.m0, with_mass);
    r.bin0 = bin;
    r.c0 = 1;
    r.m0 = m;
    r.last1 = false;
  } else {
    add_run(sh, r.bin1, r.c1, r.m1, with_mass);
    r.bin1 = bin;
    r.c1 = 1;
    r.m1 = m;
    r.last1 = true;
  }
}

// Every lane: one run of each lane, summed over the warp by bin (the
// masses over 24-bit halves: a row's masses sum to about 2^48, so each half
// of a warp's sum fits 32 bits) and added once per bin.
__device__ __forceinline__ void flush_run(Shared& sh, int bin, uint32_t c, unsigned long long m,
                                          bool with_mass) {
  const unsigned peers = __match_any_sync(FULL, bin);
  if (bin == BINS) return;
  const bool leader = (threadIdx.x & 31) == __ffs(peers) - 1;
  const uint32_t cs = __reduce_add_sync(peers, c);
  if (leader) atomicAdd(&sh.cnt[bin], cs);
  if (with_mass) {
    const uint32_t lo = __reduce_add_sync(peers, (uint32_t)(m & 0xffffffu));
    const uint32_t hi = __reduce_add_sync(peers, (uint32_t)(m >> 24));
    if (leader) atomicAdd(&sh.mass[bin], ((unsigned long long)hi << 24) + lo);
  }
}

__device__ __forceinline__ void flush(Shared& sh, const Runs& r, bool with_mass) {
  flush_run(sh, r.bin0, r.c0, r.m0, with_mass);
  flush_run(sh, r.bin1, r.c1, r.m1, with_mass);
}

// Every CTA of the cluster: the row's histogram (mcnt, mmass) as the sum
// of the CTAs' histograms of their slices. The first barrier waits for
// every slice's histogram, the second for every read of them, so no CTA
// clears its histogram while another still reads it.
__device__ void merge(Shared& sh, bool with_mass) {
  hopper::cluster_sync();
  for (int i = threadIdx.x; i < BINS; i += PT) {
    uint32_t c = 0;
    unsigned long long m = 0;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) {
      c += ld_u32(at_rank(&sh.cnt[i], r));
      if (with_mass) m += ld_u64(at_rank(&sh.mass[i], r));
    }
    sh.mcnt[i] = c;
    sh.mmass[i] = m;
  }
  hopper::cluster_sync();
}

// Histogram of digit d over the elements of the slice [lo, hi) of p
// matching sel's prefix, merged over the cluster.
__device__ void histogram(Shared& sh, const float* p, int lo, int hi, int d, bool with_mass) {
  clear_bins(sh);
  __syncthreads();
  const uint32_t prefix = sh.sel.prefix, mask = sh.sel.mask;
  const int shift = dig_shift(d), nb = 1 << dig_bits(d);
  Runs run;
  for (int base = lo; base < hi; base += TILE) {
    float x[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int v = base + j * PT + threadIdx.x;
      x[j] = v < hi ? p[v] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int v = base + j * PT + threadIdx.x;
      const uint32_t key = __float_as_uint(x[j]);
      if (v < hi && (key & mask) == prefix)
        tally(sh, run, (int)((key >> shift) & (nb - 1)), x[j], with_mass);
    }
  }
  flush(sh, run, with_mass);
  merge(sh, with_mass);
}

// The CTA scans digit d's bins of the row (counts `cnt`, masses mmass)
// from the top for the first non-empty bin where the mass above it plus
// its own reaches target_m (by_mass), or the count reaches target_c, and
// narrows sel to it (every CTA of the row alike); sel.found is 0 when no
// bin does (only possible for the mass on the first digit). Thread t owns
// bins nb - 1 - 2t and nb - 2 - 2t.
__device__ void choose(Shared& sh, const uint32_t* cnt, int d, bool by_mass,
                       unsigned long long target_m, uint32_t target_c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = 1 << dig_bits(d);
  const int b0 = nb - 1 - 2 * (int)threadIdx.x, b1 = b0 - 1;
  const uint32_t c0 = b0 >= 0 ? cnt[b0] : 0u, c1 = b1 >= 0 ? cnt[b1] : 0u;
  const unsigned long long m0 = b0 >= 0 && by_mass ? sh.mmass[b0] : 0ull;
  const unsigned long long m1 = b1 >= 0 && by_mass ? sh.mmass[b1] : 0ull;
  const uint32_t c = c0 + c1;
  const unsigned long long m = m0 + m1;
  uint32_t ci = c;
  unsigned long long mi = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t cu = __shfl_up_sync(FULL, ci, o);
    const unsigned long long mu = __shfl_up_sync(FULL, mi, o);
    if (lane >= o) {
      ci += cu;
      mi += mu;
    }
  }
  if (lane == 31) {
    sh.warp_c[warp] = ci;
    sh.warp_m[warp] = mi;
  }
  if (threadIdx.x == 0) sh.first = INT32_MAX;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warps' totals
    const uint32_t wc = sh.warp_c[lane];
    const unsigned long long wm = sh.warp_m[lane];
    uint32_t xc = wc;
    unsigned long long xm = wm;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t cu = __shfl_up_sync(FULL, xc, o);
      const unsigned long long mu = __shfl_up_sync(FULL, xm, o);
      if (lane >= o) {
        xc += cu;
        xm += mu;
      }
    }
    __syncwarp();
    sh.warp_c[lane] = xc - wc;
    sh.warp_m[lane] = xm - wm;
  }
  __syncthreads();
  uint32_t run_c = sh.sel.above_c + sh.warp_c[warp] + (ci - c);
  unsigned long long run_m = sh.sel.above_m + sh.warp_m[warp] + (mi - m);
  int mine = -1, bin = 0;
  uint32_t at_c = 0, bin_c = 0;
  unsigned long long at_m = 0;
  const bool reach0 = by_mass ? (c0 > 0 && run_m + m0 >= target_m) : (run_c + c0 >= target_c);
  if (b0 >= 0 && reach0) {
    mine = 2 * threadIdx.x;
    bin = b0;
    at_c = run_c;
    at_m = run_m;
    bin_c = c0;
  } else {
    run_c += c0;
    run_m += m0;
    const bool reach1 = by_mass ? (c1 > 0 && run_m + m1 >= target_m)
                                : (run_c + c1 >= target_c);
    if (b1 >= 0 && reach1) {
      mine = 2 * threadIdx.x + 1;
      bin = b1;
      at_c = run_c;
      at_m = run_m;
      bin_c = c1;
    }
  }
  if (mine >= 0) atomicMin(&sh.first, mine);
  __syncthreads();
  const int first = sh.first;
  if (first == INT32_MAX) {
    if (threadIdx.x == 0) sh.sel.found = 0;
  } else if (mine == first) {
    sh.sel.prefix |= (uint32_t)bin << dig_shift(d);
    sh.sel.mask |= (uint32_t)(nb - 1) << dig_shift(d);
    sh.sel.above_c = at_c;
    sh.sel.above_m = at_m;
    sh.sel.bin_c = bin_c;
    sh.sel.found = 1;
  }
  __syncthreads();
}

__device__ __forceinline__ void reset(Select& sel) {
  sel.prefix = sel.mask = 0;
  sel.above_c = sel.bin_c = 0;
  sel.above_m = 0;
  sel.found = 1;
}

template <typename TL>
__global__ void __launch_bounds__(PT) sample_exact_kernel(
    const TL* __restrict__ logits, const float* __restrict__ pres,
    const float* __restrict__ occ, const float* __restrict__ freq,
    const float* __restrict__ lse, const float* __restrict__ temperature,
    const float* __restrict__ top_p, const int32_t* __restrict__ top_k,
    const uint8_t* __restrict__ need, const float* __restrict__ gumbel,
    const int64_t* __restrict__ seeds, float* __restrict__ scratch,
    int32_t* __restrict__ tokens, int V) {
  const int b = blockIdx.x / SPLIT;
  if (!need[b]) return;  // every CTA of the row's cluster alike
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t rank = hopper::cluster_rank();
  const int per = (V + SPLIT - 1) / SPLIT;
  const int lo = min(V, (int)rank * per), hi = min(V, lo + per);

  const size_t row = (size_t)b * V;
  float* p = scratch + row;
  const float fq = freq[b], ls = lse[b];
  float temp = temperature[b], tp = top_p[b];
  if (temp == 0.0f) {
    temp = 1.0f;
    tp = 0.0f;
  }
  const unsigned long long target =
      !(tp > 0.0f) ? 0ull : tp >= 2.0f ? NEVER : __float2ull_rn(tp * 0x1p48f);

  // pass 1: p = exp(adj - lse) into the scratch row, and the first digit's
  // histogram (counts and masses) of the slice, merged over the cluster
  if (threadIdx.x == 0) reset(sh.sel);
  clear_bins(sh);
  __syncthreads();
  Runs run;
  for (int base = lo; base < hi; base += TILE) {
    float l[U], pr[U], oc[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int v = base + j * PT + threadIdx.x;
      l[j] = v < hi ? to_f32(logits[row + v]) : 0.0f;
      pr[j] = v < hi ? pres[row + v] : 0.0f;
      oc[j] = v < hi ? occ[row + v] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int v = base + j * PT + threadIdx.x;
      const float adj = __fsub_rn(__fsub_rn(l[j], pr[j]), __fmul_rn(oc[j], fq));
      const float x = expf(__fsub_rn(adj, ls));
      if (v < hi) {
        p[v] = x;
        tally(sh, run, (int)(__float_as_uint(x) >> dig_shift(0)), x, true);
      }
    }
  }
  flush(sh, run, true);
  merge(sh, true);
  for (int i = threadIdx.x; i < BINS; i += PT) sh.cnt0[i] = sh.mcnt[i];

  // top-p: tau, and how many values are >= tau
  choose(sh, sh.mcnt, 0, true, target, 0);
  for (int d = 1; d < NDIG && sh.sel.found; ++d) {
    histogram(sh, p, lo, hi, d, true);
    choose(sh, sh.mcnt, d, true, target, 0);
  }
  const bool keep_all = !sh.sel.found;  // the sum never reaches top_p: all kept
  const uint32_t tau = keep_all ? 0u : sh.sel.prefix;
  const long long n_ge = keep_all ? (long long)V : (long long)sh.sel.above_c + sh.sel.bin_c;
  __syncthreads();

  // top-k: the top_k-th value sigma, how many of its ties are kept, and how
  // many of them lie in the slices before this one
  const int k = top_k[b];
  const bool cut = k > 0 && (long long)k < n_ge;
  uint32_t sigma = 0;
  int ties_kept = 0, tie_base = 0;
  if (cut) {
    if (threadIdx.x == 0) reset(sh.sel);
    __syncthreads();
    choose(sh, sh.cnt0, 0, false, 0, (uint32_t)k);
    for (int d = 1; d < NDIG; ++d) {
      histogram(sh, p, lo, hi, d, false);
      choose(sh, sh.mcnt, d, false, 0, (uint32_t)k);
    }
    sigma = sh.sel.prefix;
    ties_kept = k - (int)sh.sel.above_c;
    // the last digit's histogram of the slice counts its ties with sigma
    if (threadIdx.x == 0) sh.slice_ties = sh.cnt[sigma & ((1u << dig_bits(NDIG - 1)) - 1)];
    hopper::cluster_sync();
    for (uint32_t r = 0; r < rank; ++r) tie_base += (int)ld_u32(at_rank(&sh.slice_ties, r));
  }

  // the draw, in index order
  const uint32_t k0 = seeds ? (uint32_t)seeds[b] : 0u;
  const uint32_t k1 = seeds ? (uint32_t)((uint64_t)seeds[b] >> 32) : 0u;
  float best = -INFINITY;
  int best_v = INT32_MAX;
  for (int base = lo; base < hi; base += TILE) {
    float x[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int v = base + j * PT + threadIdx.x;
      x[j] = v < hi ? p[v] : 0.0f;
    }
    int rank_j[U] = {};
    if (cut) {  // each tie's rank among the row's ties, in index order
      unsigned bal[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int v = base + j * PT + threadIdx.x;
        bal[j] = __ballot_sync(FULL, v < hi && __float_as_uint(x[j]) == sigma);
        if (lane == 0) sh.tie_off[j * NW + warp] = __popc(bal[j]);
      }
      __syncthreads();
      if (warp == 0) {  // exclusive scan of the (j, warp) counts, j-major
        int c[U * NW / 32], sum = 0;
#pragma unroll
        for (int i = 0; i < U * NW / 32; ++i) {
          c[i] = sh.tie_off[lane * (U * NW / 32) + i];
          sum += c[i];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += up;
        }
        int run_t = incl - sum;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < U * NW / 32; ++i) {
          sh.tie_off[lane * (U * NW / 32) + i] = run_t;
          run_t += c[i];
        }
        if (lane == 31) sh.tie_total = incl;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < U; ++j)
        rank_j[j] = tie_base + sh.tie_off[j * NW + warp] + __popc(bal[j] & ((1u << lane) - 1u));
      tie_base += sh.tie_total;
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int v = base + j * PT + threadIdx.x;
      const uint32_t key = __float_as_uint(x[j]);
      const bool kept = v < hi && (cut ? key > sigma || (key == sigma && rank_j[j] < ties_kept)
                                       : key >= tau);
      if (kept && x[j] > 0.0f) {
        const float g = gumbel ? gumbel[row + v] : philox_gumbel(v, k0, k1);
        const float s = logf(x[j]) / temp + g;
        if (s > best) {  // ascending v: the first maximum stays
          best = s;
          best_v = v;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(FULL, best, o);
    const int v2 = __shfl_xor_sync(FULL, best_v, o);
    if (s2 > best || (s2 == best && v2 < best_v)) {
      best = s2;
      best_v = v2;
    }
  }
  if (lane == 0) {
    sh.best_s[warp] = best;
    sh.best_i[warp] = best_v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // this slice's best, into rank 0
    for (int w = 1; w < NW; ++w) {
      if (sh.best_s[w] > best || (sh.best_s[w] == best && sh.best_i[w] < best_v)) {
        best = sh.best_s[w];
        best_v = sh.best_i[w];
      }
    }
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(at_rank(&sh.rank_s[rank], 0)),
                 "f"(best) : "memory");
    asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(at_rank(&sh.rank_i[rank], 0)),
                 "r"(best_v) : "memory");
  }
  hopper::cluster_sync();
  if (rank == 0 && threadIdx.x == 0) {  // the slices in order: the lowest id on ties
    best = sh.rank_s[0];
    best_v = sh.rank_i[0];
    for (int r = 1; r < SPLIT; ++r) {
      if (sh.rank_s[r] > best || (sh.rank_s[r] == best && sh.rank_i[r] < best_v)) {
        best = sh.rank_s[r];
        best_v = sh.rank_i[r];
      }
    }
    tokens[b] = best == -INFINITY ? 0 : best_v;  // argmax of all -inf: the first id
  }
}

constexpr int kMaxDevices = 64;

template <typename TL>
int launch(const void* logits, const void* pres, const void* occ, const void* freq,
           const void* lse, const void* temperature, const void* top_p, const void* top_k,
           const void* need, const void* gumbel, const void* seeds, void* scratch, void* tokens,
           int B, int V, cudaStream_t stream) {
  // the Shared block is above the 48 KB default; the attribute is the
  // current device's: set it once on each device (one process may drive
  // several)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(
        sample_exact_kernel<TL>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Shared));
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLIT * B, 1, 1);
  cfg.blockDim = dim3(PT, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Shared);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sample_exact_kernel<TL>, (const TL*)logits, (const float*)pres, (const float*)occ,
      (const float*)freq, (const float*)lse, (const float*)temperature, (const float*)top_p,
      (const int32_t*)top_k, (const uint8_t*)need, (const float*)gumbel,
      (const int64_t*)seeds, (float*)scratch, (int32_t*)tokens, V);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// logits_dtype: 0 = float32, 1 = bfloat16; need is bool (one byte a row);
// temperature, top_p, freq, lse (B,) float32; top_k (B,) int32; tokens (B,)
// int32, written in place for flagged rows; scratch (B, V) float32. Exactly
// one of gumbel ((B, V) float32) and seeds ((B,) int64) is given. `threads`
// and `split` must be this file's PT and SPLIT (a row on SPLIT CTAs of
// PT threads, one cluster). Returns the launch's error code.
extern "C" int sample_exact_rows(const void* logits, const void* pres, const void* occ,
                                 const void* freq, const void* lse, const void* temperature,
                                 const void* top_p, const void* top_k, const void* need,
                                 const void* gumbel, const void* seeds, void* scratch,
                                 void* tokens, int B, int V, int logits_dtype, int threads,
                                 int split, void* stream) {
  if (threads != PT || split != SPLIT || B < 1 || V < 1 ||
      (gumbel == nullptr) == (seeds == nullptr))
    return hopper::ERR_PLAN;
  cudaStream_t s = (cudaStream_t)stream;
  if (logits_dtype == 1)
    return launch<__nv_bfloat16>(logits, pres, occ, freq, lse, temperature, top_p, top_k, need,
                                 gumbel, seeds, scratch, tokens, B, V, s);
  return launch<float>(logits, pres, occ, freq, lse, temperature, top_p, top_k, need, gumbel,
                       seeds, scratch, tokens, B, V, s);
}

extern "C" const char* sample_exact_error_string(int code) {
  return hopper::error_string(code);
}

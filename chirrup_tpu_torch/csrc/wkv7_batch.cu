// wkv7_batch: the bare RWKV-7 WKV recurrence on layer `layer` of the stacked
// state, T >= 1 tokens per request, with ragged lengths. No TMix prologue or
// epilogue: a = -kk and b = kk * a_iclr come in precomputed, k is k~, and raw
// y = S r goes out (GroupNorm and the bonus run outside, in models/rwkv7.py).
//
// Replaces: chirrup_tpu/ops/wkv7_pallas.py::_wkv7_pallas_call_t1
//   (_wkv7_kernel_t1, T = 1) and _wkv7_pallas_call (_wkv7_kernel and
//   _wkv7_kernel_tblocked, T > 1), both reached through wkv7_pallas_batch.
//   T is not padded.
//
// Math per request b, head h and token t < lengths[b] (S is the head's 64x64
// state, row i = value dim, column j = key dim, at state[layer, b, i, h*64+j]):
//   d1_j  = exp(-e^-1/2 * sigmoid(w_j)) + rotator1(elapsed[b] + t)
//   S_ij <- S_ij * d1_j + v_i * k_j + (sum_j' a_j' S_ij') * b_j
//   y_i   = sum_j S_ij r_j
// y is 0 for t >= lengths[b], in r's dtype. S stays in float32 across the
// chunk (the JAX precisions "highest" and "default") and is stored once, in
// the state dtype; a row with lengths[b] == 0 keeps its state bit for bit
// (it is neither read nor written). precision="bf16" on a bf16 state (the
// JAX package's _token_update with bf16_state) keeps S in bf16, rounded
// every token, in the delta form of wkv7_common.cuh:
//   S_ij <- S_ij + ((S_ij * d_j + v_i * k_j) + sa_i * b_j),  d = d1 - 1
//   y_i   = sum_j S_ij * bf16(d1_j r_j) + v_i <r, k> + sa_i <r, b>
//
// Three launches, one chosen on the host by T and the arithmetic
// (wkv7_cuda.batch_plan describes each; the entry refuses any other):
//
// 1. T = 1, either arithmetic ("rows"): the step kernel's row layout
//    (wkv7_step.cu) without its prologue and epilogue. Four heads a block,
//    16 state rows a thread and 8 lanes a row, so one warp load reads a row
//    of four heads (512 contiguous bytes in bf16); the state loads go out
//    first and evict-first; rows of length 0 are neither read nor written.
//    Bound: device memory, the state slab once each way. The row core
//    (rows_f32, rows_bf16) is wkv7_common.cuh's, shared with the step.
//
// 2. T > 1, float32 state arithmetic ("wy"): the chunked WY form on the
//    tensor cores, the algebra of wkv7_cuda.wkv7_batch_chunked_reference.
//    Tokens go in tiles of WT = 16 from the state S0; within a tile,
//    g_t = prod_{u<=t} d1_u per column (g_-1 = 1), A~_t = g_{t-1} a_t,
//    R~_t = g_t r_t, K^_t = k_t / g_t, B^_t = b_t / g_t, and
//      M_ak = tril(A~ K^T, -1), M_ab = tril(A~ B^T, -1),
//      M_rk = tril(R~ K^T),     M_rb = tril(R~ B^T)          (WT x WT),
//      SA   = (S0 A~^T + V M_ak^T) (I - M_ab^T)^-1             (64 x WT),
//      Y    = S0 R~^T + V M_rk^T + SA M_rb^T,
//      S_n  = (S0 + V K^ + SA B^) diag(g_n).
//    The decays are bounded (d1 in [0.545 - 2^-10, 1 + 2^-10]), so a tile's
//    g stays above 6.1e-5 and its ratios well inside float32: no log-space
//    form is needed. Work a token and head: ~40k multiply-adds, against
//    ~9 float32 operations a state element (37k) the per-token recurrence
//    does on the CUDA cores; on the tensor cores it is cheap, and the serial
//    chain shrinks to the tile's substitution. Layout: one block of 4 warps
//    per (head, request); warp w holds state rows 16w .. 16w + 15 as the
//    accumulators of eight m16n8 tiles (32 floats a thread) for the whole
//    chunk, so the state crosses device memory once each way. Every product
//    is mma.sync m16n8k8 TF32 with float32 accumulation; an accumulator
//    tile is the A operand of the next product with the 8-wide k index
//    permuted (A's k = q, q + 4 taken from columns 2q, 2q + 1, B read to
//    match), so S and SA never leave registers. A tile:
//      - its six (WT, 64) input rows are already in shared memory (the ring:
//        six TMA boxes issued by one thread while the last tile computed);
//      - prep, two threads a column (8 tokens each, the decay chain joined
//        by one shuffle): the decays, g, A~, R~, and K^, B^, V transposed
//        (for the products whose k runs over tokens); tokens past the row's
//        length take d1 = 1 and zeros, so they change nothing;
//      - each warp: X_a = S0 A~^T and X_r = S0 R~^T for its rows, and one of
//        the four WT x WT matrices (masked to its triangle) for the block;
//      - after a barrier: X_a += V M_ak^T, X_r += V M_rk^T; the forward
//        substitution of SA over the tile's tokens in float32, two tokens a
//        step (a quad's shuffles: a row's columns sit on four lanes);
//        Y = X_r + SA M_rb^T, staged per warp and stored 16 bytes a lane;
//        S += V K^ + SA B^, then times g_n.
//    Three barriers a tile. Shared memory 46,352 bytes with bf16 inputs
//    (58,640 with float32), 4 blocks an SM (3); strides padded so that the
//    fragment loads of the products over columns are free of bank
//    conflicts. What bounds it on this card is instruction issue and
//    shared-memory traffic, not the tensor work (3.9-4.5x that; PERF.md):
//    the prep's decay takes the approximate exponential and reciprocal, and
//    operands are split in registers, not stored split (twice the
//    shared-memory bytes a fragment, slower).
//    Precision: each product splits its float32 operands hi + lo (hi = x
//    cut to TF32 by a mask, lo = x - hi, which the tensor cores read cut to
//    TF32 too) and sums lo*hi + hi*lo + hi*hi ("3xtf32"), float32-grade
//    products, in both "highest" and "default"; bf16 values (v from bf16
//    rows) are exact in TF32 and skip their lo pass. Emulated on the CPU
//    against float64 (tests/test_torch_wkv7_batch_chunked.py's gate: N 64,
//    T 512, decays at both ends, rows with a_iclr ~ 1), 3xtf32 uses 6e-4 of
//    the per-element limit 2^-7|ref| + 2^-8 rms(ref) on y and the state, one
//    pass ("tf32") 0.56. On the card with bf16 rows and state, bf16 rounding
//    fills that limit and it cannot tell one pass from three (one pass read
//    0.93 of it, PERF.md), so chip_smoke.py holds this form with float32
//    rows and state against a float64 recurrence under a limit 64 times
//    tighter, which one-pass products break. "default" keeps three passes
//    too: one pass ran 0.78-0.82x the time with 7% of the limit to spare.
//    The tile length 16 held the same margins as 32 and 64 in the emulation
//    and does the least WT x WT work.
//
// 3. T > 1, precision="bf16" ("tokens"): the chunk kernel's per-token
//    layout (wkv7_chunk.cu) without its prologue and epilogue: 4 state rows
//    a thread, 8 threads a row, 16-token tiles staged by cp.async into a
//    double-buffered ring. The mode rounds the state to bf16 after every
//    token, which the plain versions reproduce bit for bit and no chunked
//    form can, so this path stays per token and under half its bound: the
//    mode's floor. The token (bf16_token_rows) is wkv7_common.cuh's, shared
//    with the chunk kernel.
//
// Rows whose inputs are not 16-byte aligned (a base or a stride) are staged
// by element loads instead of TMA or cp.async.

#include "hopper_common.cuh"
#include "wkv7_common.cuh"

namespace {

using namespace wkv7;
using hopper::smem_u32;

// the six (B, T, C) input rows r, w, k, v, a, b (columns contiguous): base
// pointers and element strides per request and per token
struct Rows {
  const void* p[6];
  int b[6], t[6];
};
enum { IN_R, IN_W, IN_K, IN_V, IN_A, IN_B };

template <typename TA>
__device__ __forceinline__ const TA* row_ptr(const Rows& rows, int in, int b, int t) {
  return static_cast<const TA*>(rows.p[in]) + (size_t)b * rows.b[in] + (size_t)t * rows.t[in];
}

// tokens t0 .. t0 + n - 1 (n <= TT) of head h's 64 channels of the six
// inputs into dst, laid out [input][TT][64], in 16-byte pieces spread over
// the block's NTH threads: cp.async copies where every row is 16-byte
// aligned, else element loads
template <typename TA, int TT, int NTH>
__device__ __forceinline__ void stage_tile(TA* dst, const Rows& rows, int b, int h, int t0,
                                           int n, int tid, bool aligned) {
  constexpr int EL = 16 / sizeof(TA), PIECES = N / EL;  // a 64-element row's pieces
  constexpr int REPS = (TT * PIECES + NTH - 1) / NTH;
#pragma unroll
  for (int in = 0; in < 6; ++in) {
    const TA* src = row_ptr<TA>(rows, in, b, t0) + h * N;
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep) {
      const int q = tid + rep * NTH, tt = q / PIECES, piece = q % PIECES;
      if (tt >= n) continue;
      const TA* from = src + (size_t)tt * rows.t[in] + piece * EL;
      TA* to = dst + (in * TT + tt) * N + piece * EL;
      if (aligned) {
        copy16(smem_u32(to), from);
      } else {
#pragma unroll
        for (int e = 0; e < EL; ++e) to[e] = from[e];
      }
    }
  }
}

// y of tokens n_tok .. T - 1 of head h: zeros, 16 bytes a store
template <typename TA, int NTH>
__device__ __forceinline__ void zero_tail(TA* y, int b, int h, int T, int C, int n_tok,
                                          int tid) {
  constexpr int PER = N * sizeof(TA) / 16;
  for (int q = tid; q < (T - n_tok) * PER; q += NTH) {
    const int t = n_tok + q / PER;
    *reinterpret_cast<uint4*>(y + ((size_t)b * T + t) * C + h * N + (q % PER) * (16 / sizeof(TA))) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// =================================================================== T = 1
// the step kernel's launch: HB heads a block, RI state rows a thread, P
// threads a row
constexpr int HB = 4, RI = 16, P = 8, NT1 = HB * N / RI * P;
static_assert(P * 8 == N && NT1 % 32 == 0, "rows launch shape");

// A bf16 state's instances are held to 3 blocks an SM (168 registers, as
// the step kernel's): unbounded, the bf16 arithmetic took 181 and ran 2.
template <typename TA, typename TS, bool BF>
__global__ void __launch_bounds__(NT1, sizeof(TS) == 2 ? 3 : 1) batch_rows_kernel(
    TS* __restrict__ state, const Rows rows, const int32_t* __restrict__ elapsed,
    const int32_t* __restrict__ lengths, TA* __restrict__ y, int B, int C, int layer,
    int use_dither) {
  const int b = blockIdx.y, tid = threadIdx.x;
  // lane group gi: head slot gi % HB, rows i0 .. i0 + RI - 1; each lane
  // columns 8 part .. 8 part + 7
  const int gi = tid / P, part = tid % P, i0 = gi / HB * RI;
  const int h = blockIdx.x * HB + gi % HB, H = C / N;
  const bool hv = h < H;  // a slot past the last head computes, stores nothing
  const int c0 = (hv ? h : H - 1) * N;
  if (lengths[b] <= 0) {  // an idle row: its state is neither read nor written
    const int first = blockIdx.x * HB * N;
    for (int q = tid; q < HB * N && first + q < C; q += NT1)
      y[(size_t)b * C + first + q] = from_f32<TA>(0.0f);
    return;
  }

  // the state rows first: their DRAM latency overlaps the input loads
  TS* srow = state + (((size_t)layer * B + b) * N + i0) * C + c0 + 8 * part;
  Raw8<TS> raw[RI];
#pragma unroll
  for (int q = 0; q < RI; ++q) load_raw(srow + (size_t)q * C, raw[q]);

  const int cj = c0 + 8 * part;
  float rr[8], wr[8], kr[8], ar[8], br[8], vv[RI];
  load8_any(row_ptr<TA>(rows, IN_R, b, 0) + cj, rr);
  load8_any(row_ptr<TA>(rows, IN_W, b, 0) + cj, wr);
  load8_any(row_ptr<TA>(rows, IN_K, b, 0) + cj, kr);
  load8_any(row_ptr<TA>(rows, IN_A, b, 0) + cj, ar);
  load8_any(row_ptr<TA>(rows, IN_B, b, 0) + cj, br);
  const TA* vh = row_ptr<TA>(rows, IN_V, b, 0) + c0 + i0;  // v_i of this thread's rows
#pragma unroll
  for (int q = 0; q < RI; q += 8) load8_any(vh + q, *reinterpret_cast<float(*)[8]>(vv + q));
  const unsigned int step = (unsigned int)elapsed[b];

  float yv[RI];
  if constexpr (BF) {
    static_assert(sizeof(TS) == 2, "precision bf16 runs on a bf16 state");
    uint32_t a2[4], b2[4], k2[4], d2[4], dr2[4];
    float rk = 0.0f, rb = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const float d1x = 1.0f + decay(wr[e], step, use_dither);
      const float d1y = 1.0f + decay(wr[e + 1], step, use_dither);
      a2[e / 2] = pack2(ar[e], ar[e + 1]);
      b2[e / 2] = pack2(br[e], br[e + 1]);
      k2[e / 2] = pack2(kr[e], kr[e + 1]);
      d2[e / 2] = pack2(d1x - 1.0f, d1y - 1.0f);
      dr2[e / 2] = pack2(d1x * rr[e], d1y * rr[e + 1]);
      rk += rr[e] * kr[e] + rr[e + 1] * kr[e + 1];
      rb += rr[e] * br[e] + rr[e + 1] * br[e + 1];
    }
    rows_bf16<P, RI>(raw, srow, C, a2, b2, k2, d2, dr2, lanes_sum<P>(rk), lanes_sum<P>(rb), vv,
                     yv, hv);
  } else {
    float d1[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) d1[e] = 1.0f + decay(wr[e], step, use_dither);
    rows_f32<P, RI>(raw, srow, C, d1, ar, kr, br, rr, vv, yv, hv);
  }
  // lane `part` of a row group writes its rows i0 + q with q % P == part
  TA* yh = y + (size_t)b * C + c0 + i0;
#pragma unroll
  for (int q = 0; q < RI; ++q)
    if (q % P == part && hv) yh[q] = from_f32<TA>(yv[q]);
}

// ====================================================== T > 1, the WY form
constexpr int WT = 16;         // tokens a tile
constexpr int WNT = 128;       // 4 warps, 16 state rows each
constexpr int WNN = WT / 8;    // 8-token n-tiles (and k-steps) of a tile
constexpr int LDJ = N + 8;     // floats a row of the [token][column] arrays
constexpr int LDU = WT + 8;    // floats a row of the [row or column][token] arrays
constexpr int LDY = N + 4;     // floats a row of y's staging, [token][row]
static_assert(WT == 16 && WT * LDY <= WT * LDJ, "the WY tile");

// shared memory: A~, R~ [WT][LDJ]; K^, B^, V transposed [N][LDU]; M_ak,
// M_ab, M_rk, M_rb [WT][LDU]; g_n [N] (all float32); the ring of
// [6][WT][N] inputs; the ring's barrier
template <typename TA>
constexpr int wy_smem_bytes() {
  return (2 * WT * LDJ + 3 * N * LDU + 4 * WT * LDU + N) * 4 + 6 * WT * N * (int)sizeof(TA) + 16;
}

// an operand fragment of NR registers split for three TF32 passes: hi, x
// cut to TF32 (one mask), and lo = x - hi (exact in float32; the tensor
// cores read its top 19 bits, TF32 cut toward zero); EXACT values (bf16,
// exact in TF32) go as they are
template <int NR>
struct Frag {
  uint32_t hi[NR], lo[NR];
};
template <bool EXACT = false, int NR>
__device__ __forceinline__ Frag<NR> frag(const float (&x)[NR]) {
  Frag<NR> f;
#pragma unroll
  for (int e = 0; e < NR; ++e) {
    if constexpr (EXACT) {
      f.hi[e] = __float_as_uint(x[e]);
    } else {
      f.hi[e] = __float_as_uint(x[e]) & 0xFFFFE000u;
      f.lo[e] = __float_as_uint(x[e] - __uint_as_float(f.hi[e]));
    }
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b as lo*hi + hi*lo + hi*hi (the small terms first); A_EXACT: a
// holds bf16 values, whose low part is 0, and skips its pass
template <bool A_EXACT = false>
__device__ __forceinline__ void mma_x(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  if constexpr (!A_EXACT) mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Fragments of m16n8k8 with the k index permuted: logical k = q and q + 4
// of lane (g = lane / 4, q = lane % 4) are columns 2q and 2q + 1 of the
// 8-wide step, so each lane's pair is one 8-byte load, and an accumulator
// (columns 2q, 2q + 1 of rows g, g + 8) is an A operand as it stands.
// A from a row-major [m][k] array (p at the tile's first row and column):
__device__ __forceinline__ void load_a(const float* p, int ld, int g, int q, float (&x)[4]) {
  const float2 u = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  const float2 v = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * q);
  x[0] = u.x; x[1] = v.x; x[2] = u.y; x[3] = v.y;
}
// B from an [n][k] array (B transposed, row-major):
__device__ __forceinline__ void load_b(const float* p, int ld, int g, int q, float (&x)[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  x[0] = u.x; x[1] = u.y;
}
// B from a [k][n] array (row-major B):
__device__ __forceinline__ void load_b_kn(const float* p, int ld, int g, int q, float (&x)[2]) {
  x[0] = p[2 * q * ld + g];
  x[1] = p[(2 * q + 1) * ld + g];
}
// A from an accumulator tile c (c0, c1 row g; c2, c3 row g + 8):
__device__ __forceinline__ void acc_as_a(const float (&c)[4], float (&x)[4]) {
  x[0] = c[0]; x[1] = c[2]; x[2] = c[1]; x[3] = c[3];
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the WY form's decay and reciprocal in the approximate instructions
// (ex2.approx, rcp.approx; ~2^-22 relative each): decay() of
// wkv7_common.cuh in a tenth of its instructions, the prep's largest cost.
// The form is held to the per-element limit, not bit for bit, and a d1
// off by 2^-22 moves a 1,024-token chain by at most 2.4e-4 of the state.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float decay_fast(float w, unsigned int step, int use_dither) {
  const float sig = rcp_approx(1.0f + __expf(-w));
  float d = __expf(-0.6065306597126334f * sig) - 1.0f;
  if (use_dither) d += (float)(int)(2654435769u * step) * 0x1p-41f;
  return d;
}

// the WY form's prep of one tile (batch_wy_kernel): column j, tokens
// 8 hf .. 8 hf + 7 of thread 2 j + hf; FULL: every token of the tile is
// within the length
template <bool FULL, typename TA>
__device__ __forceinline__ void prep(const TA* ring, float* s_at, float* s_rt, float* s_kht,
                                     float* s_bht, float* s_vt, float* s_gn, int tid, int nv,
                                     unsigned int step0, int use_dither) {
  const int j = tid >> 1, hf = tid & 1;
  float d1[8], av[8], rv[8], kv[8], bv[8], vv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int tt = 8 * hf + e;
    const bool on = FULL || tt < nv;
    const auto in = [&](int x) { return on ? to_f32(ring[(x * WT + tt) * N + j]) : 0.0f; };
    d1[e] = on ? 1.0f + decay_fast(in(IN_W), step0 + (unsigned int)tt, use_dither)
               : 1.0f;
    av[e] = in(IN_A);
    rv[e] = in(IN_R);
    kv[e] = in(IN_K);
    bv[e] = in(IN_B);
    vv[e] = in(IN_V);
  }
  float gl[8];
  gl[0] = d1[0];
#pragma unroll
  for (int e = 1; e < 8; ++e) gl[e] = gl[e - 1] * d1[e];
  const float first7 = __shfl_xor_sync(0xffffffffu, gl[7], 1);
  const float pre = hf ? first7 : 1.0f;  // g before this thread's first token
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int tt = 8 * hf + e;
    const float gt = hf ? pre * gl[e] : gl[e], gp = e ? (hf ? pre * gl[e - 1] : gl[e - 1]) : pre;
    const float inv = rcp_approx(gt);
    s_at[tt * LDJ + j] = av[e] * gp;
    s_rt[tt * LDJ + j] = rv[e] * gt;
    kv[e] *= inv;
    bv[e] *= inv;
  }
#pragma unroll
  for (int c = 0; c < 8; c += 4) {
    const int o = j * LDU + 8 * hf + c;
    *reinterpret_cast<float4*>(s_kht + o) = make_float4(kv[c], kv[c + 1], kv[c + 2], kv[c + 3]);
    *reinterpret_cast<float4*>(s_bht + o) = make_float4(bv[c], bv[c + 1], bv[c + 2], bv[c + 3]);
    *reinterpret_cast<float4*>(s_vt + o) = make_float4(vv[c], vv[c + 1], vv[c + 2], vv[c + 3]);
  }
  if (hf) s_gn[j] = pre * gl[7];
}

// the six inputs' tensor maps: (B, T, C) read in (1, WT, 64) boxes, rows
// past T as zeros
struct Maps {
  CUtensorMap m[6];
};

template <typename TA, typename TS>
__global__ void __launch_bounds__(WNT, 4) batch_wy_kernel(
    TS* __restrict__ state, const Rows rows, const __grid_constant__ Maps maps,
    const int32_t* __restrict__ elapsed, const int32_t* __restrict__ lengths,
    TA* __restrict__ y, int B, int T, int C, int layer, int use_dither, int aligned) {
  constexpr bool V_EXACT = sizeof(TA) == 2;  // bf16 v is exact in TF32
  extern __shared__ __align__(128) uint8_t smem[];  // the ring's TMA boxes: 128 bytes
  static_assert((2 * WT * LDJ + 3 * N * LDU + 4 * WT * LDU + N) * 4 % 128 == 0, "ring alignment");
  float* s_at = reinterpret_cast<float*>(smem);
  float* s_rt = s_at + WT * LDJ;
  float* s_kht = s_rt + WT * LDJ;
  float* s_bht = s_kht + N * LDU;
  float* s_vt = s_bht + N * LDU;
  float* s_m = s_vt + N * LDU;  // M_ak, M_ab, M_rk, M_rb
  float* s_gn = s_m + 4 * WT * LDU;
  TA* ring = reinterpret_cast<TA*>(s_gn + N);
  const uint32_t full = smem_u32(ring + 6 * WT * N);  // the ring's barrier
  float* s_y = s_at;  // y's staging, in A~'s place once every warp has read A~

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int n_tok = min(max(lengths[b], 0), T), n_tiles = (n_tok + WT - 1) / WT;
  const unsigned int el = (unsigned int)elapsed[b];
  // a tile's inputs: six TMA boxes from one thread where the rows are
  // 16-byte aligned (the copy engine computes the addresses and fills rows
  // past T with zeros), else element loads by every thread
  const auto stage = [&](int tile) {
    if (aligned) {
      if (tid == 0) {
        hopper::mbar_expect_tx(full, 6 * WT * N * sizeof(TA));
#pragma unroll
        for (int in = 0; in < 6; ++in)
          hopper::tma_load_3d(smem_u32(ring + in * WT * N), &maps.m[in], full, h * N, tile * WT, b);
      }
    } else {
      stage_tile<TA, WT, WNT>(ring, rows, b, h, tile * WT, min(WT, n_tok - tile * WT), tid, false);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_tok > 0) stage(0);

  // the state: warp w's rows 16w + g and 16w + g + 8, columns 8 nt + 2q and
  // 8 nt + 2q + 1 of m16n8 accumulator tile nt
  TS* sp = state + (((size_t)layer * B + b) * N + 16 * warp + g) * C + h * N + 2 * q;
  float S[8][4];
  if (n_tok > 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 u = load2(sp + 8 * nt), v = load2(sp + (size_t)8 * C + 8 * nt);
      S[nt][0] = u.x; S[nt][1] = u.y; S[nt][2] = v.x; S[nt][3] = v.y;
    }
  }
  const float* vrow = s_vt + 16 * warp * LDU;  // V of the warp's rows

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * WT, nv = min(WT, n_tok - t0);
    if (aligned) hopper::mbar_wait(full, tile & 1);
    __syncthreads();  // the tile's inputs; the last tile is done

    // prep: column j, tokens 8 hf .. 8 hf + 7 a thread (the column's two
    // threads neighbouring lanes): the decays, g (each half's running
    // product, the second half's times the first's last, one shuffle),
    // A~, R~ and K^, B^, V transposed; g_n. Tokens past the length take
    // d1 = 1 and zeros (a full tile, the rule, tests no token).
    if (nv == WT)
      prep<true>(ring, s_at, s_rt, s_kht, s_bht, s_vt, s_gn, tid, nv, el + (unsigned int)t0,
                 use_dither);
    else
      prep<false>(ring, s_at, s_rt, s_kht, s_bht, s_vt, s_gn, tid, nv, el + (unsigned int)t0,
                  use_dither);
    __syncthreads();
    // the ring is read: the next tile's copies overlap this tile's products
    if (tile + 1 < n_tiles) stage(tile + 1);

    // X_a = S0 A~^T, X_r = S0 R~^T for the warp's rows (k over columns j)
    float xa[WNN][4] = {}, xr[WNN][4] = {};
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      float sx[4], bx[2];
      acc_as_a(S[kc], sx);
      const auto fs = frag(sx);
#pragma unroll
      for (int nt = 0; nt < WNN; ++nt) {
        load_b(s_at + 8 * nt * LDJ + 8 * kc, LDJ, g, q, bx);
        mma_x(xa[nt], fs, frag(bx));
        load_b(s_rt + 8 * nt * LDJ + 8 * kc, LDJ, g, q, bx);
        mma_x(xr[nt], fs, frag(bx));
      }
    }
    // warp w's WT x WT matrix: 0 M_ak, 1 M_ab (strictly lower), 2 M_rk, 3
    // M_rb (lower), rows t, columns u; B (k over columns j) from K^T or B^T
    {
      const float* xs = warp < 2 ? s_at : s_rt;
      const float* ys = (warp & 1) ? s_bht : s_kht;
      float m[WNN][4] = {};
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        float ax[4], bx[2];
        load_a(xs + 8 * kc, LDJ, g, q, ax);
        const auto fa = frag(ax);
#pragma unroll
        for (int nt = 0; nt < WNN; ++nt) {
          load_b_kn(ys + 8 * kc * LDU + 8 * nt, LDU, g, q, bx);
          mma_x(m[nt], fa, frag(bx));
        }
      }
      const int diag = warp < 2 ? 0 : 1;  // u < t + diag is kept
      float* dst = s_m + warp * WT * LDU;
#pragma unroll
      for (int nt = 0; nt < WNN; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = g + 8 * hr, u = 8 * nt + 2 * q;
          store2(dst + t * LDU + u, u < t + diag ? m[nt][2 * hr] : 0.0f,
                 u + 1 < t + diag ? m[nt][2 * hr + 1] : 0.0f);
        }
    }
    __syncthreads();

    // X_a += V M_ak^T, X_r += V M_rk^T (k over the tile's tokens u)
#pragma unroll
    for (int kc = 0; kc < WNN; ++kc) {
      float vx[4], bx[2];
      load_a(vrow + 8 * kc, LDU, g, q, vx);
      const auto fv = frag<V_EXACT>(vx);
#pragma unroll
      for (int nt = 0; nt < WNN; ++nt) {
        load_b(s_m + 8 * nt * LDU + 8 * kc, LDU, g, q, bx);
        mma_x<V_EXACT>(xa[nt], fv, frag(bx));
        load_b(s_m + 2 * WT * LDU + 8 * nt * LDU + 8 * kc, LDU, g, q, bx);
        mma_x<V_EXACT>(xr[nt], fv, frag(bx));
      }
    }
    // SA = X_a (I - M_ab^T)^-1 by forward substitution in float32, two
    // tokens a step: column u is final once the tokens before it are folded
    // in, and its owner lane (q = (u % 8) / 2, which holds u + 1 too) takes
    // column u + 1's one missing term, SA_u M_ab[u+1][u]; it hands both to
    // the quad, and every column t takes SA_u M_ab[t][u] + SA_u+1
    // M_ab[t][u+1] (M_ab is 0 for t <= u), the owner's u + 1 the same bits
    const float* mab = s_m + WT * LDU;
#pragma unroll
    for (int u = 0; u < WT; u += 2) {
      const int nu = u >> 3, src = (lane & ~3) | ((u & 7) >> 1);
      const float m10 = mab[(u + 1) * LDU + u];
      const float c1 = fmaf(xa[nu][0], m10, xa[nu][1]), c3 = fmaf(xa[nu][2], m10, xa[nu][3]);
      const float s0 = __shfl_sync(0xffffffffu, xa[nu][0], src);
      const float s1 = __shfl_sync(0xffffffffu, xa[nu][2], src);
      const float t0 = __shfl_sync(0xffffffffu, c1, src);
      const float t1 = __shfl_sync(0xffffffffu, c3, src);
#pragma unroll
      for (int nt = 0; nt < WNN; ++nt) {
        if (8 * nt + 7 <= u) continue;  // every column of the tile is at or before u
        const float2 m0 = *reinterpret_cast<const float2*>(mab + (8 * nt + 2 * q) * LDU + u);
        const float2 m1 = *reinterpret_cast<const float2*>(mab + (8 * nt + 2 * q + 1) * LDU + u);
        xa[nt][0] = fmaf(t0, m0.y, fmaf(s0, m0.x, xa[nt][0]));
        xa[nt][1] = fmaf(t0, m1.y, fmaf(s0, m1.x, xa[nt][1]));
        xa[nt][2] = fmaf(t1, m0.y, fmaf(s1, m0.x, xa[nt][2]));
        xa[nt][3] = fmaf(t1, m1.y, fmaf(s1, m1.x, xa[nt][3]));
      }
    }
    // Y = X_r + SA M_rb^T, staged [token][row] for the warp's rows
#pragma unroll
    for (int kc = 0; kc < WNN; ++kc) {
      float ax[4], bx[2];
      acc_as_a(xa[kc], ax);
      const auto fa = frag(ax);
#pragma unroll
      for (int nt = 0; nt < WNN; ++nt) {
        load_b(s_m + 3 * WT * LDU + 8 * nt * LDU + 8 * kc, LDU, g, q, bx);
        mma_x(xr[nt], fa, frag(bx));
      }
    }
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int nt = 0; nt < WNN; ++nt) {
      const int t = 8 * nt + 2 * q;
      s_y[t * LDY + r0] = xr[nt][0];
      s_y[(t + 1) * LDY + r0] = xr[nt][1];
      s_y[t * LDY + r0 + 8] = xr[nt][2];
      s_y[(t + 1) * LDY + r0 + 8] = xr[nt][3];
    }
    // S = (S0 + V K^ + SA B^) diag(g_n) (k over the tile's tokens)
#pragma unroll
    for (int kc = 0; kc < WNN; ++kc) {
      float vx[4], ax[4], bx[2];
      load_a(vrow + 8 * kc, LDU, g, q, vx);
      acc_as_a(xa[kc], ax);
      const auto fv = frag<V_EXACT>(vx);
      const auto fa = frag(ax);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        load_b(s_kht + 8 * nt * LDU + 8 * kc, LDU, g, q, bx);
        mma_x<V_EXACT>(S[nt], fv, frag(bx));
        load_b(s_bht + 8 * nt * LDU + 8 * kc, LDU, g, q, bx);
        mma_x(S[nt], fa, frag(bx));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 gn = *reinterpret_cast<const float2*>(s_gn + 8 * nt + 2 * q);
      S[nt][0] *= gn.x;
      S[nt][1] *= gn.y;
      S[nt][2] *= gn.x;
      S[nt][3] *= gn.y;
    }
    // the warp's 16 rows of y, a token's 8 rows a lane (16 bytes in bf16)
    __syncwarp();
    for (int tt = lane >> 1; tt < nv; tt += 16) {
      const int c8 = 16 * warp + 8 * (lane & 1);
      float yv[8];
      load8(s_y + tt * LDY + c8, yv);
      store8(y + ((size_t)b * T + t0 + tt) * C + h * N + c8, yv);
    }
  }
  if (n_tok > 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      store2(sp + 8 * nt, S[nt][0], S[nt][1]);
      store2(sp + (size_t)8 * C + 8 * nt, S[nt][2], S[nt][3]);
    }
  }
  zero_tail<TA, WNT>(y, b, h, T, C, n_tok, tid);
}

// ============================================ T > 1, precision="bf16"
// the chunk kernel's launch: RI2 state rows a thread, P2 threads a row,
// TT2 tokens a tile
constexpr int RI2 = 4, P2 = 8, TT2 = 16, NT2 = N / RI2 * P2;
constexpr int LG = 8;  // a token's 64 channels on LG lanes of 8 each

// shared memory: d, k, a, b and d1*r as bf16 (TT2, 64); v and y float32
// (TT2, 64); <r, k> and <r, b> a token; the ring of 2 x 6 x (TT2, 64) inputs
template <typename TA>
constexpr int tokens_smem_bytes() {
  return 5 * TT2 * N * 2 + 2 * TT2 * N * 4 + 2 * TT2 * 4 + 12 * TT2 * N * (int)sizeof(TA);
}

template <typename TA>
__global__ void __launch_bounds__(NT2) batch_tokens_bf16_kernel(
    __nv_bfloat16* __restrict__ state, const Rows rows, const int32_t* __restrict__ elapsed,
    const int32_t* __restrict__ lengths, TA* __restrict__ y, int B, int T, int C, int layer,
    int use_dither, int aligned) {
  constexpr int NW = NT2 / 32, G = N / 4 / P2, TPW = 32 / LG;
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* h_d = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16 *h_k = h_d + TT2 * N, *h_a = h_k + TT2 * N, *h_b = h_a + TT2 * N;
  __nv_bfloat16* h_r = h_b + TT2 * N;
  float* s_v = reinterpret_cast<float*>(h_r + TT2 * N);
  float *s_y = s_v + TT2 * N, *s_rk = s_y + TT2 * N, *s_rb = s_rk + TT2;
  TA* ring = reinterpret_cast<TA*>(s_rb + TT2);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i0 = tid / P2 * RI2, part = tid % P2;  // rows i0 .. i0 + RI2 - 1
  const int n_tok = min(max(lengths[b], 0), T), n_tiles = (n_tok + TT2 - 1) / TT2;
  const int grp = lane / LG, ch = lane % LG * 8;  // phases A and C: a token, 8 channels
  const unsigned int el = (unsigned int)elapsed[b];
  // one group per tile in every thread (empty past the last tile), so
  // "all but one" is always this tile's
  const auto issue = [&](int tile) {
    const int t0 = tile * TT2;
    stage_tile<TA, TT2, NT2>(ring + (tile & 1) * 6 * TT2 * N, rows, b, h, t0,
                             max(min(TT2, n_tok - t0), 0), tid, aligned);
    copy_commit();
  };
  issue(0);
  issue(1);

  __nv_bfloat16* srow = state + (((size_t)layer * B + b) * N + i0) * C + h * N;
  uint2 S[RI2][G];  // columns 4 (g P2 + part) .. + 3 of each row, two packed pairs
  if (n_tok > 0) {
#pragma unroll
    for (int r = 0; r < RI2; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g)
        S[r][g] = *reinterpret_cast<const uint2*>(srow + (size_t)r * C + 4 * (g * P2 + part));
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * TT2, nt = min(TT2, n_tok - t0);
    const TA* st = ring + (tile & 1) * 6 * TT2 * N + ch;
    copy_wait<1>();  // all but the next tile's group
    __syncthreads();  // this tile's rows from every thread; C of the last is done

    // A: a token's bf16 rows and its two sums, TPW tokens a warp at once
    // (every lane takes part in the sums; a group past nt stores nothing)
    for (int base = warp * TPW; base < nt; base += NW * TPW) {
      const int tt = base + grp, tq = tt < nt ? tt : base;
      float rr[8], wr[8], kr[8], vr[8], ar[8], br[8];
      load8(st + (IN_R * TT2 + tq) * N, rr);
      load8(st + (IN_W * TT2 + tq) * N, wr);
      load8(st + (IN_K * TT2 + tq) * N, kr);
      load8(st + (IN_V * TT2 + tq) * N, vr);
      load8(st + (IN_A * TT2 + tq) * N, ar);
      load8(st + (IN_B * TT2 + tq) * N, br);
      float rk = 0.0f, rb = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        rk += rr[e] * kr[e];
        rb += rr[e] * br[e];
      }
      rk = lanes_sum<LG>(rk);
      rb = lanes_sum<LG>(rb);
      if (tt < nt) {
        const unsigned int step = el + (unsigned int)(t0 + tt);
        uint32_t d2[4], k2[4], a2[4], b2[4], r2[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float d1x = 1.0f + decay(wr[e], step, use_dither);
          const float d1y = 1.0f + decay(wr[e + 1], step, use_dither);
          d2[e / 2] = pack2(d1x - 1.0f, d1y - 1.0f);
          k2[e / 2] = pack2(kr[e], kr[e + 1]);
          a2[e / 2] = pack2(ar[e], ar[e + 1]);
          b2[e / 2] = pack2(br[e], br[e + 1]);
          r2[e / 2] = pack2(d1x * rr[e], d1y * rr[e + 1]);
        }
        const int o = tt * N + ch;
        const auto put = [&](__nv_bfloat16* base_, const uint32_t (&x)[4]) {
          *reinterpret_cast<uint4*>(base_ + o) = make_uint4(x[0], x[1], x[2], x[3]);
        };
        put(h_d, d2);
        put(h_k, k2);
        put(h_a, a2);
        put(h_b, b2);
        put(h_r, r2);
        store8(s_v + o, vr);
        if (ch == 0) {
          s_rk[tt] = rk;
          s_rb[tt] = rb;
        }
      }
    }
    __syncthreads();
    issue(tile + 2);  // the stage is read: its next copies overlap the chain

    // B: the chain, one token at a time (wkv7_common.cuh)
    const uint2 *ha = reinterpret_cast<const uint2*>(h_a) + part,
                *hd = reinterpret_cast<const uint2*>(h_d) + part,
                *hk = reinterpret_cast<const uint2*>(h_k) + part,
                *hb = reinterpret_cast<const uint2*>(h_b) + part,
                *hr = reinterpret_cast<const uint2*>(h_r) + part;
    for (int tt = 0; tt < nt; ++tt) {
      const int o = tt * N / 4;  // a token's 64 bf16 as uint2
      bf16_token_rows<RI2, G, P2>(S, ha + o, hd + o, hk + o, hb + o, hr + o, s_v + tt * N + i0,
                                  s_rk[tt], s_rb[tt], s_y + tt * N + i0, part);
    }
    __syncthreads();

    // C: y, 8 channels a lane
    for (int base = warp * TPW; base < nt; base += NW * TPW) {
      const int tt = base + grp;
      if (tt >= nt) continue;
      float yv[8];
      load8(s_y + tt * N + ch, yv);
      store8(y + ((size_t)b * T + t0 + tt) * C + h * N + ch, yv);
    }
  }
  if (n_tok > 0) {
#pragma unroll
    for (int r = 0; r < RI2; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<uint2*>(srow + (size_t)r * C + 4 * (g * P2 + part)) = S[r][g];
  }
  zero_tail<TA, NT2>(y, b, h, T, C, n_tok, tid);
}

// ================================================================= launch
enum { PATH_ROWS = 0, PATH_WY = 1, PATH_TOKENS = 2 };

template <typename TA, typename TS, bool BF>
int launch_rows(void* state, const Rows& rows, const void* elapsed, const void* lengths,
                void* y, int B, int C, int layer, int use_dither, cudaStream_t stream) {
  batch_rows_kernel<TA, TS, BF><<<dim3((C / N + HB - 1) / HB, B), NT1, 0, stream>>>(
      (TS*)state, rows, (const int32_t*)elapsed, (const int32_t*)lengths, (TA*)y, B, C, layer,
      use_dither);
  return (int)cudaGetLastError();
}

// the tensor map of one (B, T, C) input with element strides sb, st
template <typename TA>
int encode_rows(CUtensorMap* map, const void* p, int B, int T, int C, int sb, int st) {
  hopper::EncodeTiled fn = hopper::encoder();
  if (!fn) return hopper::ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)st * sizeof(TA), (cuuint64_t)sb * sizeof(TA)};
  const cuuint32_t box[3] = {N, WT, 1}, elem[3] = {1, 1, 1};
  const CUresult r = fn(map, sizeof(TA) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::ERR_ENCODE;
}

template <typename TA, typename TS>
int launch_wy(void* state, const Rows& rows, const void* elapsed, const void* lengths, void* y,
              int B, int T, int C, int layer, int use_dither, int aligned,
              cudaStream_t stream) {
  Maps maps;
  if (aligned) {
    for (int in = 0; in < 6; ++in) {
      const int err = encode_rows<TA>(&maps.m[in], rows.p[in], B, T, C, rows.b[in], rows.t[in]);
      if (err) return err;
    }
  }
  // dynamic shared memory above the 48 KB default, allowed at every launch
  // (per device, and cheap beside a launch)
  const auto kernel = batch_wy_kernel<TA, TS>;
  constexpr int smem = wy_smem_bytes<TA>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(C / N, B), WNT, smem, stream>>>((TS*)state, rows, maps, (const int32_t*)elapsed,
                                                (const int32_t*)lengths, (TA*)y, B, T, C,
                                                layer, use_dither, aligned);
  return (int)cudaGetLastError();
}

template <typename TA>
int launch_tokens(void* state, const Rows& rows, const void* elapsed, const void* lengths,
                  void* y, int B, int T, int C, int layer, int use_dither, int aligned,
                  cudaStream_t stream) {
  const auto kernel = batch_tokens_bf16_kernel<TA>;
  constexpr int smem = tokens_smem_bytes<TA>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(C / N, B), NT2, smem, stream>>>((__nv_bfloat16*)state, rows,
                                                (const int32_t*)elapsed,
                                                (const int32_t*)lengths, (TA*)y, B, T, C,
                                                layer, use_dither, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. sb_*, st_*: element strides per
// request and per token of the (B, T, C) inputs r, w, k, v, a, b, whose
// columns are contiguous; y is a contiguous (B, T, C); the state is 16-byte
// aligned. bf16_mode: precision="bf16", on a bf16 state only (a float32
// state runs the float32 update, as the JAX package does). path ..
// tile_tokens: the launch the wrapper's plan (wkv7_cuda.batch_plan)
// describes, refused with ERR_PLAN unless it is this file's for T and the
// arithmetic. Returns the launch's error code.
extern "C" int wkv7_batch(void* state, const void* r, const void* w, const void* k,
                          const void* v, const void* a, const void* b, const void* elapsed,
                          const void* lengths, void* y, int B, int T, int C, int layer,
                          int use_dither, int sb_r, int st_r, int sb_w, int st_w, int sb_k,
                          int st_k, int sb_v, int st_v, int sb_a, int st_a, int sb_b, int st_b,
                          int act_dtype, int state_dtype, int bf16_mode, int path, int threads,
                          int heads_per_block, int rows_per_thread, int threads_per_row,
                          int tile_tokens, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf = bf16_mode && state_dtype == 1;
  const int want = T == 1 ? PATH_ROWS : bf ? PATH_TOKENS : PATH_WY;
  const bool ok =
      path == want &&
      (path == PATH_ROWS ? threads == NT1 && heads_per_block == HB && rows_per_thread == RI &&
                               threads_per_row == P && tile_tokens == 1
       : path == PATH_WY ? threads == WNT && heads_per_block == 1 && rows_per_thread == 2 &&
                               threads_per_row == 4 && tile_tokens == WT
                         : threads == NT2 && heads_per_block == 1 && rows_per_thread == RI2 &&
                               threads_per_row == P2 && tile_tokens == TT2);
  if (!ok) return hopper::ERR_PLAN;
  const Rows rows = {{r, w, k, v, a, b},
                     {sb_r, sb_w, sb_k, sb_v, sb_a, sb_b},
                     {st_r, st_w, st_k, st_v, st_a, st_b}};
  // TMA and cp.async staging need every row on a 16-byte boundary
  const int es = act_dtype == 1 ? 2 : 4;
  int aligned = 1;
  for (int q = 0; q < 6; ++q)
    if (((uintptr_t)rows.p[q] & 15) || (rows.b[q] * es) % 16 || (rows.t[q] * es) % 16)
      aligned = 0;
#define ROWS(TA, TS, BF) \
  return launch_rows<TA, TS, BF>(state, rows, elapsed, lengths, y, B, C, layer, use_dither, s)
#define WY(TA, TS)                                                                   \
  return launch_wy<TA, TS>(state, rows, elapsed, lengths, y, B, T, C, layer, use_dither, \
                           aligned, s)
  using bf16 = __nv_bfloat16;
  if (path == PATH_ROWS) {
    if (bf) {
      if (act_dtype == 1) ROWS(bf16, bf16, true);
      ROWS(float, bf16, true);
    }
    if (act_dtype == 1 && state_dtype == 1) ROWS(bf16, bf16, false);
    if (act_dtype == 1) ROWS(bf16, float, false);
    if (state_dtype == 1) ROWS(float, bf16, false);
    ROWS(float, float, false);
  }
  if (path == PATH_TOKENS) {
    if (act_dtype == 1)
      return launch_tokens<bf16>(state, rows, elapsed, lengths, y, B, T, C, layer, use_dither,
                                 aligned, s);
    return launch_tokens<float>(state, rows, elapsed, lengths, y, B, T, C, layer, use_dither,
                                aligned, s);
  }
  if (act_dtype == 1 && state_dtype == 1) WY(bf16, bf16);
  if (act_dtype == 1) WY(bf16, float);
  if (state_dtype == 1) WY(float, bf16);
  WY(float, float);
#undef ROWS
#undef WY
}

extern "C" const char* wkv7_batch_error_string(int code) { return hopper::error_string(code); }

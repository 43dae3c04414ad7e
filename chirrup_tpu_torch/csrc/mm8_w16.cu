// mm8_w16_gemm: the inner product of the exact w8a16 mm8 matmul,
//   out[b, n] = sum_k xs[b, k] * q[k, n]      (float32 out)
// with xs (B, K) in bfloat16 or float32 and q the (K, M) int8 codes of one
// layer of the stacked (L, K, M) codes, stored K-major (each layer with
// strides (1, K), as mm8.to_k_major stores them) and read in place. The
// rank-1 dequantization corrections stay outside, in ops/mm8.py, as in the
// JAX package.
//
// Replaces: chirrup_tpu/ops/mm8_pallas.py::mm8_core_pallas (_mm8_kernel) and
//   mm8_core_pallas_stacked (its scalar-prefetch layer form). Both widen the
//   int8 tile to the activation dtype in VMEM and run the MXU dot with float32
//   accumulation. The JAX package falls back to an XLA dot when B*K exceeds
//   256*16384 (mm8_core_supported); the math is the same, and this kernel
//   serves every row count.
//
// Bound on the H100: at decode row counts (B <= 64) device memory, the K*M
// weight bytes read once (16 MiB for a 4096x4096 layer, 5 us at 3.35 TB/s);
// at prefill row counts (2,048 rows) the bf16 tensor cores, 2*B*K*M
// operations at 989 TFLOP/s (69 us for a 4096x4096 layer).
//
// Design, bfloat16 xs: mm8_a8.cu's warp-specialised GEMM with one step more.
// wgmma has no int8 x bf16 form, so the codes are widened to bf16 in shared
// memory and both operands come from there:
// - One producer thread keeps a ring of STAGES stages full with TMA loads: a
//   (BM, 128) bf16 tile of xs as two 64-element 128-byte-swizzled atoms,
//   through a 3-D map (1, B, K) so rows past B read as zeros; a (BN, 128)
//   int8 tile of the codes through the (L, M, K) map of mm8_a8_codes_map,
//   the layer a coordinate. Full and empty mbarriers guard each stage.
// - The consumer warpgroups widen the codes one 64-deep atom at a time into
//   one of two bf16 atom tiles (BN rows of 128 bytes, 16-byte chunk c of row
//   r at c ^ (r & 7): the 128-byte swizzle that the wgmma descriptor reads),
//   so an atom is widened while the previous atom's wgmmas run. The
//   widening is exact (|q| <= 128 fits bf16's significand): a byte perm into
//   the float 2^23 + (q + 128), one subtraction, the high half. Then a proxy
//   fence and a barrier of the consumers, and four wgmma m64nBNk16
//   f32.bf16.bf16 with both operands from shared memory and the
//   accumulators in registers. Every product is exact in float32; only the
//   float32 sums round.
// - Tile configurations (ops/mm8_cuda.py w16_plan):
//   prefill (B > 64): 128 x 256 with 2 stages of 64 KiB, or 128 x 128 with 4
//   of 48 KiB where that fills the card's waves better; two consumer
//   warpgroups, setmaxnreg giving them the producer's registers (ptxas
//   still compiles for 168 a thread, so the wide tile widens one chunk at a
//   time to keep its 128 accumulators from spilling). Each xs byte is read
//   from L2 once per BN columns and each code once per 128 rows: with
//   widening off, moving those tiles alone took most of the kernel's time.
//   decode (B <= 64): 64 x 128, one consumer warpgroup, 2 stages of 32 KiB,
//   97 KiB in all, so two CTAs share an SM. K is split across the 2 or 4
//   CTAs of a cluster until the grid has 256 CTAs: each owns 1/split of the
//   tile's columns and adds the others' float32 partials of those columns
//   through distributed shared memory, always in the order of the ranks
//   after its own, so a run repeats its results bit for bit. (At one CTA
//   per SM, 32 clusters of 4 did not fit the card at once and ran in two
//   waves.)
//
// Design, float32 xs: true float32 FMAs, no TF32 (TF32 keeps 10 bits of xs
// and would miss a float32 reference by ~1e-3). A 64 x 32 block tile; each
// thread owns a 4x4 output patch and runs fmaf over 32-deep K slices held in
// shared memory (xs transposed, codes widened to float32). Simple, not fast:
// float32 activations are the small test models' and the checks' dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

using namespace hopper;

namespace {

// ----------------------------------------------------------- bfloat16 xs

constexpr int BK = 128;  // K per stage: one 128-byte row of codes, two bf16 atoms

// four int8 codes -> four bf16, exact: byte + 128 becomes the low byte of the
// float 2^23 + u; minus 2^23 + 128 that is the code, a float whose low 16 bits
// are zero, so its high half is its bf16
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)),
                                     bias));
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// widens the 16 codes of chunk j of row n of a swizzled int8 tile q (rows of
// 128 bytes) into bf16 chunks 2(j%4) and 2(j%4)+1 of row n of the swizzled
// atom tile wt: the codes of K 16j..16j+15 at K 16(j%4).. of the atom
__device__ __forceinline__ void widen_chunk(const uint8_t* q, uint8_t* wt, int n, int j) {
  const int x = n & 7, c0 = 2 * (j & 3);
  const uint4 c = *reinterpret_cast<const uint4*>(q + n * 128 + ((j ^ x) << 4));
  uint8_t* row = wt + n * 128;
  const uint2 a = widen4(c.x), b = widen4(c.y);
  *reinterpret_cast<uint4*>(row + ((c0 ^ x) << 4)) = make_uint4(a.x, a.y, b.x, b.y);
  const uint2 e = widen4(c.z), f = widen4(c.w);
  *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ x) << 4)) = make_uint4(e.x, e.y, f.x, f.y);
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// barrier 1 of the consumer warpgroups only (barrier 0 is __syncthreads)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// Tile configuration: BM rows (64 per consumer warpgroup) x BN columns, a
// ring of STAGES stages, each an xs tile and a code tile, then two widened
// atom tiles, and MIN_CTAS CTAs per SM for the register budget.
template <int BM_, int BN_, int STAGES_, int MIN_CTAS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, MIN_CTAS = MIN_CTAS_;
  static constexpr int NC = BM / 64;  // consumer warpgroups
  static constexpr int CONSUMERS = NC * 128;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int X_BYTES = BM * BK * 2;  // two (BM, 64) bf16 atoms
  static constexpr int Q_BYTES = BN * BK;      // (BN, 128) int8
  static constexpr int STAGE_BYTES = X_BYTES + Q_BYTES;
  static constexpr int W_BYTES = BN * 128;     // one widened (BN, 64) bf16 atom
  // stages, two widened atoms, full and empty barriers, slack to align to 1024
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * W_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(SMEM * MIN_CTAS <= 232448, "the tiles fit one SM's shared memory");
  static_assert(CONSUMERS * (BN / 2) * 4 <= STAGES * STAGE_BYTES, "split-K partials fit the ring");
  static_assert(BN * 4 % CONSUMERS == 0, "an atom's code chunks divide among the consumers");
};

using PrefillWide = Tile<128, 256, 2, 1>;
using PrefillNarrow = Tile<128, 128, 4, 1>;
using Decode = Tile<64, 128, 2, 2>;

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_CTAS) w16_bf16_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    float* __restrict__ out, int B, int K, int M, int layer, int split) {
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES, NC = T::NC, R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t widened = base + STAGES * T::STAGE_BYTES;
  const uint32_t bars = widened + 2 * T::W_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto tile_x = [&](int s) { return base + (uint32_t)(s * T::STAGE_BYTES); };
  auto tile_q = [&](int s) { return tile_x(s) + T::X_BYTES; };

  const int rank = split > 1 ? (int)cluster_rank() : 0;
  const int m0 = (blockIdx.x / split) * BM, n0 = blockIdx.y * BN;
  const int kb_n = K / BK / split, kb0 = rank * kb_n;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------------------------------------------------- producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NC * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < kb_n; ++kb) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), T::STAGE_BYTES);
        const int k0 = (kb0 + kb) * BK;
        tma_load_3d(tile_x(s), &xmap, full(s), k0, m0, 0);
        tma_load_3d(tile_x(s) + BM * 128, &xmap, full(s), k0 + 64, m0, 0);
        tma_load_3d(tile_q(s), &qmap, full(s), k0, n0, layer);
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
    }
    __syncwarp();
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = threadIdx.x, t = ct % 128, warp = t / 32, lane = t % 32;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < kb_n; ++kb) {
    mbar_wait(full(s), phase);
    const uint8_t* q = gbase + (tile_q(s) - base);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // widen atom h (K bytes 64h..64h+63) into widened tile h; the wgmmas
      // that last read it, two atoms ago, retired before the last
      // consumers_sync
      const uint32_t w = widened + (uint32_t)(h * T::W_BYTES);
      uint8_t* wt = gbase + (w - base);
      constexpr int ITEMS = BN * 4 / T::CONSUMERS;  // 16-code chunks per thread
      if constexpr (BN == 256) {
        // m64n256's 128 accumulators leave few registers: one chunk at a time
#pragma unroll 1
        for (int i = 0; i < ITEMS; ++i) {
          const int idx = ct + i * T::CONSUMERS;
          widen_chunk(q, wt, idx / 4, 4 * h + idx % 4);
        }
      } else {
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          const int idx = ct + i * T::CONSUMERS;
          widen_chunk(q, wt, idx / 4, 4 * h + idx % 4);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      if (kb > 0 || h > 0) {
        // the previous atom's wgmmas have retired; after the previous
        // stage's last atom, release that stage
        wgmma_wait<0>();
        fence_acc(acc);
        if (h == 0 && lane == 0) mbar_arrive(empty(prev));
      }
      consumers_sync<T::CONSUMERS>();
      const uint64_t da = smem_desc(tile_x(s) + h * BM * 128 + wg * 64 * 128);
      const uint64_t db = smem_desc(w);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 bf16 (32 bytes) of K per wgmma: +2 in 16-byte units
        if constexpr (BN == 256) wgmma_bf16_n256(acc, da + 2 * kk, db + 2 * kk);
        else wgmma_bf16_n128(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      fence_acc(acc);
    }
    prev = s;
    if (++s == STAGES) { s = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // split-K: each CTA of the cluster owns 1/split of the tile's 8-column
  // groups (accumulator quads), adds the others' partials of those groups in
  // rank order after its own, read through distributed shared memory, and
  // stores them. The ring is free here: every load into it has landed and
  // been read.
  const int groups = BN / 8 / split;
  if (split > 1) {
    consumers_sync<T::CONSUMERS>();  // every consumer warpgroup's wgmmas have retired
    const uint32_t part = base + (uint32_t)(wg * 128 * R * 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (j / groups != rank)
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                     ::"r"(part + (uint32_t)((j * 128 + t) * 16)), "f"(acc[4 * j]),
                     "f"(acc[4 * j + 1]), "f"(acc[4 * j + 2]), "f"(acc[4 * j + 3])
                     : "memory");
    cluster_sync();
    for (int r = 1; r < split; ++r) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote) : "r"(part), "r"((rank + r) % split));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (j / groups != rank) continue;
        float v0, v1, v2, v3;
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(v0), "=f"(v1), "=f"(v2), "=f"(v3)
                     : "r"(remote + (uint32_t)((j * 128 + t) * 16)) : "memory");
        acc[4 * j] += v0; acc[4 * j + 1] += v1; acc[4 * j + 2] += v2; acc[4 * j + 3] += v3;
      }
    }
    cluster_sync();  // the partials stay readable until every CTA has its sums
  }

  // ------------------------------------------------------------ epilogue
  // wgmma's accumulator layout: acc[4j + 2h + e] is row 16*warp + lane/4
  // + 8h, column 8j + 2*(lane%4) + e of this warpgroup's 64 x BN tile
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (j / groups != rank) continue;
    const int n = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < B)
        *reinterpret_cast<float2*>(out + (size_t)row * M + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <class T>
int launch(const CUtensorMap& xmap, const CUtensorMap& qmap, float* out, int B, int K, int M,
           int layer, int split, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        w16_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * ((B + T::BM - 1) / T::BM), M / T::BN, 1);
  cfg.blockDim = dim3(T::THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w16_bf16_kernel<T>, xmap, qmap, out, B, K, M,
                                           layer, split);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// ------------------------------------------------------------ float32 xs

constexpr int FM = 64, FN = 32, FK = 32;  // block tile and K slice
constexpr int FT = 128;                   // 4 warps

__global__ void __launch_bounds__(FT) w16_f32_kernel(
    const float* __restrict__ xs, const int8_t* __restrict__ q, float* __restrict__ out,
    int B, int K, int M) {
  __shared__ __align__(16) float xs_t[FK][FM + 4];  // transposed: [k][row]
  __shared__ __align__(16) float ws_t[FK][FN];      // [k][col]

  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  const int t = threadIdx.x;
  const int tc = t % (FN / 4), tr = t / (FN / 4);  // 8 column groups x 16 row groups
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FK) {
    // xs slice: 64 rows x 32 floats, one float4 per thread per pass
#pragma unroll
    for (int i = 0; i < FM * FK / 4 / FT; ++i) {
      const int idx = t + i * FT, row = idx / (FK / 4), c4 = (idx % (FK / 4)) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + row < B) v = *reinterpret_cast<const float4*>(xs + (size_t)(m0 + row) * K + k0 + c4);
      xs_t[c4][row] = v.x;
      xs_t[c4 + 1][row] = v.y;
      xs_t[c4 + 2][row] = v.z;
      xs_t[c4 + 3][row] = v.w;
    }
    // code slice: 32 columns x 32 K-major codes, 8 consecutive k per thread
    {
      const int col = t % FN, k8 = (t / FN) * 8;
      const uint2 u = *reinterpret_cast<const uint2*>(q + (size_t)(n0 + col) * K + k0 + k8);
      const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) ws_t[k8 + e][col] = (float)c[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs_t[kk][tr * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws_t[kk][tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + tr * 4 + i;
    if (b < B)
      *reinterpret_cast<float4*>(out + (size_t)b * M + n0 + tc * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// The tensor map of stacked K-major codes, the same map as mm8_a8_codes_map
// builds: q points at L layers of (M, K) bytes, read in (box_n, 128) tiles.
// map_out: 128 bytes of host memory, handed back to mm8_w16_gemm.
extern "C" int mm8_w16_codes_map(const void* q, int L, int K, int M, int box_n, void* map_out) {
  return encode_codes_map(reinterpret_cast<CUtensorMap*>(map_out), q, L, K, M, box_n);
}

// xs (B, K) row-major, dtype code 0 = float32, 1 = bfloat16; out (B, M)
// float32. bfloat16: the codes through qmap (mm8_w16_codes_map with box_n =
// bn) at `layer`, the tiles (bm, bn, stages, split) from the wrapper's plan.
// float32: q points at the layer's K-major codes. K % 128 == 0 and
// M % 128 == 0 (the wrapper checks).
extern "C" int mm8_w16_gemm(const void* xs, const void* qmap, const void* q, void* out, int B,
                            int K, int M, int layer, int dtype, int bm, int bn, int stages,
                            int split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 1) {
    w16_f32_kernel<<<dim3(M / FN, (B + FM - 1) / FM), FT, 0, s>>>(
        (const float*)xs, (const int8_t*)q, (float*)out, B, K, M);
    return (int)cudaGetLastError();
  }
  CUtensorMap xmap;
  const int err = encode_3d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xs, (uint64_t)K,
                            (uint64_t)B, 1, 64u, (uint32_t)bm);
  if (err) return err;
  const CUtensorMap& qm = *reinterpret_cast<const CUtensorMap*>(qmap);
#define MM8_W16_LAUNCH(T)                                               \
  if (bm == T::BM && bn == T::BN && stages == T::STAGES)                \
    return launch<T>(xmap, qm, (float*)out, B, K, M, layer, split, s);
  MM8_W16_LAUNCH(PrefillWide)
  MM8_W16_LAUNCH(PrefillNarrow)
  MM8_W16_LAUNCH(Decode)
#undef MM8_W16_LAUNCH
  return ERR_TILE;
}

extern "C" const char* mm8_w16_error_string(int code) { return error_string(code); }

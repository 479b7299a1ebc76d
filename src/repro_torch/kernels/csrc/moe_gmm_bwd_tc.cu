// The backward pass of the MoE expert FFN's grouped matmul on Hopper's
// tensor cores (sm_90a) in bf16: wgmma with both operands in shared memory,
// tiles by TMA.  Loaded through ctypes; the route ``tc`` of
// ``kernels/moe_gmm.py::grouped_matmul_bwd`` (bf16 calls of the training
// path's grouped-matmul Function; f32 calls take ``general``,
// csrc/moe_gmm_bwd.cu).
//
// What it stands for: the gradient of src/repro/kernels/moe_gmm.py::_kernel
// (lines 23-69, the Pallas TPU kernel behind ``grouped_matmul``), which the
// JAX package cannot differentiate (jax.grad does not go through its
// pallas_call).  The forward, in the block-aligned layout of the dispatch
// buffers (x (G * C, D) holds G groups of C rows, rows r >= fills[g] of
// group g come out as exact zeros), is y[g*C + r] = x[g*C + r] @ w[g]; its
// gradients are
//     dx[g*C + r] = dy[g*C + r] @ w[g]^T         (r < fills[g], else 0)
//     dw[g]       = x[g, :fills[g]]^T @ dy[g, :fills[g]]
// x, dy, dx (G * C, D or F) and w, dw (G, D, F), contiguous bf16, 16-byte
// aligned, D and F multiples of 8 (TMA's 16-byte strides); ``fills`` G
// int32 (clamped to [0, C]) or null for every row live.  f32 sums, bf16
// results.  Rows past a fill send nothing into dw, whatever x and dy hold
// there (NaN included), and their dx rows are exact zeros.
//
// Bound on the card: each product is 2 x live rows x D x F FLOPs against
// the live rows of x and dy, the live slots' weights and the outputs read
// or written once.  At olmoe's training shape (64 slots of C = 2560, 2048
// <-> 1024, ~65,536 live rows of 163,840) dx is bound by its bytes (0.32
// ms: it writes every row of dx, zeros included) and dw by the bf16
// tensor-core rate (0.28 ms at 989 TFLOP/s).
//
// Design: the forward gmm_tc's tile (moe_gmm_tc.cu) with other operand
// layouts.  A 128 x 256 output tile per pass of a persistent CTA: two
// consumer warpgroups of 64 rows, each issuing wgmma m64n256k16 from shared
// memory, f32 accumulators in registers (128 a thread); K steps of 64 by
// TMA (128-byte swizzle, 48 KB a stage) into a four-stage ring with "full"
// and "empty" mbarriers, filled by one producer warp (one lane issues).
// No atomics: each output element is summed by one warpgroup in a fixed
// order, so two runs give equal bits.
//  * dx_kernel: rows of a group x columns of D, reducing over F.  A is dy
//    (the 3-D tensor (G, C, F), K-major: a row tile past C is zero-filled
//    and never reads the next group), B is w[g] as stored -- (D, F), F
//    contiguous, which is K-major for this product: no transpose bit.  The
//    persistent walk takes the live row tiles (first row below fills[g]),
//    the row tiles of a column tile adjacent so that they share w's slab
//    in L2; a tenth warp writes the dead tiles' zeros; a partial tile
//    writes zeros from fills[g] on.
//  * dw_kernel: a (D, F) tile of one slot per pass, reducing over that
//    slot's rows only, in 64-row stages up to ceil(fills[g] / 64).  A = x^T
//    and B = dy are both MN-major (their rows are the reduction), read
//    through the transpose bits.  The walk goes slot by slot, so a slot's x
//    and dy stay in L2 across its tiles.  A slot with fill 0 writes zeros
//    and reads nothing.  The last stage's rows in [fill, 64 ceil(fill /
//    64)) hold whatever the dispatch left there: the consumers zero those
//    rows of both tiles in shared memory (under the 128-byte swizzle a
//    reduction row is one whole 128-byte line of a box), fence the generic
//    writes to the async proxy, and meet at a named barrier before the
//    stage's wgmma.
// Launches go on the caller's stream and never synchronise; the launcher
// returns a cudaError_t (cudaErrorInvalidValue when the driver's tensor-map
// encoder is missing or refuses a map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                    // rows per tile: two warpgroups
constexpr int kBN = 256;                    // columns per tile
constexpr int kBK = 64;                     // K per stage: 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 64;   // + the producer and zero warps
constexpr int kBox = kBK * 64 * 2;          // 8 KB: a 64 x 64 box
constexpr int kABytes = kBM * kBK * 2;      // 16 KB: the A tile
constexpr int kBBytes = kBN * kBK * 2;      // 32 KB: the B tile
constexpr int kStageBytes = kABytes + kBBytes;              // 48 KB
constexpr int kSmem = 1024 + kStages * kStageBytes;         // 197,632 B

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase ``parity`` of ``bar`` to complete.  A copy that
// never lands (a bad tensor map) traps after ~2^28 polls instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// one box of a 3-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: the
// start address, the leading and stride byte offsets, layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulator registers across a wgmma
// that is still in flight
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 256, f32) = or += A (64 x 16) * B (16 x 256), both bf16 in shared
// memory with 128-byte swizzle; ``TA``/``TB`` 0 for a K-major operand, 1
// for an MN-major one (the transpose bits); ``accumulate`` 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pick(const uint32_t* v, int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__device__ __forceinline__ int group_fill(const int* fills, int g, int C) {
  return fills == nullptr ? C : min(max(fills[g], 0), C);
}

// an output tile: group, row tile, column tile
struct Tile {
  int g, m, n;
};

// dx's live (``live``) or dead tiles in group-major order, the row tiles
// of a column tile next to each other: ``seek(j, t)`` gives the j-th, or
// false past the last.  Calls come with increasing j, so the group only
// moves forward, reading each fill once.
struct Walk {
  const int* fills;
  int G, C, mt, nt;
  bool live;
  int g = -1, first = 0, count = 0, lm = 0;   // g's tiles: [first, + count)
  __device__ bool seek(int j, Tile& t) {
    while (j >= first + count) {
      first += count;
      if (++g >= G) return false;
      lm = (group_fill(fills, g, C) + kBM - 1) / kBM;   // live row tiles
      count = (live ? lm : mt - lm) * nt;
    }
    const int k = j - first;
    const int rows = live ? lm : mt - lm;         // g's row tiles walked
    t = {g, (live ? 0 : lm) + k % rows, k / rows};
    return true;
  }
};

// dw's tiles, slot by slot: (g, D tile m, F tile n), m fastest
__device__ __forceinline__ bool dw_tile(int j, int G, int mt, int nt,
                                        Tile& t) {
  if (j >= G * mt * nt) return false;
  t = {j / (mt * nt), j % mt, (j / mt) % nt};
  return true;
}

// ------------------------------------------------------------------ kernel

// kDW false: dx (out (G * C, D); A dy, B w); true: dw (out (G, D, F); A x,
// B dy).  ``R`` is the output's row count per group (C or D), ``N`` its
// columns (D or F), ``K`` the reduction of a full tile (F, or C for dw,
// cut at the fill).
template <bool kDW>
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ fills, int G, int C, int R, int N,
                  int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* stage0 = smem_raw + (base - smem_u32(smem_raw));   // generic
  auto a_s = [&](int s) { return base + s * kStageBytes; };
  auto b_s = [&](int s) { return base + s * kStageBytes + kABytes; };
  auto bar_full = [&](int s) { return smem_u32(&bars[s]); };
  auto bar_empty = [&](int s) { return smem_u32(&bars[kStages + s]); };

  const int tid = threadIdx.x;
  const int mt = (R + kBM - 1) / kBM, nt = (N + kBN - 1) / kBN;
  // the K stages of a tile of group g
  auto stages = [&](int g) {
    return kDW ? (group_fill(fills, g, C) + kBK - 1) / kBK
               : (K + kBK - 1) / kBK;
  };
  auto next = [&](Walk& w, int j, Tile& t) {
    return kDW ? dw_tile(j, G, mt, nt, t) : w.seek(j, t);
  };
  Tile tl;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 2);   // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers + 32) {     // the zero warp: dx's dead tiles
    if (!kDW) {
      Walk dead{fills, G, C, mt, nt, false};
      for (int j = blockIdx.x; dead.seek(j, tl); j += gridDim.x) {
        const int row0 = tl.m * kBM, col0 = tl.n * kBN;
        const int nr = min(kBM, R - row0), np = min(kBN, N - col0) / 8;
        __nv_bfloat16* og = out + static_cast<size_t>(tl.g) * R * N;
        for (int i = tid % 32; i < nr * np; i += 32)
          *reinterpret_cast<uint4*>(
              og + static_cast<size_t>(row0 + i / np) * N + col0 +
              8 * (i % np)) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  if (tid >= kConsumers) {          // the producer warp: one lane issues
    if (tid == kConsumers) {
      Walk live{fills, G, C, mt, nt, true};
      int it = 0;
      for (int j = blockIdx.x; next(live, j, tl); j += gridDim.x) {
        const int nk = stages(tl.g);
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % kStages, use = it / kStages;
          if (use > 0) mbar_wait(bar_empty(s), (use - 1) & 1);
          mbar_expect_tx(bar_full(s), kStageBytes);
          if (kDW) {
            // x^T: two 64 x 64 boxes (D columns, rows); dy: four (F, rows)
#pragma unroll
            for (int b = 0; b < kBM / 64; ++b)
              tma_load(a_s(s) + b * kBox, &tm_a, bar_full(s),
                       tl.m * kBM + b * 64, k * kBK, tl.g);
#pragma unroll
            for (int b = 0; b < kBN / 64; ++b)
              tma_load(b_s(s) + b * kBox, &tm_b, bar_full(s),
                       tl.n * kBN + b * 64, k * kBK, tl.g);
          } else {
            // dy: one 64 x 128 box (F, rows); w: one 64 x 256 (F, D rows)
            tma_load(a_s(s), &tm_a, bar_full(s), k * kBK, tl.m * kBM, tl.g);
            tma_load(b_s(s), &tm_b, bar_full(s), k * kBK, tl.n * kBN, tl.g);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63 of the tile; a
  // thread the rows ``ra`` and ``ra + 8`` of each n8 column block, at the
  // columns 2 (lane % 4) and + 1
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32, quad = lane % 4;
  float acc[kBN / 2];
  Walk live{fills, G, C, mt, nt, true};
  int it = 0;
  for (int j = blockIdx.x; next(live, j, tl); j += gridDim.x) {
    const int fill = group_fill(fills, tl.g, C);
    const int nk = stages(tl.g);
    const int row0 = tl.m * kBM, col0 = tl.n * kBN;
    __nv_bfloat16* og = out + static_cast<size_t>(tl.g) * R * N;
    if (kDW && nk == 0) {           // a slot with no live row: zeros
      for (int i = tid; i < kBM * kBN / 8; i += kConsumers) {
        const int r = row0 + i / (kBN / 8), col = col0 + 8 * (i % (kBN / 8));
        if (r < R && col < N)
          *reinterpret_cast<uint4*>(og + static_cast<size_t>(r) * N + col) =
              make_uint4(0, 0, 0, 0);
      }
      continue;
    }

    for (int k = 0; k < nk; ++k, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full(s), (it / kStages) & 1);
      if (kDW && k == nk - 1 && fill % kBK) {
        // rows [fill % 64, 64) of the last stage: zero them in all six
        // boxes, 16 bytes a thread at a time, before any wgmma reads them
        const int r0 = fill % kBK, per_box = (kBK - r0) * 8;
        for (int i = tid; i < 6 * per_box; i += kConsumers) {
          const int box = i / per_box, at = i % per_box;
          *reinterpret_cast<uint4*>(stage0 + s * kStageBytes + box * kBox +
                                    r0 * 128 + at * 16) =
              make_uint4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      }
      wgmma_fence();
      if (kDW) {
        // A = x^T, MN-major: this warpgroup's box; B = dy, MN-major: four
        // boxes kBox apart; 16 rows (2 KB) a step
        const uint32_t a = a_s(s) + wg * kBox, b = b_s(s);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_n256<1, 1>(acc, smem_desc(a + kk * 16 * 128, kBox, 1024),
                           smem_desc(b + kk * 16 * 128, kBox, 1024),
                           k > 0 || kk > 0);
      } else {
        // A = dy, K-major: this warpgroup's 64 rows of the 128; B = w,
        // K-major: 256 rows; 32 bytes along the rows a step
        const uint32_t a = a_s(s) + wg * 64 * 128, b = b_s(s);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_n256<0, 0>(acc, smem_desc(a + kk * 32, 16, 1024),
                           smem_desc(b + kk * 32, 16, 1024),
                           k > 0 || kk > 0);
      }
      wgmma_commit();
      if (k > 0) {                  // the group that read stage it - 1 is done
        wgmma_wait<1>();
        if (tid % 128 == 0) mbar_arrive(bar_empty((it - 1) % kStages));
      }
    }
    wgmma_wait<0>();
    fence_regs<kBN / 2>(acc);
    if (tid % 128 == 0) mbar_arrive(bar_empty((it - 1) % kStages));

    // epilogue: per row half (e 0: row ra, 2: row ra + 8) and group of four
    // n8 blocks, lane ``quad`` gathers block 4 q + quad's 8 columns
    const int ra = row0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = ra + 4 * e;     // e = 2: ra + 8
      const bool keep = kDW || r < fill;
#pragma unroll
      for (int q = 0; q < kBN / 32; ++q) {
        uint32_t v[4], o4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = pack_bf16(acc[4 * (4 * q + i) + e],
                           acc[4 * (4 * q + i) + e + 1]);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          // lane c sends v[c ^ x] and receives lane c ^ x's v[c]
          const uint32_t got =
              __shfl_xor_sync(0xffffffffu, pick(v, quad ^ x), x);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if ((quad ^ x) == i) o4[i] = got;
        }
        const int col = col0 + 8 * (4 * q + quad);
        if (r < R && col < N)
          *reinterpret_cast<uint4*>(og + static_cast<size_t>(r) * N + col) =
              keep ? make_uint4(o4[0], o4[1], o4[2], o4[3])
                   : make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime's entry-point
// query, so the library needs no -lcuda; looked up once.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 3-D map of a (groups, rows, cols) bf16 tensor as (cols, rows,
// groups), with boxes of 64 columns by ``box_rows`` rows of one group
bool make_map(CUtensorMap* map, const void* ptr, int groups, int rows,
              int cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t strides[2] = {row, row * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int set_smem(const void* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
}

}  // namespace

// (x, w, dy, dx, dw, fills, G, C, D, F, ctas, stream): x (G*C, D), w (G, D,
// F), dy (G*C, F) bf16; dx or dw null skips its product; ``fills`` null or
// G int32; ``ctas`` the most persistent blocks per kernel (the wrapper
// passes the SM count).
extern "C" int repro_grouped_matmul_bwd_tc(const void* x, const void* w,
                                           const void* dy, void* dx, void* dw,
                                           const void* fills, int G, int C,
                                           int D, int F, int ctas,
                                           void* stream) {
  if (G <= 0 || C <= 0 || D <= 0 || F <= 0) return 0;
  uintptr_t align = 0;
  for (const void* p : {x, w, dy, static_cast<const void*>(dx),
                        static_cast<const void*>(dw)})
    align |= reinterpret_cast<uintptr_t>(p);
  if (D % 8 != 0 || F % 8 != 0 || ctas <= 0 || (align & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* f = static_cast<const int*>(fills);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // raise the shared-memory limits once, at the first launch: not again
  // inside a CUDA-graph capture
  static bool limit_set = false;
  if (!limit_set) {
    int err = set_smem(reinterpret_cast<const void*>(
        gmm_bwd_tc_kernel<false>));
    if (err == 0)
      err = set_smem(reinterpret_cast<const void*>(gmm_bwd_tc_kernel<true>));
    if (err != 0) return err;
    limit_set = true;
  }
  if (dx != nullptr) {
    CUtensorMap tdy, tw;
    if (!make_map(&tdy, dy, G, C, F, kBM) || !make_map(&tw, w, G, D, F, kBN))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles = static_cast<long long>(G) *
                            ((C + kBM - 1) / kBM) * ((D + kBN - 1) / kBN);
    const int grid = static_cast<int>(tiles < ctas ? tiles : ctas);
    gmm_bwd_tc_kernel<false><<<grid, kThreads, kSmem, s>>>(
        tdy, tw, static_cast<__nv_bfloat16*>(dx), f, G, C, C, D, F);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dw != nullptr) {
    CUtensorMap tx, tdy;
    if (!make_map(&tx, x, G, C, D, kBK) || !make_map(&tdy, dy, G, C, F, kBK))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles = static_cast<long long>(G) *
                            ((D + kBM - 1) / kBM) * ((F + kBN - 1) / kBN);
    const int grid = static_cast<int>(tiles < ctas ? tiles : ctas);
    gmm_bwd_tc_kernel<true><<<grid, kThreads, kSmem, s>>>(
        tx, tdy, static_cast<__nv_bfloat16*>(dw), f, G, C, D, F, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

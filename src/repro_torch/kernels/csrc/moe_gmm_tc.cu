// Grouped matmul of the MoE expert FFN on the tensor cores for NVIDIA
// Hopper (sm_90a): bf16 in, f32 accumulation, wgmma with both operands in
// shared memory, tiles by TMA.  Loaded through ctypes; the route ``gmm_tc``
// of ``kernels/moe_gmm.py`` (bf16 prefill).
//
// What it replaces: src/repro/kernels/moe_gmm.py::_kernel (the Pallas TPU
// kernel behind ``grouped_matmul``).  x (G * C, D) holds G groups of C
// rows, w (G, D, F) row-major, y (G * C, F):
//     y[g * C + r, :] = x[g * C + r, :] @ w[g]          (f32 accumulation)
// all bf16, contiguous, 16-byte aligned, D and F multiples of 8 (TMA's
// 16-byte strides), any C.  ``fills`` (G int32, or null for all C): rows
// r >= fills[g] of group g are written as exact zeros and cost no product
// (the rows the dispatch pads a slot with).
//
// Bound on the card: olmoe's prefill (G 64, C 2560, D 2048, F 1024) is
// 687 GFLOP against 1.3 GB of operands, ~540 FLOPs per byte, above the
// H100's ~295: the bf16 tensor-core rate bounds it (0.69 ms at 989
// TFLOP/s), or the live rows' share of it with fills.
//
// Design.
//  * A 128 x 256 output tile of one group per pass: two consumer
//    warpgroups of 64 rows, each issuing wgmma m64n256k16 with A (x,
//    K-major) and B (w, MN-major: the transpose bit) from shared memory,
//    f32 accumulators in registers (128 per thread).
//  * K steps of 64 come in by TMA with 128-byte swizzle (one 128 x 64 box
//    of x, four 64 x 64 boxes of w: 48 KB a stage) into a four-stage ring
//    with a "full" and an "empty" mbarrier per stage.  One producer warp
//    (a ninth warp; one lane issues) keeps the ring full; the warpgroups
//    keep one wgmma group in flight and free a stage as soon as the group
//    that read it has retired.  No register-hungry producer warpgroup: it
//    was slower for attention (ptxas ignored setmaxnreg).  No cluster
//    either: a pair of CTAs sharing the w boxes by TMA multicast (a third
//    less traffic from L2) was slower on the card as written.
//  * x is described to TMA as the 3-D tensor (G, C, D): a row tile that
//    runs past C is zero-filled by TMA and never reads the next group's
//    rows; D and F edges are zero-filled the same way.
//  * Persistent, over the live tiles only: one CTA per SM takes every
//    gridDim-th tile of the live ones (first row below fills[g]) in
//    group-major order, the row tiles of a column tile next to each
//    other, so the CTAs stay within a few groups of each other and the
//    live row tiles that read one column slab of w[g] run side by side,
//    in step along K, and share it in L2; no CTA gets more than one live
//    tile over its share.  (With the column tiles of a row tile next to
//    each other instead, the readers of a slab were nt tiles apart: at
//    deepseek-v3's 256 experts, whose w[g] is 29 MB, the slabs fell out
//    of L2 between them, and the down product at F = 7168 ran 1.9x
//    slower on the card; olmoe's were unchanged.)  The producer already fills
//    the ring for the next tile while the warpgroups store this one.  A
//    partly filled tile computes in full and writes zeros from fills[g]
//    on.
//  * Dead tiles (first row at or past fills[g]) are never loaded: a tenth
//    warp writes their zeros in 16-byte pieces, dealt out over the CTAs
//    the same way, while the warpgroups compute.
//  * Epilogue: f32 to bf16 in registers; a 4 x 4 transpose within each
//    quad of lanes (shuffles) gives each lane 8 adjacent columns, stored
//    as one 16-byte piece, masked at C and F.
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
constexpr int kABytes = kBM * kBK * 2;      // 16 KB: the x box
constexpr int kBBox = kBK * 64 * 2;         // 8 KB: a 64 x 64 box of w
constexpr int kStageBytes = kABytes + (kBN / 64) * kBBox;   // 48 KB
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
// memory with 128-byte swizzle: A K-major, B MN-major (transposed);
// ``accumulate`` 0 overwrites D.
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
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
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

// The live (``live``) or dead tiles in group-major order, the row tiles
// of a column tile next to each other: ``seek(j, t)`` gives the j-th, or
// false past the last.  Calls come with increasing j,
// so the group only moves forward, reading each fill once.
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

// ------------------------------------------------------------------ kernel

__global__ void __launch_bounds__(kThreads, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              __nv_bfloat16* __restrict__ y, const int* __restrict__ fills,
              int G, int C, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  // per stage "full" (its copies landed) and "empty" (both warpgroups are
  // done with it)
  __shared__ __align__(8) uint64_t bars[2 * kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto a_s = [&](int s) { return base + s * kStageBytes; };
  auto b_s = [&](int s) { return base + s * kStageBytes + kABytes; };
  auto bar_full = [&](int s) { return smem_u32(&bars[s]); };
  auto bar_empty = [&](int s) { return smem_u32(&bars[kStages + s]); };

  const int tid = threadIdx.x;
  const int mt = (C + kBM - 1) / kBM, nt = (F + kBN - 1) / kBN;
  const int nk = (D + kBK - 1) / kBK;
  Tile tl;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 2);   // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers + 32) {     // the zero warp: the dead tiles
    Walk dead{fills, G, C, mt, nt, false};
    for (int j = blockIdx.x; dead.seek(j, tl); j += gridDim.x) {
      const int row0 = tl.m * kBM, col0 = tl.n * kBN;
      const int nr = min(kBM, C - row0), np = min(kBN, F - col0) / 8;
      __nv_bfloat16* yg = y + static_cast<size_t>(tl.g) * C * F;
      for (int i = tid % 32; i < nr * np; i += 32)
        *reinterpret_cast<uint4*>(
            yg + static_cast<size_t>(row0 + i / np) * F + col0 +
            8 * (i % np)) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (tid >= kConsumers) {          // the producer warp: one lane issues
    if (tid == kConsumers) {
      Walk live{fills, G, C, mt, nt, true};
      int it = 0;
      for (int j = blockIdx.x; live.seek(j, tl); j += gridDim.x) {
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % kStages, use = it / kStages;
          if (use > 0) mbar_wait(bar_empty(s), (use - 1) & 1);
          mbar_expect_tx(bar_full(s), kStageBytes);
          tma_load(a_s(s), &tm_x, bar_full(s), k * kBK, tl.m * kBM, tl.g);
#pragma unroll
          for (int b = 0; b < kBN / 64; ++b)
            tma_load(b_s(s) + b * kBBox, &tm_w, bar_full(s),
                     tl.n * kBN + b * 64, k * kBK, tl.g);
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
  for (int j = blockIdx.x; live.seek(j, tl); j += gridDim.x) {
    const int fill = group_fill(fills, tl.g, C);
    const int row0 = tl.m * kBM, col0 = tl.n * kBN;
    __nv_bfloat16* yg = y + static_cast<size_t>(tl.g) * C * F;

    for (int k = 0; k < nk; ++k, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full(s), (it / kStages) & 1);
      const uint32_t a = a_s(s) + wg * 64 * 128, b = b_s(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)   // 32 bytes along the rows
        wgmma_n256(acc, smem_desc(a + kk * 32, 16, 1024),
                   smem_desc(b + kk * 16 * 128, kBBox, 1024),
                   k > 0 || kk > 0);
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
      const bool live = r < fill;
#pragma unroll
      for (int q = 0; q < kBN / 32; ++q) {
        uint32_t v[4], out[4];
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
            if ((quad ^ x) == i) out[i] = got;
        }
        const int col = col0 + 8 * (4 * q + quad);
        if (r < C && col < F)
          *reinterpret_cast<uint4*>(yg + static_cast<size_t>(r) * F + col) =
              live ? make_uint4(out[0], out[1], out[2], out[3])
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

}  // namespace

// x (G*C, D), w (G, D, F) -> y (G*C, F), bf16; ``fills`` null or G int32;
// ``ctas`` persistent blocks (the wrapper passes min(tiles, SMs)).
extern "C" int repro_grouped_matmul_tc(const void* x, const void* w, void* y,
                                       const void* fills, int G, int C,
                                       int D, int F, int ctas, void* stream) {
  if (G <= 0 || C <= 0 || F <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(y);
  if (D <= 0 || D % 8 != 0 || F % 8 != 0 || ctas <= 0 || (align & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  if (!make_map(&tx, x, G, C, D, kBM) || !make_map(&tw, w, G, D, F, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the shared-memory limit once, at the first launch: not again
  // inside a CUDA-graph capture
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  gmm_tc_kernel<<<ctas, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<__nv_bfloat16*>(y), static_cast<const int*>(fills),
      G, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

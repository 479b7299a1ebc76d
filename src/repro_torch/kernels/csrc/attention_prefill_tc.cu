// Prefill attention on the tensor cores for NVIDIA Hopper (sm_90a): bf16
// in, f32 softmax and accumulation, wgmma for both products, K/V tiles by
// TMA.  Loaded through ctypes; the route ``prefill_tc`` of
// ``kernels/flash_attention.py``.
//
// What it replaces: src/repro/kernels/flash_attention.py::_kernel (the
// Pallas TPU kernel behind ``flash_attention``), and the sliding window
// that the JAX package's ``ops.attention`` sends to its jnp reference
// (src/repro/kernels/ref.py::attention_reference) with positions
// q_off + arange(Sq) and arange(Sk): ``causal`` keeps q >= k, ``window > 0``
// keeps q - k < window.  ``q_off`` (>= 0) places query row i at position
// i + q_off: a block of a sequence split over ranks (the rank's queries
// against every key before them), 0 for a whole sequence.  Explicit
// positions go to the other routes.
//
// q (B, Sq, H, HD), k (B, Sk, KV, HD), v (B, Sk, KV, HDV), o (B, Sq, H, HDV),
// contiguous bf16, 16-byte aligned, (HD, HDV) one of (64, 64), hubert's (80,
// 80), (128, 128) and MLA's (192, 128); the kv head of q head h is h / (H /
// KV).  Any Sq, Sk >= 1.  ``lse`` null, or (B, H, Sq) f32: each row's
// log-sum-exp of its masked scores times scale, in log2 units (m + log2(l) of
// the online softmax below), which the training path's backward
// (attention_bwd_tc.cu) takes instead of recomputing it; serving passes null
// and does the same work as without it.
//
// Bound on the card: Sq = Sk = 2048 does 2 * (HD + HDV) FLOPs per live
// (query, key, head) against 2 bytes per element of q, k, v and o read or
// written once: hundreds of FLOPs per byte, far above the H100's ~295, so
// it is bound by the bf16 tensor-core rate (989 TFLOP/s).
//
// Design.
//  * A block takes 128 queries of one q head of one batch row: two
//    consumer warpgroups of 64 rows.  K/V are read through the kv head; the
//    G heads that share it hit the same lines in L2.  The q tiles run in
//    reverse order, so the heaviest causal tiles start first.
//  * K and V tiles of 128 keys come in by TMA (4-D tensor maps over
//    (head dim, heads, S, B), 64-column boxes with 128-byte swizzle; a
//    256-byte row of HD 128 is two boxes) into a ring of stages with a
//    "full" and an "empty" mbarrier per stage: thread 0 starts the copy of
//    tile t + stages - 1 before the block waits for tile t, so the copies
//    overlap the products, and each warpgroup frees a stage by arriving on
//    its "empty" barrier, so the two warpgroups drift apart instead of
//    meeting at a block-wide barrier per tile.  Q comes in once the same
//    way.  Keys and queries past Sk and Sq are zero-filled by TMA.  Three
//    stages at HD <= 128; two at MLA's (192, 128), whose Q (48 KB) and
//    three stages of K (48 KB) and V (32 KB) would need 289 KB of the 227
//    a block may have: two take 209 KB and keep 128-key tiles, so both
//    products keep the shapes of the other instantiations (n128 scores,
//    one wgmma per 16 keys of V).
//  * hubert's head dim 80 (a 160-byte row): two 64-column boxes, the
//    second at column 64 of a tensor map whose inner dimension is 80, so
//    TMA fills its columns 80-127 with zeros.  The 128-byte swizzle, the
//    descriptors and the tile walk stay those of the other head dims; S =
//    Q K^T stops after five k16 steps (the fifth in the second box), and
//    O += P V is one m64n80k16 per 16 keys, its B operand the first box
//    and 16 columns of the second (one box apart, as at 128).  The zeros
//    cost shared-memory writes, no device-memory reads; three stages take
//    225 KB.  (The other layout, a 16-column box with 32-byte swizzle,
//    would need a second descriptor kind and its own k step.)
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major).  The online softmax runs in registers on the accumulator
//    layout (each thread holds two rows; a row spans a quad), with f32
//    running max and sum, in base 2.  P is rounded to bf16 in registers,
//    where the accumulator layout of S is the A-fragment layout of the
//    next product, and O += P V is wgmma with A from registers and V from
//    shared memory (MN-major B).
//  * Masks, on the queries' positions (row + q_off): tiles that no live
//    (query, key) pair reaches are never loaded (causal: keys past the
//    block's last query; window: keys before its first query's window), so a 128-query tile of window 1024 reads at
//    most 9 key tiles.  Only tiles that cross the causal diagonal, the
//    window's left edge or Sk evaluate the mask; the others run unmasked.
//    Masked scores inside Sk are -1e30 and keys past Sk -inf (weight
//    exactly 0); the denominator is clamped at 1e-30, as in the Pallas
//    kernel.  A query row with no live key in the tiles its block visits
//    averages their values (never on the path).
//  * No warp specialisation and no persistent grid: every thread is a
//    consumer and thread 0 issues the copies.  The grid has 7-8 waves of
//    blocks at the path's shapes, so a persistent scheduler would mostly
//    save the tail.  Three variants were slower on the card at all three
//    path shapes: a producer warp or warpgroup (ptxas kept every thread at
//    168 registers, setmaxnreg notwithstanding, and spilled); issuing
//    S_{t+1} before the softmax of S_t inside a warpgroup; and named
//    barriers that alternate the two warpgroups' turns at the tensor
//    cores (PERF.md).
// Launches go on the caller's stream and never synchronise; the launcher
// returns a cudaError_t (cudaErrorInvalidValue when the driver's tensor-map
// encoder is missing or refuses a map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBQ = 128;            // queries per block: two warpgroups
constexpr int kBK = 128;            // keys per tile
constexpr int kThreads = 256;
constexpr int kBox = 64;            // columns per TMA box: 128 bytes of bf16
constexpr int kBoxBytes = kBox * 2;
constexpr float kMasked = -1e30f;   // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

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

// Waits for the phase ``parity`` of ``bar`` to complete.  A copy that
// never lands (a bad tensor map) traps after ~2^28 polls instead of
// hanging the card.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

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

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching accumulator registers across a wgmma
// that is still in flight
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 128, f32) = or += A (64 x 16) * B (16 x 128), both bf16 in shared
// memory, K-major, 128-byte swizzle; ``accumulate`` 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// O (64 x 64, f32) += A (64 x 16, bf16 in registers: the P fragment)
// * B (16 x 64, bf16 in shared memory, MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O (64 x 128, f32) += A (64 x 16, bf16 in registers: the P fragment)
// * B (16 x 128, bf16 in shared memory, MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O (64 x 80, f32) += A (64 x 16, bf16 in registers: the P fragment)
// * B (16 x 80, bf16 in shared memory, MN-major, 128-byte swizzle: a whole
// swizzle atom and 16 columns of the next, ``lbo`` bytes on).
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O += P V for a v head dim of HDV columns
template <int HDV>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t desc_b) {
  static_assert(HDV == 64 || HDV == 80 || HDV == 128,
                "v head dim 64, 80 or 128");
  if constexpr (HDV == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (HDV == 80) {
    wgmma_rs_n80(d, a, desc_b);
  } else {
    wgmma_rs_n128(d, a, desc_b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ bool live(int qi, int kj, int causal, int window) {
  return (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
}

// ------------------------------------------------------------------ kernel

// the shared-memory plan of q/k head dim HD and v head dim HDV: a row in
// 64-column boxes, the last one zero-filled past the row's end (HD 80)
template <int HD, int HDV>
struct Layout {
  static_assert(HD % 16 == 0 && HDV % 16 == 0 && HD <= 192 && HDV <= 128,
                "q/k head dims in k16 steps up to 192, v up to 128");
  static constexpr int kChunks = (HD + kBox - 1) / kBox;    // boxes per row
  static constexpr int kVChunks = (HDV + kBox - 1) / kBox;
  static_assert(kChunks * kBox >= HD && kVChunks * kBox >= HDV,
                "the boxes cover a row");
  static constexpr int kQChunk = kBQ * kBoxBytes;           // 16 KB
  static constexpr int kKVChunk = kBK * kBoxBytes;          // 16 KB
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKBytes = kChunks * kKVChunk;        // one K tile
  static constexpr int kVBytes = kVChunks * kKVChunk;       // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kStages = HD > 128 ? 2 : 3;          // K/V ring
  static constexpr int kAhead = kStages - 1;  // tiles in flight ahead
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
prefill_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int Sq, int Sk, int H, int KV, int causal, int window,
                  int q_off, float scale_log2) {
  using L = Layout<HD, HDV>;
  constexpr int kStages = L::kStages, kAhead = L::kAhead;
  constexpr int kSN = kBK / 8;     // n8 column blocks of S
  constexpr int kON = HDV / 8;     // n8 column blocks of O
  extern __shared__ uint8_t smem_raw[];
  // Q; per stage "full" (its copy landed) and "empty" (both warpgroups
  // are done with it)
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQBytes;    // stage s: K then V

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  // the key tiles the block's query positions q0 + q_off .. reach
  const int t_hi = causal ? min(n_tiles, (q_last + q_off) / kBK + 1)
                          : n_tiles;
  const int t_lo = window > 0 ? max(0, q0 + q_off - window + 1) / kBK : 0;

  const int tid = threadIdx.x;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kv = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_empty = [&](int s) { return smem_u32(&bars[1 + kStages + s]); };
  auto load_tile = [&](int t, int s) {
    const uint32_t k_dst = kv_s + s * L::kStageBytes;
    const uint32_t v_dst = k_dst + L::kKBytes;
    mbar_expect_tx(bar_kv(s), L::kStageBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(k_dst + c * L::kKVChunk, &tm_k, bar_kv(s), c * kBox, kvh,
               t * kBK, b);
#pragma unroll
    for (int c = 0; c < L::kVChunks; ++c)
      tma_load(v_dst + c * L::kKVChunk, &tm_v, bar_kv(s), c * kBox, kvh,
               t * kBK, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_kv(s), 1);
      mbar_init(bar_empty(s), 2);   // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(q_s + c * L::kQChunk, &tm_q, bar_q, c * kBox, h, q0, b);
    for (int j = 0; j < kAhead && t_lo + j < t_hi; ++j)
      load_tile(t_lo + j, j);
  }

  // this thread's place in the accumulator layout: warpgroup wg holds rows
  // 64 wg .. 64 wg + 63 of the block; the thread rows r0 and r0 + 8
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int c_lane = 2 * (lane % 4);          // column within an n8 block
  // the positions of rows r0, r1 and of the warpgroup's first and last
  const int p0 = r0 + q_off, p1 = r1 + q_off;
  const int wg_first = q0 + q_off + wg * 64, wg_last = wg_first + 63;

  float acc[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;
  float m0 = kMasked, m1 = kMasked;   // running max, base 2
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the sum

  mbar_wait(bar_q, 0);
  const uint32_t q_wg = q_s + wg * 64 * kBoxBytes;

  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int s = i % kStages;
    if (tid == 0 && t + kAhead < t_hi) {
      // into the stage of tile t + kAhead - kStages, once both warpgroups
      // are done with it
      const int sn = (i + kAhead) % kStages, use = (i + kAhead) / kStages;
      if (use > 0) mbar_wait(bar_empty(sn), (use - 1) & 1);
      load_tile(t + kAhead, sn);
    }
    mbar_wait(bar_kv(s), (i / kStages) & 1);
    const uint32_t k_s = kv_s + s * L::kStageBytes;
    const uint32_t v_s = k_s + L::kKBytes;

    // S = Q K^T over HD / 16 steps: 32 bytes along the swizzled row, a new
    // box every four steps
    float sc[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      wgmma_ss_n128(sc,
                    smem_desc(q_wg + (ks / 4) * L::kQChunk + off, 16, 1024),
                    smem_desc(k_s + (ks / 4) * L::kKVChunk + off, 16, 1024),
                    ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBK / 2>(sc);

    const int k0 = t * kBK;
    const bool masked = k0 + kBK > Sk ||
                        (causal && k0 + kBK - 1 > wg_first) ||
                        (window > 0 && wg_last - k0 >= window);
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * j + e] * scale_log2;
        float x1 = sc[4 * j + 2 + e] * scale_log2;
        if (masked) {
          const int kj = k0 + 8 * j + c_lane + e;
          if (kj >= Sk) {
            x0 = x1 = -INFINITY;            // past the end: weight 0
          } else {
            if (!live(p0, kj, causal, window)) x0 = kMasked;
            if (!live(p1, kj, causal, window)) x1 = kMasked;
          }
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // a row spans a quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
      const float p00 = exp2f(sc[4 * j] - mn0);
      const float p01 = exp2f(sc[4 * j + 1] - mn0);
      const float p10 = exp2f(sc[4 * j + 2] - mn1);
      const float p11 = exp2f(sc[4 * j + 3] - mn1);
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      // n8 block j is half of the A fragment of k16 step j / 2
      pf[j / 2][2 * (j % 2)] = pack_bf16(p00, p01);
      pf[j / 2][2 * (j % 2) + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < kON; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    // O += P V over kBK / 16 steps of 16 keys (2 KB of the V tile each)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<HDV>(acc, pf[kk], smem_desc(v_s + kk * 16 * kBoxBytes,
                                           L::kKVChunk, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<HDV / 2>(acc);
    if (tid % 128 == 0) mbar_arrive(bar_empty(s));
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq;
    if (r0 < Sq) lse[row + r0] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (r1 < Sq) lse[row + r1] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
#pragma unroll
  for (int j = 0; j < kON; ++j) {
    const int col = 8 * j + c_lane;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((static_cast<size_t>(b) * Sq + r0) * H + h) * HDV + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((static_cast<size_t>(b) * Sq + r1) * H + h) * HDV + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
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

// the 4-D map of a (B, S, heads, hd) bf16 tensor as (hd, heads, S, B), with
// boxes of 64 columns by ``rows`` positions of one head
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int causal, int window,
           int q_off, float scale, cudaStream_t stream) {
  using L = Layout<HD, HDV>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, H, HD, kBQ) ||
      !make_map(&tk, k, B, Sk, KV, HD, kBK) ||
      !make_map(&tv, v, B, Sk, KV, HDV, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the shared-memory limit once, at the first launch: not again
  // inside a CUDA-graph capture
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_tc_kernel<HD, HDV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  prefill_tc_kernel<HD, HDV><<<grid, kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, KV, causal,
      window, q_off, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (q, k, v, o, lse, B, Sq, Sk, H, KV, hd, hdv, causal, window, q_off,
// scale, stream); ``lse`` null or (B, H, Sq) f32; q_off >= 0
extern "C" int repro_attention_prefill_tc(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int Sq, int Sk, int H,
                                          int KV, int hd, int hdv,
                                          int causal, int window,
                                          int q_off, float scale,
                                          void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(lse);
  if (KV <= 0 || H % KV != 0 || q_off < 0 || (align & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 64 && hdv == 64)
    return launch<64, 64>(q, k, v, o, l, B, Sq, Sk, H, KV, causal,
                          window, q_off, scale, s);
  if (hd == 80 && hdv == 80)
    return launch<80, 80>(q, k, v, o, l, B, Sq, Sk, H, KV, causal,
                          window, q_off, scale, s);
  if (hd == 128 && hdv == 128)
    return launch<128, 128>(q, k, v, o, l, B, Sq, Sk, H, KV, causal,
                            window, q_off, scale, s);
  if (hd == 192 && hdv == 128)
    return launch<192, 128>(q, k, v, o, l, B, Sq, Sk, H, KV, causal,
                            window, q_off, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

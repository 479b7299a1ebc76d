// The backward pass of GQA attention on Hopper's tensor cores (sm_90a) in
// bf16: wgmma for every product, tiles by TMA.  Loaded through ctypes; the
// route ``tc`` of ``kernels/flash_attention.py::attention_bwd`` (bf16 calls
// of the training path's attention Function; f32 calls take ``general``,
// csrc/attention_bwd.cu).
//
// What it stands for: the gradient of src/repro/kernels/flash_attention.py
// ::_kernel (lines 25-111, the Pallas TPU kernel behind ``flash_attention``),
// which the JAX package cannot differentiate (jax.grad does not go through
// its pallas_call): dq, dk and dv of softmax(q k^T * scale + mask) v, the
// mask being the kernel's causal one and the sliding window of
// ``ops.attention`` (no explicit positions: query i and key j sit at
// i + q_off and j; ``q_off`` >= 0 is a rank's first position in a sequence
// split over ranks, 0 for a whole sequence).
//
// q (B, Sq, H, HD), k (B, Sk, KV, HD), v (B, Sk, KV, HDV), o, do (B, Sq, H,
// HDV), contiguous bf16, 16-byte aligned, (HD, HDV) = (64, 64), hubert's (80,
// 80), (128, 128) or MLA's (192, 128); lse (B, H, Sq) f32, the forward's row
// log-sum-exp of the masked scores times scale, in log2 units (what
// attention_prefill_tc.cu writes: m + log2(l) with m the row's largest score *
// scale * log2(e)).  dq (B, Sq, H, HD), dk (B, Sk, KV, HD), dv (B, Sk, KV,
// HDV) come out in bf16; lse_pad and delta_pad (B * H * Sq_pad f32, Sq_pad =
// Sq rounded up to 128) are scratch.  The kv head of q head h is h / (H / KV).
// Every query row keeps at least one key (the wrapper raises otherwise).
//
// Arithmetic (FlashAttention's backward): P = exp2(S * scale * log2(e) -
// lse), delta = rowsum(dO o O), dP = dO V^T, dS = P o (dP - delta),
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G query heads of each kv head.  P and dS are
// rounded to bf16 before their products (the A fragments of wgmma, f32
// sums); dS takes the rounded P.
//
// Bound on the card: per live (query, key) pair and q head, five products
// (S, dQ and dK of 2 HD FLOPs, dP and dV of 2 HDV; the LSE comes from the
// forward) against a few bytes per element of q, k, v, o, dO and the three
// gradients: operations bound it, at 989 TFLOP/s.  This kernel forms S and
// dP twice (seven products a pair), so that no gradient needs atomics.
//
// Design, two kernels on the caller's stream, no atomics on the gradients:
// each gradient element is summed by one warpgroup in a fixed order, so
// two runs give equal bits.  Both are two warpgroups (256 threads) and no producer warp:
// ptxas budgets a block of 288 threads as 384, 168 registers a thread, and
// at HD 128 dK and dV alone take 128 of them (160 at (192, 128)); 256
// threads have 255.  Tiles
// come in by TMA (4-D tensor maps over (head dim, heads, S, B), 64-column
// boxes with 128-byte swizzle, rows past Sq or Sk zero-filled) into rings
// of three stages with a "full" mbarrier each.  Thread 0 issues the first
// copies; after that, whichever warpgroup frees a stage second (a count in
// shared memory) issues the copy of the tile three ahead into it, so
// neither warpgroup waits for the other (a thread-0 producer that waited
// for both to free a stage held them in step, and was slower).  A block
// holds 128 rows, 64 a warpgroup, and streams tiles of N rows: N = 128 at
// HD 64, 64 at HD 80 and 128 (where S^T and dP^T of 64 x 128 would not
// fit beside dK and dV); at (192, 128) dq_kernel streams 64 keys and
// dkv_kernel 32 queries (``Layout``).  At (192, 128) S (S^T) sums over 192
// columns in three boxes, dP (dP^T) and delta over 128 in two; dQ and dK
// are wgmmas of N = 192 (m64n192k16), dV of N = 128.  At hubert's (80, 80)
// a row is two boxes, the second zero-filled by TMA past column 80 (the
// tensor map's inner dimension), so every tile keeps the 128-byte swizzle
// and the descriptors of the other head dims: S and dP stop after five k16
// steps, and dQ, dK and dV are wgmmas of N = 80 (m64n80k16), their B
// operand a swizzle atom and 16 columns of the next.
//  * dq_kernel, per (batch, q head, 128 queries).  Q and dO arrive once;
//    each warpgroup computes delta for its rows from O and dO in device
//    memory, and writes delta and the LSE, padded, for dkv_kernel.  Key
//    tiles (K and V) stream through the stages.  Per tile, S = Q K^T and dP
//    = dO V^T are wgmma with both operands in shared memory (K-major); P
//    and dS are formed on the accumulators, whose layout is the A-fragment
//    layout of the next product, and dQ += dS K takes A from registers and
//    K from shared memory, read MN-major through the transpose bit.
//  * dkv_kernel, per (batch, kv head, 128 keys), dK and dV in registers.
//    K and V stay resident; the loop runs over the G query heads and, for
//    each, the query tiles that reach the block's keys (causal: from the
//    first key on; window: up to the last key plus the window).  Q, dO and
//    the padded LSE and delta of each tile arrive by TMA (bulk copies for
//    the two rows of f32) into the stages.  S^T = K Q^T and dP^T = V dO^T
//    are shared-memory wgmmas, so P^T and dS^T are register A fragments as
//    they stand; dV += P^T dO and dK += dS^T Q read dO and Q MN-major.
// A tile that no unmasked pair reaches is never loaded, and a key block
// that no query reaches (causal: keys past q_off + Sq - 1) still writes
// its dK and dV: zeros.  Tiles that cross the causal diagonal, the
// window's edge, Sq or Sk are masked element by element; the others run
// unmasked.  The launcher returns a cudaError_t
// (cudaErrorInvalidValue when the driver's tensor-map encoder is missing or
// refuses a map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWG = 64;             // rows of a warpgroup's tile
constexpr int kBig = 128;           // queries of a dq block, keys of a dkv
constexpr int kStages = 3;
constexpr int kThreads = 256;      // two warpgroups; thread 0 issues copies
constexpr int kBox = 64;            // columns per TMA box: 128 bytes
constexpr int kBoxBytes = kBox * 2;
constexpr int kPad = 128;           // Sq_pad: Sq rounded up to this
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

// ``bytes`` (a multiple of 16) contiguous bytes into shared memory,
// completing on ``bar``; both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// D (64 x 32, f32) = or += A (64 x 16) * B (16 x 32), both bf16 in shared
// memory, K-major, 128-byte swizzle; ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a,
                                             uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) = or += A (64 x 16) * B (16 x 64), both bf16 in shared
// memory, K-major, 128-byte swizzle; ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) = or += A (64 x 16) * B (16 x 128), both bf16 in shared
// memory, K-major, 128-byte swizzle; ``accumulate`` 0 overwrites D.
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

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, bf16 in
// shared memory, MN-major, 128-byte swizzle).
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

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, bf16
// in shared memory, MN-major, 128-byte swizzle).
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

// D (64 x 192, f32) += A (64 x 16, bf16 in registers) * B (16 x 192, bf16
// in shared memory, MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 80, f32) += A (64 x 16, bf16 in registers) * B (16 x 80, bf16 in
// shared memory, MN-major, 128-byte swizzle: a swizzle atom and 16 columns
// of the next, ``lbo`` bytes on).
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

// D (64 x N) += A (64 x 16, registers) * B (16 x N, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b) {
  static_assert(N == 64 || N == 80 || N == 128 || N == 192,
                "widths 64, 80, 128 or 192");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (N == 80) {
    wgmma_rs_n80(d, a, desc_b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n192(d, a, desc_b);
  }
}

// D (64 x N) = A (64 x K) B^T (N x K), both K-major in boxes of 64
// columns: A's boxes ``a_box`` bytes apart, B's ``b_box``; K in k16 steps
// (80: four in the first box, one in the second)
template <int K, int N>
__device__ __forceinline__ void wgmma_nt(float* d, uint32_t a, int a_box,
                                         uint32_t b, int b_box) {
  static_assert(N == 32 || N == 64 || N == 128, "tiles of 32, 64 or 128");
  static_assert(K % 16 == 0, "k16 steps");
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;   // 32 bytes along a swizzled row
    const uint64_t da = smem_desc(a + (ks / 4) * a_box + off, 16, 1024);
    const uint64_t db = smem_desc(b + (ks / 4) * b_box + off, 16, 1024);
    if constexpr (N == 32) {
      wgmma_ss_n32(d, da, db, ks > 0);
    } else if constexpr (N == 64) {
      wgmma_ss_n64(d, da, db, ks > 0);
    } else {
      wgmma_ss_n128(d, da, db, ks > 0);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 2^x on the special-function unit (ex2.approx, flush to zero: P's
// weights below 2^-126 are 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool live(int qi, int kj, int causal, int window) {
  return (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
}

// The tiles of head dims (HD, HDV): q, k, dq and dk rows are HD wide
// (HD / 64 boxes, rounded up: the last zero-filled past HD), v, o, dO and
// dv rows HDV.  A block holds kBig rows (two warpgroups of 64) and streams
// tiles of N rows: dq kN_q keys, dkv kN_kv queries.  128 at (64, 64); 64 at
// (128, 128), where dK and dV of a warpgroup take 128 registers a thread
// and S^T and dP^T of 64 x 128 would not fit beside them; 64 at (80, 80),
// whose two-box rows would need 256 KB of shared memory for three stages
// of 128-row tiles (dK and dV take 80 registers, S^T and dP^T 32 each); at
// (192, 128) dq streams 64 keys (dQ 96 registers, S and dP 32 each) and
// dkv 32 queries: dK and dV take 96 + 64 registers a thread, S^T and dP^T
// of 64 x 32 16 each, the peak of (128, 128) at 64.
template <int HD, int HDV>
struct Layout {
  static_assert((HD == 64 && HDV == 64) || (HD == 80 && HDV == 80) ||
                    (HD == 128 && HDV == 128) || (HD == 192 && HDV == 128),
                "head dims (64, 64), (80, 80), (128, 128) or (192, 128)");
  static constexpr int kNq = HD == 64 ? 128 : 64;
  static constexpr int kNkv = HD == 64 ? 128 : HD <= 128 ? 64 : 32;
  static constexpr int kChunks = (HD + kBox - 1) / kBox;  // boxes per row
  static constexpr int kChunksV = (HDV + kBox - 1) / kBox;
  static constexpr int kBigBox = kBig * kBoxBytes;        // 16 KB
  static constexpr int kBigQ = kChunks * kBigBox;         // 128 rows of HD
  static constexpr int kBigV = kChunksV * kBigBox;        // 128 rows of HDV
  // dq: Q and dO, then stages of K and V (kN_q rows)
  static constexpr int kQBox = kNq * kBoxBytes;
  static constexpr int kQK = kChunks * kQBox;             // the stage's K
  static constexpr int kDqStage = (kChunks + kChunksV) * kQBox;
  static constexpr int kDqSmem = 1024 + kBigQ + kBigV + kStages * kDqStage;
  // dkv: K and V, then stages of Q, dO (kN_kv rows), lse and delta, each
  // stage on a 1024-byte line (the swizzle's period)
  static constexpr int kKvBox = kNkv * kBoxBytes;
  static constexpr int kKvQ = kChunks * kKvBox;           // the stage's Q
  static constexpr int kKvTiles = (kChunks + kChunksV) * kKvBox;
  static constexpr int kDkvBytes = kKvTiles + 2 * kNkv * 4;
  static constexpr int kDkvStage = kKvTiles + 1024;
  static constexpr int kDkvSmem = 1024 + kBigQ + kBigV + kStages * kDkvStage;
  static_assert(2 * kNkv * 4 <= 1024, "lse and delta in a stage's line");
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
                "over a block's shared memory");
};

// ------------------------------------------------------------ dq kernel

// grid (H * B, query tiles of 128); causal: the heaviest tiles first
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
          float* __restrict__ lse_pad, float* __restrict__ delta_pad,
          int Sq, int Sk, int H, int KV, int causal, int window, int q_off,
          float scale_log2, float scale) {
  using L = Layout<HD, HDV>;
  constexpr int kN = L::kNq;
  extern __shared__ uint8_t smem_raw[];
  // Q and dO; per stage "full", and the count of its releases
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kBigQ;
  const uint32_t kv_s = do_s + L::kBigV;   // stage s: K then V
  auto k_stage = [&](int s) { return kv_s + s * L::kDqStage; };

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBig;
  const int q_last = min(q0 + kBig, Sq) - 1;
  const int n_tiles = (Sk + kN - 1) / kN;
  // the key tiles the block's query positions q0 + q_off .. reach
  const int t_hi = causal ? min(n_tiles, (q_last + q_off) / kN + 1)
                          : n_tiles;
  const int t_lo = window > 0 ? max(0, q0 + q_off - window + 1) / kN : 0;

  const int tid = threadIdx.x;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  // key tile t into stage i % kStages: by thread 0 for the first stages,
  // then by whichever warpgroup frees the stage last
  auto load_kv = [&](int t, int i) {
    const int s = i % kStages;
    mbar_expect_tx(bar_full(s), L::kDqStage);
    const uint32_t k_dst = k_stage(s), v_dst = k_dst + L::kQK;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(k_dst + c * L::kQBox, &tm_k, bar_full(s), c * kBox, kvh,
               t * kN, b);
#pragma unroll
    for (int c = 0; c < L::kChunksV; ++c)
      tma_load(v_dst + c * L::kQBox, &tm_v, bar_full(s), c * kBox, kvh,
               t * kN, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kBigQ + L::kBigV);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(q_s + c * L::kBigBox, &tm_q, bar_q, c * kBox, h, q0, b);
#pragma unroll
    for (int c = 0; c < L::kChunksV; ++c)
      tma_load(do_s + c * L::kBigBox, &tm_do, bar_q, c * kBox, h, q0, b);
    for (int j = 0; j < kStages && t_lo + j < t_hi; ++j)
      load_kv(t_lo + j, j);
  }

  // warpgroup wg holds queries 64 wg .. 64 wg + 63 of the block; a thread
  // the rows r0 and r1 = r0 + 8, the columns 2 (lane % 4) and + 1 of each
  // n8 block
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4, c_lane = 2 * quad;
  const int r0 = q0 + wg * kWG + warp * 16 + lane / 4, r1 = r0 + 8;
  const int wg_first = q0 + wg * kWG, wg_last = wg_first + kWG - 1;
  // the positions of the warpgroup's first and last rows
  const int pw_first = wg_first + q_off, pw_last = wg_last + q_off;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int Sq_pad = (Sq + kPad - 1) / kPad * kPad;

  // delta = rowsum(dO o O) of rows r0 and r1 (HDV wide): the row's quad
  // reads it in 16-byte pieces, lane ``quad`` the pieces quad, quad + 4, ..
  // (80 columns: 10 pieces, 3 for lanes 0 and 1, 2 for the others)
  constexpr int kPieces = HDV / 8;
  float dl[2], ls[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = e ? r1 : r0;
    float sum = 0.f;
    if (r < Sq) {
      const size_t row = ((static_cast<size_t>(b) * Sq + r) * H + h) * HDV;
#pragma unroll
      for (int p = 0; p < (kPieces + 3) / 4; ++p) {
        if (kPieces % 4 && quad + 4 * p >= kPieces) continue;
        const int col = 8 * (quad + 4 * p);
        const uint4 ov = *reinterpret_cast<const uint4*>(o + row + col);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + row + col);
        const uint32_t* oa = reinterpret_cast<const uint32_t*>(&ov);
        const uint32_t* da = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = unpack_bf16(oa[i]), y = unpack_bf16(da[i]);
          sum += x.x * y.x + x.y * y.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[e] = sum;
    ls[e] = r < Sq ? lse[bh * Sq + r] : 0.f;
    if (quad == 0) {                // rows past Sq: zeros, never read live
      delta_pad[bh * Sq_pad + r] = sum;
      lse_pad[bh * Sq_pad + r] = ls[e];
    }
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  const uint32_t q_wg = q_s + wg * kWG * kBoxBytes;
  const uint32_t do_wg = do_s + wg * kWG * kBoxBytes;

  // per tile: S and dP as two wgmma groups; P while dP runs; dS; dQ += dS
  // K; the stage freed once that product is done.  (Leaving a tile's last
  // product in flight behind the next tile's first made ptxas serialize
  // every wgmma, and exp2f in place of ex2.approx was slower, on the
  // card.)
  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int s = i % kStages;
    mbar_wait(bar_full(s), (i / kStages) & 1);
    const uint32_t k_s = k_stage(s), v_s = k_s + L::kQK;

    float sc[kN / 2], dp[kN / 2];
    wgmma_fence();
    wgmma_nt<HD, kN>(sc, q_wg, L::kBigBox, k_s, L::kQBox);
    wgmma_commit();
    wgmma_nt<HDV, kN>(dp, do_wg, L::kBigBox, v_s, L::kQBox);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<kN / 2>(sc);

    // P = exp2(S * scale log2(e) - lse), 0 where masked
    const int k0 = t * kN;
    const bool masked = k0 + kN > Sk || wg_last >= Sq ||
                        (causal && k0 + kN - 1 > pw_first) ||
                        (window > 0 && pw_last - k0 >= window);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1;
        float p = exp2_fast(sc[4 * j + e] * scale_log2 - ls[e / 2]);
        if (masked) {
          const int kj = k0 + 8 * j + c_lane + e % 2;
          if (kj >= Sk || r >= Sq || !live(r + q_off, kj, causal, window))
            p = 0.f;
        }
        sc[4 * j + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs<kN / 2>(dp);
    // dS = P o (dP - delta), rounded to bf16: the A fragments of dQ += dS K
    uint32_t ds[kN / 16][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      ds[j / 2][2 * (j % 2)] =
          pack_bf16(sc[4 * j] * (dp[4 * j] - dl[0]),
                    sc[4 * j + 1] * (dp[4 * j + 1] - dl[0]));
      ds[j / 2][2 * (j % 2) + 1] =
          pack_bf16(sc[4 * j + 2] * (dp[4 * j + 2] - dl[1]),
                    sc[4 * j + 3] * (dp[4 * j + 3] - dl[1]));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs<HD>(acc, ds[kk], smem_desc(k_s + kk * 16 * kBoxBytes,
                                          L::kQBox, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<HD / 2>(acc);
    // the second warpgroup to free the stage fills it with tile t + 3
    if (tid % 128 == 0 && atomicAdd(&released[s], 1) % 2 == 1 &&
        t + kStages < t_hi)
      load_kv(t + kStages, i + kStages);
  }

#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + c_lane;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + ((static_cast<size_t>(b) * Sq + r0) * H + h) * HD + col) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + ((static_cast<size_t>(b) * Sq + r1) * H + h) * HD + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

// ----------------------------------------------------------- dkv kernel

// grid (KV * B, key tiles of 128): every (batch, kv head)'s first key tile
// (the heaviest when causal) in the first wave
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_do,
           const float* __restrict__ lse_pad,
           const float* __restrict__ delta_pad,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int Sq, int Sk, int H, int KV, int causal, int window, int q_off,
           float scale_log2, float scale) {
  using L = Layout<HD, HDV>;
  constexpr int kN = L::kNkv;
  extern __shared__ uint8_t smem_raw[];
  // K and V; per stage "full", and the count of its releases
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::kBigQ;
  const uint32_t st_s = v_s + L::kBigV;
  // stage s: Q, dO, then kN floats of lse and kN of delta
  auto q_stage = [&](int s) { return st_s + s * L::kDkvStage; };
  const uint8_t* st_generic = smem_raw + (st_s - smem_u32(smem_raw));

  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * kBig;
  const int k_last = min(k0 + kBig, Sk) - 1;
  const int n_qt = (Sq + kN - 1) / kN;
  // the query tiles whose positions (row + q_off) reach the block's keys;
  // none past the last query (causal) or before the first (window): the
  // loop below then runs no tile and dK, dV come out zero
  const int qt_lo = causal ? max(0, k0 - q_off) / kN : 0;
  const int q_reach = k_last + window - 1 - q_off;   // the last row, window
  const int qt_hi = window <= 0 ? n_qt
                    : q_reach < 0 ? 0 : min(n_qt, q_reach / kN + 1);
  const int per_head = max(qt_hi - qt_lo, 0);
  const int n_it = G * per_head;
  const int Sq_pad = (Sq + kPad - 1) / kPad * kPad;

  const int tid = threadIdx.x;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto bar_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  // the i-th (q head, query tile) into stage i % kStages: by thread 0 for
  // the first stages, then by whichever warpgroup frees the stage last
  auto load_q = [&](int i) {
    const int h = kvh * G + i / per_head;
    const int qq = (qt_lo + i % per_head) * kN;
    const int s = i % kStages;
    mbar_expect_tx(bar_full(s), L::kDkvBytes);
    const uint32_t q_dst = q_stage(s), do_dst = q_dst + L::kKvQ;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(q_dst + c * L::kKvBox, &tm_q, bar_full(s), c * kBox, h, qq, b);
#pragma unroll
    for (int c = 0; c < L::kChunksV; ++c)
      tma_load(do_dst + c * L::kKvBox, &tm_do, bar_full(s), c * kBox, h, qq,
               b);
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq_pad + qq;
    const uint32_t ld_dst = q_dst + L::kKvTiles;
    bulk_load(ld_dst, lse_pad + row, kN * 4, bar_full(s));
    bulk_load(ld_dst + kN * 4, delta_pad + row, kN * 4, bar_full(s));
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, L::kBigQ + L::kBigV);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(k_s + c * L::kBigBox, &tm_k, bar_kv, c * kBox, kvh, k0, b);
#pragma unroll
    for (int c = 0; c < L::kChunksV; ++c)
      tma_load(v_s + c * L::kBigBox, &tm_v, bar_kv, c * kBox, kvh, k0, b);
    for (int j = 0; j < kStages && j < n_it; ++j) load_q(j);
  }

  // warpgroup wg holds keys k0 + 64 wg .. + 63; a thread the key rows kr0
  // and kr1 = kr0 + 8, the query columns 2 (lane % 4) and + 1 of each n8
  // block
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int c_lane = 2 * (lane % 4);
  const int kw0 = k0 + wg * kWG, kw_last = kw0 + kWG - 1;
  const int kr0 = kw0 + warp * 16 + lane / 4, kr1 = kr0 + 8;

  float dk_acc[HD / 2], dv_acc[HDV / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) dv_acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  const uint32_t k_wg = k_s + wg * kWG * kBoxBytes;
  const uint32_t v_wg = v_s + wg * kWG * kBoxBytes;

  // per tile: S^T and dP^T as two wgmma groups; P^T while dP^T runs;
  // dS^T; dV += P^T dO and dK += dS^T Q as one group; the stage freed
  // once it is done
  for (int i = 0; i < n_it; ++i) {
    const int q0 = (qt_lo + i % per_head) * kN;
    const int s = i % kStages;
    mbar_wait(bar_full(s), (i / kStages) & 1);
    const uint32_t q_st = q_stage(s), do_st = q_st + L::kKvQ;
    const float* ld = reinterpret_cast<const float*>(
        st_generic + s * L::kDkvStage + L::kKvTiles);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
    float sc[kN / 2], dp[kN / 2];
    wgmma_fence();
    wgmma_nt<HD, kN>(sc, k_wg, L::kBigBox, q_st, L::kKvBox);
    wgmma_commit();
    wgmma_nt<HDV, kN>(dp, v_wg, L::kBigBox, do_st, L::kKvBox);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<kN / 2>(sc);

    // P^T, rounded to bf16: the A fragments of dV += P^T dO
    const bool masked = kw_last >= Sk || q0 + kN > Sq ||
                        (causal && q0 + q_off < kw_last) ||
                        (window > 0 && q0 + q_off + kN - 1 - kw0 >= window);
    uint32_t pf[kN / 16][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ld + 8 * j + c_lane);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_fast(sc[4 * j + e] * scale_log2 -
                         (e % 2 ? l2.y : l2.x));
        if (masked) {
          const int qi = q0 + 8 * j + c_lane + e % 2;
          const int kj = e < 2 ? kr0 : kr1;
          if (kj >= Sk || qi >= Sq || !live(qi + q_off, kj, causal, window))
            p[e] = 0.f;
        }
      }
      pf[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pf[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    }
    wgmma_wait<0>();
    fence_regs<kN / 2>(dp);

    // dS^T = P^T o (dP^T - delta), P^T the rounded values of pf
    uint32_t ds[kN / 16][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(ld + kN + 8 * j + c_lane);
      const float2 pa = unpack_bf16(pf[j / 2][2 * (j % 2)]);
      const float2 pb = unpack_bf16(pf[j / 2][2 * (j % 2) + 1]);
      ds[j / 2][2 * (j % 2)] = pack_bf16(pa.x * (dp[4 * j] - d2.x),
                                         pa.y * (dp[4 * j + 1] - d2.y));
      ds[j / 2][2 * (j % 2) + 1] = pack_bf16(pb.x * (dp[4 * j + 2] - d2.x),
                                             pb.y * (dp[4 * j + 3] - d2.y));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs<HDV>(dv_acc, pf[kk], smem_desc(do_st + kk * 16 * kBoxBytes,
                                              L::kKvBox, 1024));
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs<HD>(dk_acc, ds[kk], smem_desc(q_st + kk * 16 * kBoxBytes,
                                             L::kKvBox, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<HDV / 2>(dv_acc);
    fence_regs<HD / 2>(dk_acc);
    // the second warpgroup to free the stage fills it with tile i + 3
    if (tid % 128 == 0 && atomicAdd(&released[s], 1) % 2 == 1 &&
        i + kStages < n_it)
      load_q(i + kStages);
  }

#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int kr = e ? kr1 : kr0;
    if (kr >= Sk) continue;
    const size_t row = (static_cast<size_t>(b) * Sk + kr) * KV + kvh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dk + row * HD + 8 * j + c_lane) =
          __floats2bfloat162_rn(dk_acc[4 * j + e] * scale,
                                dk_acc[4 * j + e + 1] * scale);
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dv + row * HDV + 8 * j + c_lane) =
          __floats2bfloat162_rn(dv_acc[4 * j + e], dv_acc[4 * j + e + 1]);
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
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* lse_pad, float* delta_pad, int B, int Sq, int Sk, int H,
           int KV, int causal, int window, int q_off, float scale,
           cudaStream_t stream) {
  using L = Layout<HD, HDV>;
  CUtensorMap tq_big, tdo_big, tk_small, tv_small;   // dq_kernel's
  CUtensorMap tk_big, tv_big, tq_small, tdo_small;   // dkv_kernel's
  if (!make_map(&tq_big, q, B, Sq, H, HD, kBig) ||
      !make_map(&tdo_big, dout, B, Sq, H, HDV, kBig) ||
      !make_map(&tk_small, k, B, Sk, KV, HD, L::kNq) ||
      !make_map(&tv_small, v, B, Sk, KV, HDV, L::kNq) ||
      !make_map(&tk_big, k, B, Sk, KV, HD, kBig) ||
      !make_map(&tv_big, v, B, Sk, KV, HDV, kBig) ||
      !make_map(&tq_small, q, B, Sq, H, HD, L::kNkv) ||
      !make_map(&tdo_small, dout, B, Sq, H, HDV, L::kNkv))
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the shared-memory limits once, at the first launch: not again
  // inside a CUDA-graph capture
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kDqSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkv_kernel<HD, HDV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const float scale_log2 = scale * kLog2e;
  const dim3 grid_q(H * B, (Sq + kBig - 1) / kBig);
  dq_kernel<HD, HDV><<<grid_q, kThreads, L::kDqSmem, stream>>>(
      tq_big, tdo_big, tk_small, tv_small,
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse,
      static_cast<__nv_bfloat16*>(dq), lse_pad, delta_pad, Sq, Sk, H, KV,
      causal, window, q_off, scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(KV * B, (Sk + kBig - 1) / kBig);
  dkv_kernel<HD, HDV><<<grid_kv, kThreads, L::kDkvSmem, stream>>>(
      tk_big, tv_big, tq_small, tdo_small, lse_pad, delta_pad,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Sk, H, KV, causal, window, q_off, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (q, k, v, o, do, lse, dq, dk, dv, lse_pad, delta_pad, B, Sq, Sk, H, KV,
// hd, hd_v, causal, window, q_off, scale, stream); q_off >= 0; (hd, hd_v)
// (64, 64), (80, 80), (128, 128) or (192, 128); lse_pad and delta_pad hold
// B * H * Sq_pad floats, Sq_pad = Sq rounded up to 128
extern "C" int repro_attention_bwd_tc(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* dk, void* dv,
                                      void* lse_pad, void* delta_pad, int B,
                                      int Sq, int Sk, int H, int KV, int hd,
                                      int hd_v, int causal, int window,
                                      int q_off, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  uintptr_t align = 0;
  for (const void* p : {q, k, v, o, dout, lse, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv),
                        static_cast<const void*>(lse_pad),
                        static_cast<const void*>(delta_pad)})
    align |= reinterpret_cast<uintptr_t>(p);
  if (KV <= 0 || H % KV != 0 || q_off < 0 || (align & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* lp = static_cast<float*>(lse_pad);
  float* dp = static_cast<float*>(delta_pad);
  if (hd == 64 && hd_v == 64)
    return launch<64, 64>(q, k, v, o, dout, l, dq, dk, dv, lp, dp, B, Sq, Sk,
                          H, KV, causal, window, q_off, scale, s);
  if (hd == 80 && hd_v == 80)
    return launch<80, 80>(q, k, v, o, dout, l, dq, dk, dv, lp, dp, B, Sq, Sk,
                          H, KV, causal, window, q_off, scale, s);
  if (hd == 128 && hd_v == 128)
    return launch<128, 128>(q, k, v, o, dout, l, dq, dk, dv, lp, dp, B, Sq,
                            Sk, H, KV, causal, window, q_off, scale, s);
  if (hd == 192 && hd_v == 128)
    return launch<192, 128>(q, k, v, o, dout, l, dq, dk, dv, lp, dp, B, Sq,
                            Sk, H, KV, causal, window, q_off, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

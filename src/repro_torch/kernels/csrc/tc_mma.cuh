// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by
// flash_attention.cu and moe_gmm.cu: cp.async copies into shared memory,
// ldmatrix, mma.sync in bf16 and TF32, and the 3xTF32 split that keeps an
// f32 product close to f32 accuracy on the TF32 tensor cores.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each f32 operand x is split into
// hi = rna_tf32(x) and lo = x - hi, which the tensor core truncates to TF32
// (an error of at most 2^-22 |x|, as large as the dropped lo*lo term); a
// product is then hi*hi + hi*lo + lo*hi, three TF32 MMAs accumulated in
// f32, the small terms first.  hi is rounded with integer operations (half
// of the dropped range added to the magnitude bits, then the low 13 bits
// cleared: round to nearest, ties away from zero, as cvt.rna.tf32.f32
// does for finite x), two instructions where the cvt took four to five in
// the SASS on the H100.  One TF32 product keeps
// about three decimal digits and would fail the f32 tolerances.  The
// tensor cores also truncate the f32 sum of each MMA to the accumulator's
// precision instead of rounding it: over a chain of hundreds of MMAs into
// one accumulator that bias grows to ~1e-4 of the result (measured on the
// H100 at K = 2048), so callers keep each chain short and add its result
// to an f32 sum on the CUDA cores, which rounds.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / k16"),
// with g = lane / 4 and t = lane % 4:
//  m16n8k8 TF32:  A a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4);
//                 B b0 (k t, n g) b1 (k t+4, n g);
//  m16n8k16 bf16: A a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..)
//                 a3 (g+8, 2t+8..); B b0 (k 2t..2t+1, n g) b1 (k 2t+8.., n g);
//  C (both):      c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; ``valid`` false
// writes 16 zero bytes and reads nothing (src must still be a global
// address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// x as a TF32 pair: hi = rna(x), lo = x - hi (exact in f32; its low 13
// bits are ignored by the MMA)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// d += a * b, m16n8k8, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32: the two cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t* bhi,
                                           const uint32_t* blo) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// d += a * b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp, denormal
// results flushed to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair, ``lo`` in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc

// Min-cover kernel for NVIDIA Hopper (sm_90a), loaded through ctypes.
//
// What it replaces: src/repro/kernels/gain.py::_pallas_call
// (``min_cover_lambdas``, the per-front path).  The device pass's find and
// its applies run in ``front_find.cu`` instead.
//
// It reduces one uncov row per (candidate, edge) pair: ``rows`` is (R, M)
// int32 in popcount-column order (column 0 is the empty subset), ``pc`` the
// (M,) popcounts with the no-cover sentinel 127 at column 0.  Per row
//     lam = min over columns c of (rows[r, c] == 0 ? pc[c] : 127)
// -- the masked-min formulation of the Pallas kernel.  The subsets with no
// uncovered pin always include the full processor set, so the first zero in
// popcount order equals this minimum; the kernel keeps the masked min and
// never stops at the first zero.
//
// Bound on the card: the work is a handful of integer operations per loaded
// element, so the kernel is memory-bound.  Bytes moved are R*M*4 (rows)
// + M*4 (pc) + R*4 (lam out), over the HBM rate (3.35 TB/s on an H100 SXM).
//
// Design: one warp per row, eight rows per 256-thread block.  The lanes
// stride over the M columns, so each step of the warp loads 128 contiguous
// bytes (coalesced); each lane keeps a running min, a shuffle reduction
// combines the 32 lanes, and lane 0 writes the row's result.  M = 2^P needs
// no padding (the TPU kernel padded columns to 128 lanes); for M < 32
// (P <= 4) the upper lanes idle.  The row index is uniform across a warp,
// so the early exit past the last row never splits a warp before the
// full-mask shuffles.  Launches go on the caller's stream and never
// synchronise; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kNoCover = 127;
constexpr int kWarpSize = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpSize * kWarpsPerBlock;

__device__ __forceinline__ int row_min_cover(const int* __restrict__ row,
                                             const int* __restrict__ pc,
                                             int M, int lane) {
  int m = kNoCover;
  for (int c = lane; c < M; c += kWarpSize) {
    const int v = row[c];
    m = min(m, v == 0 ? __ldg(pc + c) : kNoCover);
  }
#pragma unroll
  for (int off = kWarpSize / 2; off > 0; off >>= 1) {
    m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
min_cover_kernel(const int* __restrict__ rows, const int* __restrict__ pc,
                 int* __restrict__ out, int R, int M) {
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarpSize);
  const int lane = threadIdx.x % kWarpSize;
  if (r >= R) return;
  const int lam = row_min_cover(rows + static_cast<size_t>(r) * M, pc, M, lane);
  if (lane == 0) out[r] = lam;
}

unsigned grid_for(int R) {
  return static_cast<unsigned>((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int repro_min_cover(const void* rows, const void* pc, void* out,
                               int R, int M, void* stream) {
  if (R <= 0) return 0;
  min_cover_kernel<<<grid_for(R), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(pc),
      static_cast<int*>(out), R, M);
  return static_cast<int>(cudaGetLastError());
}

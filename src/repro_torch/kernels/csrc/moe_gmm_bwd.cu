// The backward pass of the MoE expert FFN's grouped matmul on Hopper's
// tensor cores (sm_90a), loaded through ctypes:
// ``kernels/moe_gmm.py::grouped_matmul_bwd``, the backward of the training
// path's grouped-matmul Function.
//
// What it stands for: the gradient of src/repro/kernels/moe_gmm.py::_kernel
// (the Pallas TPU kernel behind ``grouped_matmul``).  The JAX package has
// no backward of its own for that kernel -- jax.grad cannot differentiate
// its pallas_call -- so its training path only differentiates the jnp
// reference; this is what a backward of the Pallas kernel computes.  The
// forward, in the block-aligned layout of the dispatch buffers (x (G * C,
// D) holds G groups of C rows, rows r >= fills[g] of group g come out as
// exact zeros), is y[g*C + r] = x[g*C + r] @ w[g]; its gradients are
//     dx[g*C + r] = dy[g*C + r] @ w[g]^T         (r < fills[g], else 0)
//     dw[g]       = x[g, :fills[g]]^T @ dy[g, :fills[g]]
// x, dy, dx (G * C, D or F) and w, dw (G, D, F), contiguous and 16-byte
// aligned, all f32 or all bf16, D and F multiples of 8; ``fills`` G int32
// (clamped to [0, C]) or null for every row live.  Sums in f32, results in
// the inputs' dtype.  Rows past a fill send nothing into dw, whatever x and
// dy hold there, and their dx rows are exact zeros.
//
// Bound on the card.  Each product is 2 x live rows x D x F FLOPs against
// the live rows of x and dy, the live slots' weights and the outputs read
// or written once: at olmoe's training shape (64 slots of C = 2560, 2048
// <-> 1024, ~65,536 live rows of 163,840) 275 GFLOP a product against
// ~0.9 GB, so operations bound it, at 989 TFLOP/s in bf16 (0.278 ms) and
// 165 TFLOP/s in 3xTF32 f32 (1.67 ms).
//
// Design: two kernels on the caller's stream, no atomics, each output
// element summed by one thread in a fixed order, so a run repeats bit for
// bit.  Both are the forward ``general`` route's tile (moe_gmm.cu) with
// other operand layouts: a 128 x 128 output tile per block of 8 warps, 2
// (rows) x 4 (columns) of 64 x 32, operand tiles of 32 along the reduction
// by cp.async into a ring of stages (3 in bf16, 4 in f32), mma.sync
// m16n8k16 in bf16, 3xTF32 m16n8k8 in f32 with each stage's chain added to
// an f32 sum on the CUDA cores (tc_mma.cuh: a long chain of MMAs into one
// accumulator drifts).
//  * dx_kernel: rows of the group x columns of D, reducing over F.  Both
//    operands are K-major (dy's rows and w[g]'s rows have F contiguous):
//    tiles [128][32 + pad], fragments by ldmatrix (bf16) or scalar loads
//    whose 32 lanes hit distinct banks (f32).  A row tile at or past the
//    group's fill writes zeros and reads nothing; inside a partial tile the
//    rows past the fill load as zeros and are written as zeros.
//  * dw_kernel: D x F, one (D, F) tile per block (16 x 8 x 64 tiles at
//    olmoe's gate, ample parallelism without a split over the rows),
//    reducing over the group's first fills[g] rows only: a group with no
//    live row writes zeros and reads nothing.  Both operands are MN-major
//    (x's and dy's rows are the reduction): tiles [32][128 + 8], fragments
//    by ldmatrix.trans (bf16) or scalar loads (f32).
// The launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "tc_mma.cuh"

namespace {

constexpr int kTile = 128;           // output tile, rows and columns
constexpr int kBK = 32;              // reduction depth of a stage
constexpr int kThreads = 256;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the live rows of group g: fills[g] clamped to [0, C], or C without fills
__device__ __forceinline__ int group_fill(const int* fills, int g, int C) {
  return fills == nullptr ? C : min(max(fills[g], 0), C);
}

// zeros over rows [r0, min(r0 + kTile, M)) and columns [n0, min(n0 +
// kTile, N)) of an (M, N) output with N even
template <typename T>
__device__ void zero_tile(T* out, int r0, int n0, int M, int N) {
  const int nr = min(kTile, M - r0), nc = min(kTile, N - n0) / 2;
  for (int i = threadIdx.x; i < nr * nc; i += kThreads)
    store2(out + static_cast<size_t>(r0 + i / nc) * N + n0 + 2 * (i % nc),
           0.f, 0.f);
}

// shared-memory layout of one operand tile per stage: K-major [128][32 +
// pad] (dx: f32 rows 36 words, fragment loads 4 mod 32 words apart; bf16
// rows 80 bytes, ldmatrix's 8 rows on distinct 16-byte bank groups) or
// MN-major [32][128 + 8] (dw: f32 rows 8 mod 32 words apart; bf16 rows 272
// bytes, again distinct bank groups)
template <typename T, bool kDx>
struct Layout {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kStages = kF32 ? 4 : 3;
  static constexpr int kPiece = 16 / sizeof(T);      // elements per cp.async
  static constexpr int S = kDx ? kBK + (kF32 ? 4 : 8) : kTile + 8;
  static constexpr int kElems = kDx ? kTile * S : kBK * S;   // one tile
  static constexpr size_t kBytes = sizeof(T) * kStages * 2 * kElems;
};

// one block's output tile.  kDx: dx (G * C, D), tile (rows of group g,
// columns of D), reduction over F; else dw (G, D, F), tile (rows of D,
// columns of F), reduction over the group's live rows
template <typename T, bool kDx>
__device__ __forceinline__ void bwd_tile(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         const T* __restrict__ dy,
                                         T* __restrict__ out,
                                         const int* __restrict__ fills,
                                         int C, int D, int F) {
  using Lay = Layout<T, kDx>;
  constexpr int S = Lay::S, kStages = Lay::kStages, L = Lay::kPiece;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);       // [kStages][tile]
  T* Bs = As + kStages * Lay::kElems;           // [kStages][tile]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, wn = warp % 4;       // the warp's 64 x 32 tile
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const T* xg = x + static_cast<size_t>(g) * C * D;
  const T* wg = w + static_cast<size_t>(g) * D * F;
  const T* dyg = dy + static_cast<size_t>(g) * C * F;
  const int fill = group_fill(fills, g, C);
  const int M = kDx ? C : D, N = kDx ? D : F, K = kDx ? F : fill;
  T* og = out + static_cast<size_t>(g) * M * N;
  if (kDx ? m0 >= fill : fill == 0) {   // nothing live: zeros, no loads
    zero_tile(og, m0, n0, M, N);
    return;
  }

  auto load = [&](int kt, int st) {
    const int k0 = kt * kBK;
    T* a = As + st * Lay::kElems;
    T* b = Bs + st * Lay::kElems;
    if constexpr (kDx) {   // a: dy rows (live), b: w[g] rows; F contiguous
      for (int i = tid; i < kTile * (kBK / L); i += kThreads) {
        const int r = i / (kBK / L), c = (i % (kBK / L)) * L;
        const bool kok = k0 + c < F;
        const bool oka = kok && m0 + r < fill, okb = kok && n0 + r < D;
        tc::cp_async16(a + r * S + c,
                       oka ? dyg + static_cast<size_t>(m0 + r) * F + k0 + c
                           : dyg, oka);
        tc::cp_async16(b + r * S + c,
                       okb ? wg + static_cast<size_t>(n0 + r) * F + k0 + c
                           : wg, okb);
      }
    } else {               // a: x rows, b: dy rows, live rows only
      for (int i = tid; i < kBK * (kTile / L); i += kThreads) {
        const int kk = i / (kTile / L), c = (i % (kTile / L)) * L;
        const bool rok = k0 + kk < fill;
        const bool oka = rok && m0 + c < D, okb = rok && n0 + c < F;
        tc::cp_async16(a + kk * S + c,
                       oka ? xg + static_cast<size_t>(k0 + kk) * D + m0 + c
                           : xg, oka);
        tc::cp_async16(b + kk * S + c,
                       okb ? dyg + static_cast<size_t>(k0 + kk) * F + n0 + c
                           : dyg, okb);
      }
    }
  };

  // [m tile][n tile][fragment]: the tensor-core accumulators, and in f32
  // the sum of the stages' (``tot``)
  float acc[4][4][4], tot[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = tot[mi][ni][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kStages - 2>();           // tile kt has arrived
    __syncthreads();                            // and tile kt - 1 is done
    if (kt + kStages - 1 < nk)
      load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    tc::cp_async_commit();
    const T* a = As + (kt % kStages) * Lay::kElems +
                 (kDx ? wm * 64 * S : wm * 64);
    const T* b = Bs + (kt % kStages) * Lay::kElems +
                 (kDx ? wn * 32 * S : wn * 32);
    if constexpr (Lay::kF32) {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        // b0 (k t, n g), b1 (k t + 4, n g) of the four n tiles, split once
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* p = kDx ? b + (ni * 8 + g8) * S + ks + t4
                               : b + (ks + t4) * S + ni * 8 + g8;
          tc::split_tf32(p[0], bh[ni][0], bl[ni][0]);
          tc::split_tf32(p[kDx ? 4 : 4 * S], bh[ni][1], bl[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          // a0 (g, t) a1 (g + 8, t) a2 (g, t + 4) a3 (g + 8, t + 4)
          const float* p = kDx ? a + (mi * 16 + g8) * S + ks + t4
                               : a + (ks + t4) * S + mi * 16 + g8;
          const int r8 = kDx ? 8 * S : 8, k4 = kDx ? 4 : 4 * S;
          uint32_t ah[4], al[4];
          tc::split_tf32(p[0], ah[0], al[0]);
          tc::split_tf32(p[r8], ah[1], al[1]);
          tc::split_tf32(p[k4], ah[2], al[2]);
          tc::split_tf32(p[r8 + k4], ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            tc::mma_3xtf32(acc[mi][ni], ah, al, bh[ni], bl[ni]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[mi][ni][e] += acc[mi][ni][e];
            acc[mi][ni][e] = 0.f;
          }
    } else {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        // matrix i = lane / 8 of each ldmatrix: A (m 0-7 | 8-15, k 0-7 |
        // 8-15) as a0..a3; B (n 0-7, k 0-7 | 8-15), then n 8-15, as b0 b1
        // of two n tiles
        uint32_t af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if constexpr (kDx)
            tc::ldmatrix_x4(af[mi], a + (mi * 16 + lane % 16) * S + ks +
                                        (lane / 16) * 8);
          else
            tc::ldmatrix_x4_trans(
                af[mi], a + (ks + (lane / 16) * 8 + lane % 8) * S +
                            mi * 16 + ((lane / 8) % 2) * 8);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          if constexpr (kDx)
            tc::ldmatrix_x4(bf, b + (np * 16 + (lane / 16) * 8 + lane % 8) *
                                        S + ks + ((lane / 8) % 2) * 8);
          else
            tc::ldmatrix_x4_trans(
                bf, b + (ks + ((lane / 8) % 2) * 8 + lane % 8) * S +
                        np * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            tc::mma_bf16(acc[mi][2 * np], af[mi], bf);
            tc::mma_bf16(acc[mi][2 * np + 1], af[mi], bf + 2);
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  // c0 c1 (g, 2t..2t+1), c2 c3 (g + 8, ...): column pairs, N even
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + mi * 16 + g8 + 8 * h;
      if (r >= M) continue;
      const bool live = !kDx || r < fill;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (n >= N) continue;
        float v0, v1;
        if constexpr (Lay::kF32) {
          v0 = tot[mi][ni][2 * h];
          v1 = tot[mi][ni][2 * h + 1];
        } else {
          v0 = acc[mi][ni][2 * h];
          v1 = acc[mi][ni][2 * h + 1];
        }
        store2(og + static_cast<size_t>(r) * N + n, live ? v0 : 0.f,
               live ? v1 : 0.f);
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 1 : 2)
dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const T* __restrict__ dy, T* __restrict__ dx,
          const int* __restrict__ fills, int C, int D, int F) {
  bwd_tile<T, true>(x, w, dy, dx, fills, C, D, F);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 1 : 2)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const T* __restrict__ dy, T* __restrict__ dw,
          const int* __restrict__ fills, int C, int D, int F) {
  bwd_tile<T, false>(x, w, dy, dw, fills, C, D, F);
}

template <typename T, bool kDx>
cudaError_t launch(const T* x, const T* w, const T* dy, T* out,
                   const int* fills, int G, int C, int D, int F,
                   cudaStream_t stream) {
  // the shared-memory limit raised once per instantiation, at its first
  // launch (not again inside a CUDA-graph capture)
  static bool limit_set = false;
  constexpr size_t kBytes = Layout<T, kDx>::kBytes;
  auto kernel = kDx ? dx_kernel<T> : dw_kernel<T>;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kBytes));
    if (err != cudaSuccess) return err;
    limit_set = true;
  }
  const int M = kDx ? C : D, N = kDx ? D : F;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, G);
  kernel<<<grid, kThreads, kBytes, stream>>>(x, w, dy, out, fills, C, D, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* dy, void* dx,
                     void* dw, const int* fills, int G, int C, int D, int F,
                     cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  if (dx != nullptr) {
    const cudaError_t err = launch<T, true>(xt, wt, dyt, static_cast<T*>(dx),
                                            fills, G, C, D, F, s);
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr)
    return launch<T, false>(xt, wt, dyt, static_cast<T*>(dw), fills, G, C,
                            D, F, s);
  return cudaSuccess;
}

}  // namespace

// x (G*C, D), w (G, D, F), dy (G*C, F) -> dx (G*C, D) and dw (G, D, F);
// either output null skips its product; ``fills`` null or G int32.  The
// wrapper checks the shapes, G <= 65535 and the tile counts.
extern "C" int repro_grouped_matmul_bwd(const void* x, const void* w,
                                        const void* dy, void* dx, void* dw,
                                        const void* fills, int G, int C,
                                        int D, int F, int is_bf16,
                                        void* stream) {
  if (G == 0 || C == 0 || D == 0 || F == 0) return 0;
  if (D % 8 != 0 || F % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {x, w, dy, static_cast<const void*>(dx),
                        static_cast<const void*>(dw)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const int* f = static_cast<const int*>(fills);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, w, dy, dx, dw, f, G, C, D, F, s)
              : dispatch<float>(x, w, dy, dx, dw, f, G, C, D, F, s);
  return static_cast<int>(err);
}

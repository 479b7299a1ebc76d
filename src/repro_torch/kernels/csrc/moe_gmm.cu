// Grouped matmul of the MoE expert FFN for NVIDIA Hopper (sm_90a), loaded
// through ctypes: the routes ``gmv`` (decode) and ``general`` of
// ``kernels/moe_gmm.py``; bf16 prefill takes ``gmm_tc`` (moe_gmm_tc.cu).
//
// What it replaces: src/repro/kernels/moe_gmm.py::_kernel (the Pallas TPU
// kernel behind ``grouped_matmul``).  The rows come in the block-aligned
// layout of the MoE dispatch buffers: x (G * C, D) holds G groups of C
// rows, group g's rows multiply w[g] (D, F):
//     y[g * C + r, :] = x[g * C + r, :] @ w[g]          (f32 accumulation)
// x and w contiguous, both f32 or both bf16; y (G * C, F) in x's dtype.
// ``fills`` (G int32, or null for all C): rows r >= fills[g] of group g
// are written as exact zeros and cost no product (the rows the dispatch
// pads a slot with).  Any C, D, F >= 1: the TPU kernel's ``capacity %
// block_rows == 0`` goes away because a block's row tile never leaves its
// group (grid.z = group) and the ragged edges are masked.
//
// Bound on the card.  Decode (C = 1, G = 64, D = 2048, F = 1024 in bf16)
// reads every live slot's weights once for a handful of rows: 268 MB with
// every slot live, 80 us at 3.35 TB/s; the bytes bound it.  The general
// route's f32 prefill (C = 2560, D 2048 -> F 1024, 64 slots) does 687
// GFLOP with every row live against 2.5 GB: operations bound it, at 165
// TFLOP/s for an f32-accurate product on the tensor cores (three TF32
// products at 495 TFLOP/s; 4.17 ms).  The kernel this route replaces ran
// f32 FMAs on the CUDA cores (67 TFLOP/s, 19.1 ms reached).
//
// Design.  Global loads are 16-byte pieces (4 f32 or 8 bf16) where D and F
// allow; two paths:
//  * decode (C <= 16, ``gmv_kernel``): a block takes ROWS rows (1 where
//    C = 1, else 4) of one slot and 64 bf16 (32 f32) columns, so a slot's
//    weights spread over 16-32 blocks and a few live slots still fill the
//    card; a slot whose fill is 0 writes its zeros and never reads w[g].
//    w streams from device memory straight into registers, each weight
//    used once per row: 8 lanes of a warp cover the columns (128-byte
//    rows) and the 32 lane groups of the block split K, each with 4
//    pieces in flight; with 64 registers four blocks fit an SM, ~64 KB in
//    flight against HBM's latency.  x is read beside w, no staging and no
//    barrier before the reduction.  (Of 2-32 lanes on the columns, 2-16
//    pieces in flight and x staged in shared memory or not, this measured
//    fastest on the card, full and at a decode fill.)  Partial sums meet
//    in a fixed order (shuffles within a warp, then shared memory), so
//    results are deterministic.  CUDA-core FMAs in f32;
//  * otherwise (f32 prefill, or ragged D/F, ``gmm_kernel``): mma.sync on
//    the tensor cores, 3xTF32 for f32 (tc_mma.cuh: within ~1e-6 of an f32
//    product; one TF32 product would not hold the f32 tolerance) and
//    m16n8k16 for bf16; a 128 x 128 tile of 8 warps, each 64 x 32, x and
//    w tiles of 32 along D by cp.async into a ring of 3 stages; a row
//    tile past its group's fill writes zeros and exits.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the live rows of group g: fills[g] clamped to [0, C], or C without fills
__device__ __forceinline__ int group_fill(const int* fills, int g, int C) {
  return fills == nullptr ? C : min(max(fills[g], 0), C);
}

// zeros over rows [r0, min(r0 + rows, C)) and columns [n0, min(n0 + cols,
// F)) of group g's output: a tile past the group's fill
template <typename T>
__device__ void zero_tile(T* yg, int r0, int rows, int n0, int cols, int C,
                          int F) {
  const int nr = min(rows, C - r0), nc = min(cols, F - n0);
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x)
    store(yg + static_cast<size_t>(r0 + i / nc) * F + n0 + i % nc, 0.f);
}

// a piece: the 16 bytes at p (16-byte aligned) as f32, 4 or 8 elements
template <typename T>
struct Piece { static constexpr int kLen = 16 / sizeof(T); };

__device__ __forceinline__ void load_piece(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p,
                                           float* v) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32: the bits move up 16
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// the first ``valid`` elements of the piece at p, zeros for the rest; with
// VEC the extent is a multiple of the piece, so valid is 0 or >= a piece
template <bool VEC, typename T>
__device__ __forceinline__ void fetch_piece(const T* p, int valid,
                                            float* v) {
  constexpr int L = Piece<T>::kLen;
  if (VEC) {
    if (valid >= L) {
      load_piece(p, v);
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) v[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) v[i] = i < valid ? to_f32(p[i]) : 0.f;
  }
}

// The general path (f32, or D/F not a multiple of 8): a kBM x kBN output
// tile per block, 8 warps as 2 (rows) x 4 (columns) of 64 x 32, on the
// tensor cores: 3xTF32 m16n8k8 for f32, m16n8k16 for bf16.  x and w tiles
// of kBK along D come by cp.async (16-byte pieces, VEC) into a ring of
// kStages stages (3 in bf16, 4 in f32), the next tiles in flight while
// one is multiplied; ragged edges and rows past the fill are zero-filled.
// f32: each stage's products (12 MMAs per 16 x 8 tile) go into a fresh
// tensor-core accumulator that is then added to an f32 sum on the CUDA
// cores -- the tensor cores truncate each MMA's sum, which over D = 2048
// in one chain left the result ~1e-4 off (tc_mma.cuh) -- at 128 more
// registers a thread, so one block of 8 warps per SM.  w's tile is (kBK, kBN)
// with F contiguous: MN-major for the B operand, so f32's B fragments are
// scalar shared loads (row stride kBN + 8 words: 8 mod 32, the four k rows
// of a fragment on distinct banks) and bf16's come transposed by
// ldmatrix.trans.  Without VEC, element by element.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kGmmThreads = 256;

template <typename T>
struct GmmLayout {
  static constexpr int kStages = sizeof(T) == 4 ? 4 : 3;
  // x rows: kBK + 4 f32 (fragment loads at 4 mod 32 words apart) or + 8
  // bf16 (80 bytes: ldmatrix's 8 rows on distinct 16-byte bank groups)
  static constexpr int SA = kBK + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int SB = kBN + 8;
  static constexpr int kA = kBM * SA, kB = kBK * SB;   // one stage
  static constexpr size_t kBytes = sizeof(T) * kStages * (kA + kB);
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGmmThreads, sizeof(T) == 4 ? 1 : 2)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, const int* __restrict__ fills, int C, int D,
           int F) {
  using Lay = GmmLayout<T>;
  constexpr int SA = Lay::SA, SB = Lay::SB, kStages = Lay::kStages;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int L = Piece<T>::kLen;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);      // [kStages][kBM][SA]
  T* Bs = As + kStages * Lay::kA;              // [kStages][kBK][SB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, wn = warp % 4;    // the warp's 64 x 32 tile
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * kBM;           // row tile within the group
  const int n0 = blockIdx.x * kBN;
  const T* xg = x + static_cast<size_t>(g) * C * D;
  const T* wg = w + static_cast<size_t>(g) * D * F;
  T* yg = y + static_cast<size_t>(g) * C * F;
  const int fill = group_fill(fills, g, C);
  if (r0 >= fill) {                          // a dead tile: zeros, no loads
    zero_tile(yg, r0, kBM, n0, kBN, C, F);
    return;
  }

  auto load = [&](int kt, int st) {
    const int k0 = kt * kBK;
    T* a = As + st * Lay::kA;
    T* bt = Bs + st * Lay::kB;
    if (VEC) {
      for (int i = tid; i < kBM * (kBK / L); i += kGmmThreads) {
        const int r = i / (kBK / L), c = (i % (kBK / L)) * L;
        const bool ok = r0 + r < fill && k0 + c < D;
        tc::cp_async16(a + r * SA + c,
                       ok ? xg + static_cast<size_t>(r0 + r) * D + k0 + c : xg,
                       ok);
      }
      for (int i = tid; i < kBK * (kBN / L); i += kGmmThreads) {
        const int kk = i / (kBN / L), c = (i % (kBN / L)) * L;
        const bool ok = k0 + kk < D && n0 + c < F;
        tc::cp_async16(bt + kk * SB + c,
                       ok ? wg + static_cast<size_t>(k0 + kk) * F + n0 + c : wg,
                       ok);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kGmmThreads) {
        const int r = i / kBK, c = i % kBK;
        const bool ok = r0 + r < fill && k0 + c < D;
        a[r * SA + c] = ok ? xg[static_cast<size_t>(r0 + r) * D + k0 + c]
                           : T(0.f);
      }
      for (int i = tid; i < kBK * kBN; i += kGmmThreads) {
        const int kk = i / kBN, c = i % kBN;
        const bool ok = k0 + kk < D && n0 + c < F;
        bt[kk * SB + c] = ok ? wg[static_cast<size_t>(k0 + kk) * F + n0 + c]
                             : T(0.f);
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

  const int nk = (D + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kStages - 2>();        // tile kt has arrived
    __syncthreads();                         // and tile kt - 1 is done with
    if (kt + kStages - 1 < nk)
      load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    tc::cp_async_commit();
    const T* a = As + (kt % kStages) * Lay::kA + (wm * 64) * SA;
    const T* bt = Bs + (kt % kStages) * Lay::kB + wn * 32;
    if constexpr (kF32) {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        // the four n tiles' B fragments split once, then one m tile's A
        // fragment at a time (fewer live registers than all four A's)
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* p = bt + (ks + t4) * SB + ni * 8 + g8;
          tc::split_tf32(p[0], bh[ni][0], bl[ni][0]);
          tc::split_tf32(p[4 * SB], bh[ni][1], bl[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const float* p = a + (mi * 16 + g8) * SA + ks + t4;
          uint32_t ah[4], al[4];
          tc::split_tf32(p[0], ah[0], al[0]);
          tc::split_tf32(p[8 * SA], ah[1], al[1]);
          tc::split_tf32(p[4], ah[2], al[2]);
          tc::split_tf32(p[8 * SA + 4], ah[3], al[3]);
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
        uint32_t af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          tc::ldmatrix_x4(af[mi], a + (mi * 16 + lane % 16) * SA + ks +
                                      (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          tc::ldmatrix_x4_trans(
              bf, bt + (ks + ((lane / 8) % 2) * 8 + lane % 8) * SB +
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

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + wm * 64 + mi * 16 + g8 + (e >= 2 ? 8 : 0);
      if (r >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t4 + (e & 1);
        float val;
        if constexpr (kF32)
          val = tot[mi][ni][e];
        else
          val = acc[mi][ni][e];
        if (n < F)
          store(yg + static_cast<size_t>(r) * F + n, r < fill ? val : 0.f);
      }
    }
}

// The decode path (C <= 16): a product of a ROWS-row tile with BN =
// kGvLanesN pieces of columns of w, read straight into registers with no
// staging and no barrier before the reduction.  Lane l of a warp owns the
// piece n0 + (l % kGvLanesN) * L .. + L; the block's lane groups split K,
// group j taking rows j, j + kGvKLanes, ..., each with kGvUnroll pieces in
// flight, and load the x values of their rows beside them (the lanes of a
// group read the same address: one broadcast, from L2 after the first
// block).  The partial sums meet first within a warp (shuffles over the
// lane bits above the column lanes), then over the 8 warps in shared
// memory, in a fixed order.
constexpr int kGvThreads = 256, kGvLanesN = 8, kGvUnroll = 4;
constexpr int kGvKLanes = kGvThreads / kGvLanesN;   // lane groups on K

template <typename T, int ROWS, bool VEC>
__global__ void __launch_bounds__(kGvThreads, ROWS == 1 ? 3 : 2)
gmv_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, const int* __restrict__ fills, int C, int D,
           int F) {
  constexpr int L = Piece<T>::kLen;
  constexpr int BN = kGvLanesN * L;          // columns per block
  constexpr int WARPS = kGvThreads / 32;
  __shared__ float red[WARPS][ROWS][BN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nl = tid % kGvLanesN, kl = tid / kGvLanesN;
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * ROWS, n0 = blockIdx.x * BN;
  const int n = n0 + nl * L;
  const T* xg = x + static_cast<size_t>(g) * C * D;
  const T* wg = w + static_cast<size_t>(g) * D * F;
  T* yg = y + static_cast<size_t>(g) * C * F;
  const int fill = group_fill(fills, g, C);
  if (r0 >= fill) {                          // an empty slot: w is not read
    zero_tile(yg, r0, ROWS, n0, BN, C, F);
    return;
  }
  const int rows = min(ROWS, fill - r0);     // live rows of the tile

  float acc[ROWS][L];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < L; ++i) acc[r][i] = 0.f;

  for (int k = kl; k < D; k += kGvKLanes * kGvUnroll) {
    float wv[kGvUnroll][L], xv[kGvUnroll][ROWS];
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int kk = k + u * kGvKLanes;
      const bool ok = kk < D && n < F;
      fetch_piece<VEC>(ok ? wg + static_cast<size_t>(kk) * F + n : wg,
                       ok ? F - n : 0, wv[u]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        xv[u][r] = kk < D && r < rows
                       ? to_f32(xg[static_cast<size_t>(r0 + r) * D + kk])
                       : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < L; ++i)
          acc[r][i] = fmaf(xv[u][r], wv[u][i], acc[r][i]);
  }

  // the lane groups of a warp, then the 8 warps, in a fixed order
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float v = acc[r][i];
#pragma unroll
      for (int off = kGvLanesN; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < kGvLanesN) red[warp][r][nl * L + i] = v;
    }
  __syncthreads();
  for (int o = tid; o < ROWS * BN; o += kGvThreads) {
    const int r = o / BN, c = o % BN;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) sum += red[j][r][c];
    if (r0 + r < C && n0 + c < F)
      store(yg + static_cast<size_t>(r0 + r) * F + n0 + c,
            r < rows ? sum : 0.f);
  }
}

template <typename T, int ROWS>
void launch_gmv(const T* x, const T* w, T* y, const int* fills, int G, int C,
                int D, int F, bool vec, cudaStream_t stream) {
  constexpr int BN = kGvLanesN * Piece<T>::kLen;
  const dim3 grid((F + BN - 1) / BN, (C + ROWS - 1) / ROWS, G);
  if (vec)
    gmv_kernel<T, ROWS, true><<<grid, kGvThreads, 0, stream>>>(
        x, w, y, fills, C, D, F);
  else
    gmv_kernel<T, ROWS, false><<<grid, kGvThreads, 0, stream>>>(
        x, w, y, fills, C, D, F);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, const int* fills,
                     int G, int C, int D, int F, bool decode,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  constexpr int L = Piece<T>::kLen;
  const bool vec = D % L == 0 && F % L == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (decode) {
    if (C == 1)
      launch_gmv<T, 1>(xt, wt, yt, fills, G, C, D, F, vec, stream);
    else
      launch_gmv<T, 4>(xt, wt, yt, fills, G, C, D, F, vec, stream);
    return cudaGetLastError();
  }
  // 128 x 128 tiles of 8 warps on the tensor cores; the shared-memory
  // limit raised once per instantiation, at its first launch (not again
  // inside a CUDA-graph capture).  bf16 comes here only with D or F ragged
  // (``moe_gmm.route``; the rest takes gmm_tc), so its tiles are built
  // without VEC alone
  constexpr bool kVecTiles = sizeof(T) == 4;
  const bool vt = kVecTiles && vec;
  auto kernel = vt ? gmm_kernel<T, kVecTiles> : gmm_kernel<T, false>;
  static bool limit_set[2] = {false, false};
  if (!limit_set[vt]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(GmmLayout<T>::kBytes));
    if (err != cudaSuccess) return err;
    limit_set[vt] = true;
  }
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, G);
  kernel<<<grid, kGmmThreads, GmmLayout<T>::kBytes, stream>>>(xt, wt, yt,
                                                              fills, C, D, F);
  return cudaGetLastError();
}

}  // namespace

// x (G*C, D), w (G, D, F) -> y (G*C, F); ``fills`` null or G int32;
// ``decode`` picks the gmv path (C <= 16), else the tensor-core tiles.  The
// wrapper checks the shapes, G <= 65535 and the row-tile count.
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* y,
                                    const void* fills, int G, int C, int D,
                                    int F, int is_bf16, int decode,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 0 || C == 0 || F == 0) return static_cast<int>(cudaSuccess);
  const int* f = static_cast<const int*>(fills);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, w, y, f, G, C, D, F, decode != 0, s)
              : dispatch<float>(x, w, y, f, G, C, D, F, decode != 0, s);
  return static_cast<int>(err);
}

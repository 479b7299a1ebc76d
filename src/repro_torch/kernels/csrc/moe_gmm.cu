// Grouped matmul of the MoE expert FFN for NVIDIA Hopper (sm_90a), loaded
// through ctypes: the routes ``gmv`` (decode) and ``cuda_core`` of
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
// every slot live, 80 us at 3.35 TB/s; the bytes bound it.
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
//  * otherwise (f32 prefill, or ragged D/F, ``gmm_kernel``): CUDA-core
//    FMAs in f32, a 128 x 128 tile of 256 threads with 8 x 8 accumulators
//    each, tiles staged in shared memory as f32 per K chunk of 8; a row
//    tile past its group's fill writes zeros and exits.
// The f32 paths never touch the tensor cores, so no TF32 either.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The tiled CUDA-core path (f32, or D/F not a multiple of a piece): a
// (BM x BN) tile per block, TM x TN f32 accumulators per thread.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, const int* __restrict__ fills, int C, int D,
           int F) {
  constexpr int NTX = BN / TN;               // threads along the columns
  constexpr int NTY = BM / TM;               // threads along the rows
  constexpr int NT = NTX * NTY;
  constexpr int L = Piece<T>::kLen;          // elements per piece
  constexpr int XVECS = BM * BK / L;         // pieces per tile
  constexpr int WVECS = BK * BN / L;
  constexpr int XV = (XVECS + NT - 1) / NT;  // pieces per thread
  constexpr int WV = (WVECS + NT - 1) / NT;
  static_assert(BK % L == 0 && BN % L == 0, "tiles hold whole pieces");

  __shared__ float xs[BK][BM + 4];           // x tile, transposed
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX, ty = tid / NTX;
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * BM;            // row tile within the group
  const int n0 = blockIdx.x * BN;
  const T* xg = x + static_cast<size_t>(g) * C * D;
  const T* wg = w + static_cast<size_t>(g) * D * F;
  T* yg = y + static_cast<size_t>(g) * C * F;
  const int fill = group_fill(fills, g, C);
  if (r0 >= fill) {                          // a dead tile: zeros, no loads
    zero_tile(yg, r0, BM, n0, BN, C, F);
    return;
  }

  float xr[XV][L], wr[WV][L];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int idx = tid + j * NT;
      const int r = idx / (BK / L), k = k0 + (idx % (BK / L)) * L;
      const bool ok = idx < XVECS && r0 + r < fill && k < D;
      fetch_piece<VEC>(ok ? xg + static_cast<size_t>(r0 + r) * D + k : xg,
                       ok ? D - k : 0, xr[j]);
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int idx = tid + j * NT;
      const int k = k0 + idx / (BN / L), n = n0 + (idx % (BN / L)) * L;
      const bool ok = idx < WVECS && k < D && n < F;
      fetch_piece<VEC>(ok ? wg + static_cast<size_t>(k) * F + n : wg,
                       ok ? F - n : 0, wr[j]);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int idx = tid + j * NT;
      if (idx < XVECS) {
        const int r = idx / (BK / L), c = (idx % (BK / L)) * L;
#pragma unroll
        for (int i = 0; i < L; ++i) xs[c + i][r] = xr[j][i];
      }
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int idx = tid + j * NT;
      if (idx < WVECS) {
        const int kk = idx / (BN / L), c = (idx % (BN / L)) * L;
#pragma unroll
        for (int i = 0; i < L; i += 4)
          *reinterpret_cast<float4*>(&ws[kk][c + i]) = make_float4(
              wr[j][i], wr[j][i + 1], wr[j][i + 2], wr[j][i + 3]);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < D) fetch(k0 + BK);         // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * NTY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * NTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * NTY;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NTX;
      if (n < F)
        store(yg + static_cast<size_t>(r) * F + n, r < fill ? acc[i][j] : 0.f);
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
  // 128 x 128 tiles, 256 threads of 8 x 8
  const dim3 grid((F + 127) / 128, (C + 127) / 128, G);
  if (vec)
    gmm_kernel<T, 128, 128, 8, 8, 8, true><<<grid, 256, 0, stream>>>(
        xt, wt, yt, fills, C, D, F);
  else
    gmm_kernel<T, 128, 128, 8, 8, 8, false><<<grid, 256, 0, stream>>>(
        xt, wt, yt, fills, C, D, F);
  return cudaGetLastError();
}

}  // namespace

// x (G*C, D), w (G, D, F) -> y (G*C, F); ``fills`` null or G int32;
// ``decode`` picks the gmv path (C <= 16), else the CUDA-core tiles.  The
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

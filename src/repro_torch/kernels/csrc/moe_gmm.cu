// Grouped matmul of the MoE expert FFN for NVIDIA Hopper (sm_90a), loaded
// through ctypes.
//
// What it replaces: src/repro/kernels/moe_gmm.py::_kernel (the Pallas TPU
// kernel behind ``grouped_matmul``).  The rows come in the block-aligned
// layout of the MoE dispatch buffers: x (G * C, D) holds G groups of C
// rows, group g's rows multiply w[g] (D, F):
//     y[g * C + r, :] = x[g * C + r, :] @ w[g]          (f32 accumulation)
// x and w contiguous, both f32 or both bf16; y (G * C, F) in x's dtype.
// Any C, D, F >= 1: the TPU kernel's ``capacity % block_rows == 0`` goes
// away because a block's row tile never leaves its group (grid.z = group)
// and the ragged edges are masked.
//
// Bound on the card.  Decode (C = 1, G = 64, D = 2048, F = 1024 in bf16)
// reads every slot's weights once for a handful of rows: 268 MB, 80 us at
// 3.35 TB/s; the bytes bound it.  Prefill (C = 2560) is 687 GFLOP a call:
// 0.69 ms at the 989 TFLOP/s bf16 tensor-core rate; the operations bound it.
//
// Design, simple first.  Per block an output tile of one group; global
// loads are 16-byte pieces (4 f32 or 8 bf16) where D and F allow, and
// several are in flight per thread while the previous ones are used.
// Three paths:
//  * decode (C <= 16, ``gmv_kernel``): w streams from device memory
//    straight into registers, each weight used once for a 4-row tile of
//    x held in shared memory; 8 warps split K and meet in shared memory
//    at the end.  CUDA-core FMAs in f32;
//  * prefill in bf16 (C > 16, D and F multiples of 8,
//    ``gmm_wmma_kernel``): tensor cores through wmma 16x16x16 bf16
//    fragments with f32 accumulators, a 128 x 128 tile of 8 warps, x and
//    w tiles staged in shared memory per K chunk of 32;
//  * otherwise (f32, or ragged D/F, ``gmm_kernel``): CUDA-core FMAs in
//    f32, a 128 x 128 tile of 256 threads with 8 x 8 accumulators each,
//    tiles staged in shared memory as f32 per K chunk of 8.
// The f32 paths never touch the tensor cores, so no TF32 either.  wgmma
// with TMA and skipping row tiles past a slot's fill are later work.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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
           T* __restrict__ y, int C, int D, int F) {
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

  float xr[XV][L], wr[WV][L];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int idx = tid + j * NT;
      const int r = idx / (BK / L), k = k0 + (idx % (BK / L)) * L;
      const bool ok = idx < XVECS && r0 + r < C && k < D;
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

  T* yg = y + static_cast<size_t>(g) * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * NTY;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NTX;
      if (n < F) store(yg + static_cast<size_t>(r) * F + n, acc[i][j]);
    }
  }
}

// The decode path (C <= 16): a product of a 4-row tile with w, w read
// straight into registers, no staging.  Lane l of each warp owns the
// piece of columns n0 + l * L .. + L; the 8 warps split K (warp j takes
// rows j, j + 8, ...), each with 8 pieces in flight, and the x rows come
// from shared memory (one broadcast per row and k).  The warps' partial
// sums meet in shared memory at the end, in a fixed order.
constexpr int kGvRows = 4, kGvWarps = 8, kGvKC = 512, kGvUnroll = 8;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGvWarps * 32)
gmv_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, int C, int D, int F) {
  constexpr int L = Piece<T>::kLen;
  constexpr int BN = 32 * L;                 // columns per block
  __shared__ float xs[kGvRows][kGvKC];       // a K chunk of the x rows
  __shared__ float red[kGvWarps][kGvRows][BN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * kGvRows, n0 = blockIdx.x * BN;
  const int n = n0 + lane * L;
  const T* xg = x + static_cast<size_t>(g) * C * D;
  const T* wg = w + static_cast<size_t>(g) * D * F;

  float acc[kGvRows][L];
#pragma unroll
  for (int r = 0; r < kGvRows; ++r)
#pragma unroll
    for (int i = 0; i < L; ++i) acc[r][i] = 0.f;

  for (int kc = 0; kc < D; kc += kGvKC) {
    const int klen = min(kGvKC, D - kc);
    __syncthreads();                         // the last chunk is read
    for (int i = tid; i < kGvRows * kGvKC; i += kGvWarps * 32) {
      const int r = i / kGvKC, k = i % kGvKC;
      xs[r][k] = (r0 + r < C && k < klen)
                     ? to_f32(xg[static_cast<size_t>(r0 + r) * D + kc + k])
                     : 0.f;
    }
    __syncthreads();
    for (int k = warp; k < klen; k += kGvWarps * kGvUnroll) {
      float wv[kGvUnroll][L];
#pragma unroll
      for (int u = 0; u < kGvUnroll; ++u) {
        const int kk = k + u * kGvWarps;
        const bool ok = kk < klen && n < F;
        fetch_piece<VEC>(ok ? wg + static_cast<size_t>(kc + kk) * F + n : wg,
                         ok ? F - n : 0, wv[u]);
      }
#pragma unroll
      for (int u = 0; u < kGvUnroll; ++u) {
        const int kk = k + u * kGvWarps;
        if (kk < klen) {
#pragma unroll
          for (int r = 0; r < kGvRows; ++r) {
            const float xv = xs[r][kk];
#pragma unroll
            for (int i = 0; i < L; ++i)
              acc[r][i] = fmaf(xv, wv[u][i], acc[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kGvRows; ++r)
#pragma unroll
    for (int i = 0; i < L; ++i) red[warp][r][lane * L + i] = acc[r][i];
  __syncthreads();
  T* yg = y + static_cast<size_t>(g) * C * F;
  for (int o = tid; o < kGvRows * BN; o += kGvWarps * 32) {
    const int r = o / BN, c = o % BN;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kGvWarps; ++j) sum += red[j][r][c];
    if (r0 + r < C && n0 + c < F)
      store(yg + static_cast<size_t>(r0 + r) * F + n0 + c, sum);
  }
}

// The wide bf16 path on tensor cores: wmma 16x16x16 bf16 fragments with
// f32 accumulators.  A block of 8 warps computes a 128 x 128 tile of one
// group, each warp 32 x 64 (2 x 4 fragments); K is walked in chunks of 32,
// x and w tiles staged in shared memory as bf16 (rows padded by 8 against
// bank conflicts), the next chunk's 16-byte loads held in registers during
// the products.  Each accumulator fragment leaves through a per-warp f32
// staging tile, cast to bf16 and masked at the ragged edges.  Needs D and
// F multiples of 8 and 16-byte aligned pointers.
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32, kTcPad = 8;

__global__ void __launch_bounds__(256)
gmm_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ y, int C, int D, int F) {
  namespace wm = nvcuda::wmma;
  __shared__ __align__(32) __nv_bfloat16 xs[kTcBM][kTcBK + kTcPad];
  __shared__ __align__(32) __nv_bfloat16 ws[kTcBK][kTcBN + kTcPad];
  __shared__ __align__(32) float stage[8][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;    // 4 x 2 warps of 32 x 64
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const __nv_bfloat16* xg = x + static_cast<size_t>(g) * C * D;
  const __nv_bfloat16* wg = w + static_cast<size_t>(g) * D * F;

  // each tile is 512 pieces of 8 bf16: two per thread
  uint4 xr[2], wrg[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * 256;
      const int r = idx / (kTcBK / 8), kx = k0 + (idx % (kTcBK / 8)) * 8;
      xr[j] = (r0 + r < C && kx < D)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        xg + static_cast<size_t>(r0 + r) * D + kx))
                  : zero;
      const int kw = k0 + idx / (kTcBN / 8), n = n0 + (idx % (kTcBN / 8)) * 8;
      wrg[j] = (kw < D && n < F)
                   ? __ldg(reinterpret_cast<const uint4*>(
                         wg + static_cast<size_t>(kw) * F + n))
                   : zero;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * 256;
      *reinterpret_cast<uint4*>(
          &xs[idx / (kTcBK / 8)][(idx % (kTcBK / 8)) * 8]) = xr[j];
      *reinterpret_cast<uint4*>(
          &ws[idx / (kTcBN / 8)][(idx % (kTcBN / 8)) * 8]) = wrg[j];
    }
  };

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += kTcBK) {
    stash();
    __syncthreads();
    if (k0 + kTcBK < D) fetch(k0 + kTcBK);   // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major>
          a[2];
      wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major>
          b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wm::load_matrix_sync(a[i], &xs[wr * 32 + i * 16][kk], kTcBK + kTcPad);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wm::load_matrix_sync(b[j], &ws[kk][wc * 64 + j * 16], kTcBN + kTcPad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wm::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  __nv_bfloat16* yg = y + static_cast<size_t>(g) * C * F;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm::store_matrix_sync(stage[warp], acc[i][j], 16, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + wr * 32 + i * 16 + e / 16;
        const int n = n0 + wc * 64 + j * 16 + e % 16;
        if (r < C && n < F)
          store(yg + static_cast<size_t>(r) * F + n, stage[warp][e]);
      }
      __syncwarp();
    }
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, int G, int C,
                     int D, int F, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  constexpr int L = Piece<T>::kLen;
  const bool vec = D % L == 0 && F % L == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (C <= 16) {   // decode: 4-row tiles, 32 pieces of columns a block
    const dim3 grid((F + 32 * L - 1) / (32 * L),
                    (C + kGvRows - 1) / kGvRows, G);
    if (vec)
      gmv_kernel<T, true><<<grid, kGvWarps * 32, 0, stream>>>(
          xt, wt, yt, C, D, F);
    else
      gmv_kernel<T, false><<<grid, kGvWarps * 32, 0, stream>>>(
          xt, wt, yt, C, D, F);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2) {   // wide bf16: tensor cores (wmma)
    if (vec) {
      const dim3 grid((F + kTcBN - 1) / kTcBN, (C + kTcBM - 1) / kTcBM, G);
      gmm_wmma_kernel<<<grid, 256, 0, stream>>>(xt, wt, yt, C, D, F);
      return cudaGetLastError();
    }
  }
  // wide on CUDA cores: 128 x 128, 256 threads of 8 x 8
  const dim3 grid((F + 127) / 128, (C + 127) / 128, G);
  if (vec)
    gmm_kernel<T, 128, 128, 8, 8, 8, true><<<grid, 256, 0, stream>>>(
        xt, wt, yt, C, D, F);
  else
    gmm_kernel<T, 128, 128, 8, 8, 8, false><<<grid, 256, 0, stream>>>(
        xt, wt, yt, C, D, F);
  return cudaGetLastError();
}

}  // namespace

// x (G*C, D), w (G, D, F) -> y (G*C, F); the wrapper checks the shapes,
// G <= 65535 and the row-tile count.
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* y,
                                    int G, int C, int D, int F, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 0 || C == 0 || F == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, w, y, G, C, D, F, s)
              : dispatch<float>(x, w, y, G, C, D, F, s);
  return static_cast<int>(err);
}

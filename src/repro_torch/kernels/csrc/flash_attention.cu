// GQA attention with an online softmax for NVIDIA Hopper (sm_90a), loaded
// through ctypes.
//
// What it replaces: src/repro/kernels/flash_attention.py::_kernel (the
// Pallas TPU kernel behind ``flash_attention``).  It also computes the masks
// that the JAX package's ``ops.attention`` sends to its jnp reference
// (src/repro/kernels/ref.py::attention_reference): optional absolute
// positions q_pos (B, Sq) and k_pos (B, Sk), where k_pos < 0 is padding,
// ``causal`` keeps q_pos >= k_pos and ``window > 0`` keeps
// q_pos - k_pos < window.  Without positions they are arange(Sq) and
// arange(Sk), the Pallas kernel's causal mask.
//
// q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hdv), contiguous, all
// f32 or all bf16; o (B, Sq, H, hdv) in q's dtype.  hd, hdv <= 256.  The kv
// head of q head h is h / (H / KV); K and V are never copied per head.
//
// Numerics follow the Pallas kernel: q, k and v are upcast to f32, scores
// and p stay f32, the running max, normalizer and accumulator are f32;
// masked scores are -1e30 (not -inf) and the final denominator is clamped
// at 1e-30.  Keys past the end of the sequence (the ragged last tile)
// weigh exactly 0.  A key tile that no unmasked (query, key) pair of the
// block reaches is skipped, as the Pallas kernel skips causal tiles; the
// test is conservative (it may process a fully masked tile, never skip a
// live one), which changes nothing for a row with one unmasked key.
//
// Bound on the card: prefill (Sq = Sk = 2048, hd 64) does 4*B*H*Sq*Sk*hd
// FLOPs, about halved by the causal mask, against 2*B*(Sq*H + Sk*KV)*hd
// bytes: far above the H100's ~295 FLOP/byte, so it is bound by operations
// (989 TFLOP/s in bf16 on the tensor cores).  Decode (Sq = 1) reads the
// whole cache for a handful of FLOPs per byte and is bound by bytes.
//
// Design, simple first: CUDA cores and f32 FMAs, no tensor cores (no
// wgmma, no TMA) -- the f32 rate is 67 TFLOP/s, so prefill runs at most at
// ~7 % of the bf16 bound; a later PR moves the two products onto wgmma.
// One block of 256 threads (16 x 16) takes BQ = 16*RQ "rows" of one
// (batch, kv head): a row is a (query, q head of the kv group) pair, so the
// G heads that share a kv head share each K/V tile loaded into shared
// memory, and a decode step (Sq = 1) fills G rows of a block instead of 1.
// Each thread owns RQ rows (ty + 16 i) and 4 key columns (tx + 16 j) of
// the score tile and VC value columns (tx + 16 v) of the accumulator; the
// 16 threads of a row are 16 lanes of one warp, so the row max and row sum
// reduce with shuffles.  Q, K (transposed, padded by one column against
// bank conflicts), V and P tiles live in dynamic shared memory as f32.
// RQ = 1 when a (batch, kv head) has at most 16 rows (decode), else 4.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kTX = 16;              // lanes across key / value columns
constexpr int kTY = 16;              // thread rows across query rows
constexpr int kThreads = kTX * kTY;
constexpr int kBK = 64;              // keys per tile
constexpr int kCols = kBK / kTX;     // score columns per thread
constexpr int kMaxDim = 256;         // largest hd and hdv
constexpr float kMasked = -1e30f;    // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;   // (B, Sq) or null: arange(Sq)
  const int* k_pos;   // (B, Sk) or null: arange(Sk)
  int B, Sq, Sk, H, KV, hd, hdv, causal, window;
  float scale;
};

__device__ __forceinline__ bool unmasked(int qp, int kp, const Args& a) {
  return kp >= 0 && (!a.causal || qp >= kp) &&
         (a.window <= 0 || qp - kp < a.window);
}

__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int RQ, int hd, int hdv) {
  const int BQ = kTY * RQ;
  return sizeof(float) * (static_cast<size_t>(hd) * (BQ + 1) +
                          static_cast<size_t>(hd) * (kBK + 1) +
                          static_cast<size_t>(kBK) * hdv +
                          static_cast<size_t>(kBK) * (BQ + 1)) +
         sizeof(int) * (BQ + kBK);
}

template <typename T, int RQ, int VC>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int BQ = kTY * RQ;
  const int G = a.H / a.KV;
  const int rows = a.Sq * G;       // (query, head in group) rows of (b, kv)
  const int r0 = blockIdx.x * BQ;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int hd = a.hd, hdv = a.hdv;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  extern __shared__ float smem[];
  float* Qs = smem;                          // [hd][BQ + 1]
  float* Ks = Qs + hd * (BQ + 1);            // [hd][kBK + 1]
  float* Vs = Ks + hd * (kBK + 1);           // [kBK][hdv]
  float* Ps = Vs + kBK * hdv;                // [kBK][BQ + 1]
  int* qpos_s = reinterpret_cast<int*>(Ps + kBK * (BQ + 1));  // [BQ]
  int* kpos_s = qpos_s + BQ;                                  // [kBK]
  __shared__ int q_lo, q_hi;

  for (int i = threadIdx.x; i < BQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int row = r0 + r;
    float x = 0.f;
    if (row < rows) {
      const int qi = row / G, h = kv * G + row % G;
      x = to_f32(q[((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * hd + d]);
    }
    Qs[d * (BQ + 1) + r] = x;
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = r0 + r;
    int qp = 0;
    if (row < rows) {
      const int qi = row / G;
      qp = a.q_pos ? a.q_pos[static_cast<size_t>(b) * a.Sq + qi] : qi;
    }
    qpos_s[r] = qp;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = 0; r < BQ && r0 + r < rows; ++r) {
      lo = min(lo, qpos_s[r]);
      hi = max(hi, qpos_s[r]);
    }
    q_lo = lo;
    q_hi = hi;
  }
  __syncthreads();

  float m[RQ], l[RQ], acc[RQ][VC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (a.Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // the tile's key positions, and whether any key of it is unmasked for
    // some query of the block (conservative: q_lo/q_hi bound the rows)
    int live = 0;
    if (threadIdx.x < kBK) {
      const int kj = k0 + threadIdx.x;
      int kp = -1;
      if (kj < a.Sk) kp = a.k_pos ? a.k_pos[static_cast<size_t>(b) * a.Sk + kj] : kj;
      kpos_s[threadIdx.x] = kp;
      live = kj < a.Sk && kp >= 0 && (!a.causal || q_hi >= kp) &&
             (a.window <= 0 || q_lo - kp < a.window);
    }
    if (!__syncthreads_or(live)) continue;

    for (int i = threadIdx.x; i < kBK * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      const int kj = k0 + c;
      Ks[d * (kBK + 1) + c] =
          kj < a.Sk
              ? to_f32(k[((static_cast<size_t>(b) * a.Sk + kj) * a.KV + kv) * hd + d])
              : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * hdv; i += kThreads) {
      const int c = i / hdv, d = i % hdv;
      const int kj = k0 + c;
      Vs[c * hdv + d] =
          kj < a.Sk
              ? to_f32(v[((static_cast<size_t>(b) * a.Sk + kj) * a.KV + kv) * hdv + d])
              : 0.f;
    }
    __syncthreads();

    float s[RQ][kCols];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RQ], kv_[kCols];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[d * (BQ + 1) + ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv_[j] = Ks[d * (kBK + 1) + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = qpos_s[ty + kTY * i];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        float x = s[i][j] * a.scale;
        if (k0 + c >= a.Sk) x = -INFINITY;          // past the end: weight 0
        else if (!unmasked(qp, kpos_s[c], a)) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_reduce_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(tx + kTX * j) * (BQ + 1) + ty + kTY * i] = p;
      }
      sum = row_reduce_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < VC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[c * (BQ + 1) + ty + kTY * i];
#pragma unroll
      for (int vc = 0; vc < VC; ++vc) {
        const int col = tx + kTX * vc;
        const float x = col < hdv ? Vs[c * hdv + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][vc] = fmaf(pv[i], x, acc[i][vc]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = r0 + ty + kTY * i;
    if (row >= rows) continue;
    const int qi = row / G, h = kv * G + row % G;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * hdv;
#pragma unroll
    for (int vc = 0; vc < VC; ++vc) {
      const int col = tx + kTX * vc;
      if (col < hdv) store(out + col, acc[i][vc] / denom);
    }
  }
}

template <typename T, int RQ, int VC>
int launch(const Args& a, cudaStream_t stream) {
  const int rows = a.Sq * (a.H / a.KV);
  const int BQ = kTY * RQ;
  const size_t smem = smem_bytes(RQ, a.hd, a.hdv);
  // Raise the instantiation's shared-memory limit to the largest head dims
  // once, at its first launch: not again inside a CUDA-graph capture.
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, RQ, VC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(RQ, kMaxDim, kMaxDim)));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const dim3 grid((rows + BQ - 1) / BQ, a.KV, a.B);
  flash_kernel<T, RQ, VC><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RQ>
int launch_vc(const Args& a, cudaStream_t stream) {
  if (a.hdv <= 4 * kTX) return launch<T, RQ, 4>(a, stream);
  if (a.hdv <= 8 * kTX) return launch<T, RQ, 8>(a, stream);
  return launch<T, RQ, 16>(a, stream);
}

template <typename T>
int launch_rq(const Args& a, cudaStream_t stream) {
  if (a.Sq * (a.H / a.KV) <= kTY) return launch_vc<T, 1>(a, stream);
  return launch_vc<T, 4>(a, stream);
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const void* q_pos, const void* k_pos,
                                     int B, int Sq, int Sk, int H, int KV,
                                     int hd, int hdv, int causal, int window,
                                     float scale, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxDim || hdv <= 0 ||
      hdv > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<const int*>(q_pos),
               static_cast<const int*>(k_pos), B, Sq, Sk, H, KV, hd, hdv,
               causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_rq<__nv_bfloat16>(a, s) : launch_rq<float>(a, s);
}

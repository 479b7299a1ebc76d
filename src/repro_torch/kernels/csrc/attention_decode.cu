// Split-K decode attention (flash-decoding) for NVIDIA Hopper (sm_90a), f32
// or bf16, loaded through ctypes; the route ``decode_split`` of
// ``kernels/flash_attention.py``.
//
// What it replaces: the decode calls of src/repro/kernels/flash_attention.py
// ::_kernel's role that the JAX package's ``ops.attention`` sends to its jnp
// reference (src/repro/kernels/ref.py::attention_reference): one new token
// (or a few) per sequence against the whole cache, with absolute positions
// q_pos (B, Sq) and k_pos (B, Sk), k_pos < 0 padding, ``causal`` keeping
// q_pos >= k_pos and ``window > 0`` keeping q_pos - k_pos < window.
// Without positions they are arange(Sq) and arange(Sk).
//
// q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hdv), contiguous, all
// f32 or all bf16, 16-byte aligned; o (B, Sq, H, hdv) in q's dtype.  A
// (batch, kv head) holds R = Sq * (H / KV) <= 16 (query, head) rows; hd and
// hdv are 16-byte pieces times a power of two <= 32 (bf16 8..256, f32
// 4..128).
//
// Bound on the card: every cache element is read once for 2 R FLOPs, so the
// bytes bound it (3.35 TB/s), on CUDA cores; no tensor cores are needed.
//
// Design.  Grid (splits, KV, B): each block reads one contiguous range of
// ``chunk`` keys of one (batch, kv head) for all its R rows, so the cache
// is spread over splits * KV * B blocks (the wrapper's planner aims at two
// to four per SM, as the rows' registers allow).  The rows are a template
// argument (1..8 exactly, else 16), so a block holds no idle rows' queries
// and accumulators.  Inside a block, in sub-chunks of 256 keys:
//  * the key and query positions are read first; a sub-chunk where no row
//    has a live key is skipped, its K and V never read (a split that is
//    all padding or all future contributes m = -inf, l = 0);
//  * scores: a group of hd / 8 (bf16) or hd / 4 (f32) lanes reads one key
//    row with 16-byte loads, four keys per lane in flight, against the
//    rows' queries held in registers, and reduces the dot products with
//    shuffles; scaled scores (masked ones -1e30) go to shared memory.  The
//    first round of V loads is issued with the K loads;
//  * softmax: one warp per row updates the running max m and sum l (f32)
//    and turns the scores into weights;
//  * PV: a thread owns one 16-byte piece of hdv for a slot of keys and
//    accumulates f32 for all rows; slots meet in shared memory at the end,
//    the warps adding theirs in a fixed order.
// Each block writes its f32 partials (m, l, acc[hdv]) per row to a
// workspace the wrapper allocates; a second launch from the same entry
// point combines them (log-sum-exp weights, denominator clamped at 1e-30),
// one block per (kv head, batch row, row), and writes O.  A second launch
// rather than a last-block ticket: no counter has to live between calls or
// be reset, the combine order is fixed, and the combine reads only
// splits * R * (hdv + 2) floats.
// Liveness is decided for the block's rows together.  A row with no live
// key is written as 0 where no row of its (batch, kv head) has one, else
// as the mean of the values of the sub-chunks read; the jnp reference
// averages all of its values (never on the path: a decode row always sees
// its own key).
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 256;          // keys per sub-chunk in shared memory
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread
constexpr int kMaxRows = 16;
constexpr int kMaxSplits = 64;
constexpr int kMaxDim = 256;
constexpr float kMasked = -1e30f;  // the Pallas kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;   // (B, Sq) or null: arange(Sq)
  const int* k_pos;   // (B, Sk) or null: arange(Sk)
  float* ws_acc;      // (B, KV, splits, R, hdv)
  float* ws_m;        // (B, KV, splits, R)
  float* ws_l;        // (B, KV, splits, R)
  int B, Sq, Sk, H, KV, hd, hdv, causal, window, splits, chunk;
  float scale;
};

template <typename T>
struct Piece {
  static constexpr int kLen = 16 / sizeof(T);   // elements per 16 bytes
};

__device__ __forceinline__ void unpack(const uint4& t, float* x, float) {
  x[0] = __uint_as_float(t.x);
  x[1] = __uint_as_float(t.y);
  x[2] = __uint_as_float(t.z);
  x[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void unpack(const uint4& t, float* x,
                                       __nv_bfloat16) {
  const unsigned int u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32: the bits move up 16
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool unmasked(int qp, int kp, const Args& a) {
  return kp >= 0 && (!a.causal || qp >= kp) &&
         (a.window <= 0 || qp - kp < a.window);
}

// RQ: the rows R, or 16 for 9..16 rows (registers per lane)
template <typename T, int RQ>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  constexpr int VEC = Piece<T>::kLen;
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int R = a.Sq * G;
  const int j_begin = split * a.chunk;
  const int j_end = min(a.Sk, j_begin + a.chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* kb = static_cast<const T*>(a.k);
  const T* vb = static_cast<const T*>(a.v);

  __shared__ float sc[RQ][kSub];          // scores, then weights
  __shared__ int kpos_s[kSub];
  __shared__ int qpos_s[RQ];
  __shared__ float m_s[RQ], l_s[RQ], alpha_s[RQ];
  __shared__ float red[RQ * kMaxDim];     // the slots' sum of acc

  for (int r = tid; r < RQ; r += kThreads) {
    int qp = 0;
    if (r < R) {
      const int qi = r / G;
      qp = a.q_pos ? a.q_pos[static_cast<size_t>(b) * a.Sq + qi] : qi;
    }
    qpos_s[r] = qp;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < RQ * a.hdv; i += kThreads) red[i] = 0.f;

  // scores: a group of L lanes per key row, KPW keys per warp
  const int L = a.hd / VEC;
  const int kpw = 32 / L, kpb = kpw * kWarps;
  const int sub = lane % L, key_lane = warp * kpw + lane / L;
  float qr[RQ][VEC];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    if (r < R) {
      const int qi = r / G, h = kv * G + r % G;
      unpack(load16(static_cast<const T*>(a.q) +
                    ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * a.hd +
                    sub * VEC),
             qr[r], T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[r][e] = 0.f;
    }
  }
  // PV: a thread owns piece dv of hdv for key slot ``slot``
  const int Lv = a.hdv / VEC;
  const int slots = kThreads / Lv;
  const int dv = tid % Lv, slot = tid / Lv;
  float acc[RQ][VEC];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  __syncthreads();

  const size_t row_k = static_cast<size_t>(a.KV) * a.hd;
  const size_t row_v = static_cast<size_t>(a.KV) * a.hdv;
  const T* k_bk = kb + (static_cast<size_t>(b) * a.Sk) * row_k + kv * a.hd;
  const T* v_bk = vb + (static_cast<size_t>(b) * a.Sk) * row_v + kv * a.hdv;

  for (int c0 = j_begin; c0 < j_end; c0 += kSub) {
    const int n = min(kSub, j_end - c0);
    int any = 0;
    for (int i = tid; i < n; i += kThreads) {
      const int j = c0 + i;
      const int kp =
          a.k_pos ? __ldg(a.k_pos + static_cast<size_t>(b) * a.Sk + j) : j;
      kpos_s[i] = kp;
      for (int r = 0; r < R; ++r) {   // read here, not from qpos_s: no wait
        const int qi = r / G;
        const int qp =
            a.q_pos ? __ldg(a.q_pos + static_cast<size_t>(b) * a.Sq + qi) : qi;
        any |= unmasked(qp, kp, a);
      }
    }
    if (!__syncthreads_or(any)) continue;   // no live key: K, V not read

    // the first round of V is in flight with the K loads
    uint4 vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = slot + u * slots;
      vr[u] = i < n ? load16(v_bk + (c0 + i) * row_v + dv * VEC)
                    : make_uint4(0, 0, 0, 0);
    }

    for (int i0 = 0; i0 < n; i0 += kUnroll * kpb) {
      uint4 kr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kpb + key_lane;
        kr[u] = i < n ? load16(k_bk + (c0 + i) * row_k + sub * VEC)
                      : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC];
        unpack(kr[u], kf, T());
        float s[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          s[r] = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[r] = fmaf(qr[r][e], kf[e], s[r]);
        }
        for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int r = 0; r < RQ; ++r)
            s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
        }
        const int i = i0 + u * kpb + key_lane;
        if (sub == 0 && i < n) {
          const int kp = kpos_s[i];
#pragma unroll
          for (int r = 0; r < RQ; ++r)
            if (r < R)
              sc[r][i] = unmasked(qpos_s[r], kp, a) ? s[r] * a.scale : kMasked;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      float mx = -INFINITY;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[r][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);   // finite: n >= 1 scores
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(sc[r][i] - m_new);
        sc[r][i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 at the first
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const float alpha = r < R ? alpha_s[r] : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
    }
    for (int i0 = slot; i0 < n; i0 += kUnroll * slots) {
      if (i0 != slot) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * slots;
          vr[u] = i < n ? load16(v_bk + (c0 + i) * row_v + dv * VEC)
                        : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * slots;
        if (i >= n) break;
        float vf[VEC];
        unpack(vr[u], vf, T());
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          if (r < R) {
            const float p = sc[r][i];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][e] = fmaf(p, vf[e], acc[r][e]);
          }
        }
      }
    }
    __syncthreads();   // sc and kpos_s are rewritten by the next sub-chunk
  }

  // the slots' sums: shuffles within a warp, then one shared add per warp
  for (int off = 16; off >= Lv; off >>= 1) {
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
  }
  // the warps add theirs in warp order, not by atomics: a fixed order of
  // f32 sums, so that a call repeats bit for bit
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && lane < Lv) {
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        if (r < R)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            red[r * a.hdv + dv * VEC + e] += acc[r][e];
    }
    __syncthreads();
  }

  const size_t part = (static_cast<size_t>(b) * a.KV + kv) * a.splits + split;
  for (int i = tid; i < R * a.hdv; i += kThreads)
    a.ws_acc[part * R * a.hdv + i] = red[i];
  for (int r = tid; r < R; r += kThreads) {
    a.ws_m[part * R + r] = m_s[r];
    a.ws_l[part * R + r] = l_s[r];
  }
}

// One block per (kv head, batch row, row): a warp weighs the splits, then
// each thread sums one column of acc over them, eight loads in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(Args a) {
  const int kv = blockIdx.x, b = blockIdx.y, r = blockIdx.z;
  const int G = a.H / a.KV;
  const int R = a.Sq * G, NS = a.splits;
  const int tid = threadIdx.x;
  __shared__ float w_s[kMaxSplits];
  __shared__ float den_s;                   // 0: no live key at all
  const size_t first = (static_cast<size_t>(b) * a.KV + kv) * NS;

  if (tid < 32) {
    float m[kMaxSplits / 32], l[kMaxSplits / 32];
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxSplits / 32; ++i) {
      const int s = tid + 32 * i;
      m[i] = s < NS ? a.ws_m[(first + s) * R + r] : -INFINITY;
      l[i] = s < NS ? a.ws_l[(first + s) * R + r] : 0.f;
      M = fmaxf(M, m[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSplits / 32; ++i) {
      const int s = tid + 32 * i;
      const float w = m[i] == -INFINITY ? 0.f : expf(m[i] - M);
      if (s < NS) w_s[s] = w;
      den += w * l[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    if (tid == 0) den_s = M == -INFINITY ? 0.f : fmaxf(den, 1e-30f);
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o);
  const size_t stride = static_cast<size_t>(R) * a.hdv;   // between splits
  const int qi = r / G, h = kv * G + r % G;
  for (int d = tid; d < a.hdv; d += kThreads) {
    const float* acc = a.ws_acc + first * stride + r * a.hdv + d;
    float num = 0.f;   // dead splits hold zeros and weigh 0
#pragma unroll 8
    for (int s = 0; s < NS; ++s) num = fmaf(w_s[s], acc[s * stride], num);
    store(o + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * a.hdv + d,
          den_s == 0.f ? 0.f : num / den_s);
  }
}

template <typename T, int RQ>
int launch(const Args& a, cudaStream_t stream) {
  split_kernel<T, RQ><<<dim3(a.splits, a.KV, a.B), kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<T><<<dim3(a.KV, a.B, a.Sq * (a.H / a.KV)), kThreads, 0,
                      stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const Args& a, cudaStream_t stream) {
  switch (a.Sq * (a.H / a.KV)) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return launch<T, 16>(a, stream);
  }
}

bool pow2_pieces(int dim, int vec) {
  const int n = dim / vec;
  return dim % vec == 0 && n >= 1 && n <= 32 && (n & (n - 1)) == 0;
}

}  // namespace

extern "C" int repro_attention_decode_split(
    const void* q, const void* k, const void* v, void* o, const void* q_pos,
    const void* k_pos, void* ws, int B, int Sq, int Sk, int H, int KV,
    int hd, int hdv, int causal, int window, float scale, int is_bf16,
    int splits, int chunk, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  const int vec = is_bf16 ? 8 : 4;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (KV <= 0 || H % KV != 0 || Sq * (H / KV) > kMaxRows ||
      !pow2_pieces(hd, vec) || !pow2_pieces(hdv, vec) || hdv > kMaxDim ||
      splits < 1 || splits > kMaxSplits || chunk < 1 ||
      static_cast<long long>(splits) * chunk < Sk ||
      static_cast<long long>(splits - 1) * chunk >= Sk || (align & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = Sq * (H / KV);
  const size_t parts = static_cast<size_t>(B) * KV * splits * R;
  float* wsf = static_cast<float*>(ws);
  const Args a{q, k, v, o, static_cast<const int*>(q_pos),
               static_cast<const int*>(k_pos), wsf, wsf + parts * hdv,
               wsf + parts * (hdv + 1), B, Sq, Sk, H, KV, hd, hdv, causal,
               window, splits, chunk, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_rows<__nv_bfloat16>(a, s) : launch_rows<float>(a, s);
}

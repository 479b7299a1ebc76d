// The backward pass of GQA attention on Hopper's tensor cores (sm_90a),
// loaded through ctypes: ``kernels/flash_attention.py::attention_bwd``,
// the backward of the training path's attention Function.
//
// What it stands for: the gradient of src/repro/kernels/flash_attention.py
// ::_kernel (the Pallas TPU kernel behind ``flash_attention``).  The JAX
// package has no backward of its own for that kernel -- jax.grad cannot
// differentiate its pallas_call -- so its training path only differentiates
// the jnp reference; this is what a backward of the Pallas kernel computes:
// dq, dk and dv of softmax(q k^T * scale + mask) v, the mask being the
// kernel's causal one and the sliding window of ``ops.attention`` (no
// explicit positions: query i and key j sit at i + q_off and j; ``q_off``
// >= 0 is a rank's first position in a sequence split over ranks, 0 for a
// whole sequence).
//
// q (B, Sq, H, HD), k (B, Sk, KV, HD), v (B, Sk, KV, HDV), o, do (B, Sq, H,
// HDV), contiguous and 16-byte aligned, all f32 or all bf16; (HD, HDV) = (64,
// 64) or (128, 128), and hubert's (80, 80) and MLA's (192, 128) in f32 only
// (the bf16 calls take attention_bwd_tc.cu).  dq (B, Sq, H, HD), dk (B, Sk,
// KV, HD), dv (B, Sk, KV, HDV) come out in the same dtype; lse and delta (B,
// H, Sq) f32 are scratch.  The kv head of q head h is h / (H / KV).
// Every query row must keep at least one key (the wrapper raises
// otherwise), so the masked softmax weights are exactly 0.
//
// Arithmetic (FlashAttention-2's backward): with P = exp(S * scale - LSE),
//   delta = rowsum(dO o O),  dP = dO V^T,  dS = P o (dP - delta),
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G query heads of each kv head.  The LSE is
// recomputed here (the forward kernels do not write it).  bf16: P and dS
// are rounded to bf16 before their products (m16n8k16 MMAs, f32 sums);
// f32: every product in 3xTF32 (tc_mma.cuh), each tile's product summed in
// its own short chain and added on the CUDA cores.
//
// Bound on the card: per live (query, key) pair and q head, six products
// (S for the LSE, S again, dQ and dK of 2 HD FLOPs; dP and dV of 2 HDV)
// against a few
// bytes per element of q, k, v, o, dO and the three gradients: operations
// bound it, at 989 TFLOP/s in bf16 and 165 TFLOP/s in 3xTF32.  This kernel
// also recomputes S and dP in the dK/dV pass (eight products per pair).
//
// Design, two kernels on the caller's stream, no atomics:
// * dq_kernel, one block of 4 warps per (batch, q head, 64 queries), each
//   warp 16 query rows.  It stages Q and dO, computes delta from dO and O,
//   walks the key tiles the masks leave live once for the row max and sum
//   (LSE), then again for dP, dS and dQ += dS K, and writes dq, lse and
//   delta.  K and V tiles arrive by cp.async into a ring of two stages.
// * dkv_kernel, one block of 4 warps per (batch, kv head, 64 keys), each
//   warp 16 keys with dK and dV in registers.  It keeps its K and V rows in
//   shared memory and walks the G query heads of the kv head and, for each,
//   the query tiles that reach its keys (causal: from the first key on;
//   window: up to the last key plus the window), Q, dO, lse and delta by
//   cp.async in two stages; S^T = K Q^T and dP^T = V dO^T are formed per
//   tile, so P^T and dS^T are A fragments in registers as they stand.
// A tile the block's rows cannot reach is never loaded (a key block that
// no query reaches still writes its dK and dV: zeros); inside the tiles
// that are, every element is masked on its own.  Launches never
// synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>

#include "tc_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // queries of a dq block, keys of a dkv
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPad = 4;     // row padding in shared memory
  static constexpr int kPiece = 4;   // elements per 16-byte piece
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPad = 8;
  static constexpr int kPiece = 8;
};

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
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;     // (B, H, Sq), log2 units
  float* delta;   // (B, H, Sq)
  int B, Sq, Sk, H, KV, causal, window, q_off;
  float scale;
};

// query row qi (at position qi + q_off) and key kj
__device__ __forceinline__ bool live(int qi, int kj, const Args& a) {
  const int qp = qi + a.q_off;
  return qi < a.Sq && kj < a.Sk && (!a.causal || qp >= kj) &&
         (a.window <= 0 || qp - kj < a.window);
}

// N rows of HD elements into shared rows of ``stride``, 16-byte pieces by
// cp.async: row r from ``base + r * step`` where r < valid, zeros past it
template <typename T, int N, int HD>
__device__ __forceinline__ void load_tile(T* dst, int stride, const T* base,
                                          size_t step, int valid) {
  constexpr int L = Elem<T>::kPiece, PP = HD / L;
#pragma unroll
  for (int it = 0; it < (N * PP + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (N * PP % kThreads && i >= N * PP) continue;
    const int r = i / PP, c = (i % PP) * L;
    const bool ok = r < valid;
    tc::cp_async16(dst + r * stride + c, ok ? base + r * step + c : base, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// acc = A B^T: A the warp's 16 rows of HD (stride SA), B BN rows of HD
// (stride SB), both in shared memory; accumulator element (j, e) is row
// g + 8 (e / 2), column 8 j + 2 t + e % 2.  3xTF32, the hi*hi products
// apart from the cross terms (each chain HD / 8 long)
template <int HD, int BN, int SA, int SB>
__device__ __forceinline__ void nt(float (&acc)[BN / 8][4], const float* A,
                                   const float* Bm, int lane) {
  const int g = lane / 4, t = lane % 4;
  float sm[BN / 8][4];
  zero(acc);
  zero(sm);
#pragma unroll 2
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ah[4], al[4];
    const float* qa = A + g * SA + kk + t;
    tc::split_tf32(qa[0], ah[0], al[0]);
    tc::split_tf32(qa[8 * SA], ah[1], al[1]);
    tc::split_tf32(qa[4], ah[2], al[2]);
    tc::split_tf32(qa[8 * SA + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float* kb = Bm + (j * 8 + g) * SB + kk + t;
      uint32_t bh[2], bl[2];
      tc::split_tf32(kb[0], bh[0], bl[0]);
      tc::split_tf32(kb[4], bh[1], bl[1]);
      tc::mma_tf32(sm[j], al, bh);
      tc::mma_tf32(sm[j], ah, bl);
      tc::mma_tf32(acc[j], ah, bh);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += sm[j][e];
}

// acc = A B^T in bf16: A by ldmatrix, B two row tiles per ldmatrix
template <int HD, int BN, int SA, int SB>
__device__ __forceinline__ void nt(float (&acc)[BN / 8][4],
                                   const __nv_bfloat16* A,
                                   const __nv_bfloat16* Bm, int lane) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t af[4];
    tc::ldmatrix_x4(af, A + (lane % 16) * SA + kk + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < BN / 16; ++jp) {
      uint32_t bf[4];
      tc::ldmatrix_x4(bf, Bm + (jp * 16 + (lane / 16) * 8 + lane % 8) * SB +
                              kk + ((lane / 8) % 2) * 8);
      tc::mma_bf16(acc[2 * jp], af, bf);
      tc::mma_bf16(acc[2 * jp + 1], af, bf + 2);
    }
  }
}

// acc += P B: P (16 x BK) an accumulator in registers (layout of ``nt``),
// B (BK x HD) rows in shared memory (stride SB).  3xTF32: the product takes
// the k index of each 8-wide tile in the order 0, 2, 4, 6, 1, 3, 5, 7 (B's
// fragment loaded in that order), so P's accumulators are an A fragment as
// they stand; each 8-column slice gets the tile's product in its own chain
// of 3 BK / 8 MMAs, added to acc on the CUDA cores
template <int HD, int BK, int SB>
__device__ __forceinline__ void pa(float (&acc)[HD / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const float* Bm, int lane) {
  const int g = lane / 4, t = lane % 4;
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    tc::split_tf32(p[j][0], ph[j][0], pl[j][0]);
    tc::split_tf32(p[j][2], ph[j][1], pl[j][1]);
    tc::split_tf32(p[j][1], ph[j][2], pl[j][2]);
    tc::split_tf32(p[j][3], ph[j][3], pl[j][3]);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float* vb = Bm + (j * 8 + 2 * t) * SB + n * 8 + g;
      uint32_t bh[2], bl[2];
      tc::split_tf32(vb[0], bh[0], bl[0]);
      tc::split_tf32(vb[SB], bh[1], bl[1]);
      tc::mma_3xtf32(pv, ph[j], pl[j], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += pv[e];
  }
}

// acc += P B in bf16: P rounded to bf16 (two k tiles' accumulators make an
// A fragment), B's fragments by ldmatrix.trans
template <int HD, int BK, int SB>
__device__ __forceinline__ void pa(float (&acc)[HD / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const __nv_bfloat16* Bm, int lane) {
#pragma unroll
  for (int c = 0; c < BK / 16; ++c) {
    uint32_t af[4];
    af[0] = tc::pack_bf16(p[2 * c][0], p[2 * c][1]);
    af[1] = tc::pack_bf16(p[2 * c][2], p[2 * c][3]);
    af[2] = tc::pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]);
    af[3] = tc::pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bf[4];
      tc::ldmatrix_x4_trans(
          bf, Bm + (c * 16 + ((lane / 8) % 2) * 8 + lane % 8) * SB +
                  np * 16 + (lane / 16) * 8);
      tc::mma_bf16(acc[2 * np], af, bf);
      tc::mma_bf16(acc[2 * np + 1], af, bf + 2);
    }
  }
}

// ---------------------------------------------------------------- dq
// BK keys per tile; rows of HD (q, k) and HDV (v, o, do) elements
template <typename T, int HD, int HDV, int BK>
struct DqCfg {
  static constexpr int S = HD + Elem<T>::kPad;    // q and k row stride
  static constexpr int SV = HDV + Elem<T>::kPad;  // v and do row stride
  static constexpr size_t kBytes =
      sizeof(T) * static_cast<size_t>((kRows + 2 * BK) * (S + SV)) +
      sizeof(float) * kRows;
};

template <typename T, int HD, int HDV, int BK>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  using C = DqCfg<T, HD, HDV, BK>;
  constexpr int S = C::S, SV = C::SV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);          // [kRows][S]
  T* dOs = Qs + kRows * S;                     // [kRows][SV]
  T* Ks = dOs + kRows * SV;                    // [2][BK][S]
  T* Vs = Ks + 2 * BK * S;                     // [2][BK][SV]
  float* delta_s = reinterpret_cast<float*>(Vs + 2 * BK * SV);  // [kRows]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kv = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const size_t row_step = static_cast<size_t>(a.H) * HD;
  const size_t row_step_v = static_cast<size_t>(a.H) * HDV;
  const size_t key_step = static_cast<size_t>(a.KV) * HD;
  const size_t key_step_v = static_cast<size_t>(a.KV) * HDV;
  const size_t qrow = (static_cast<size_t>(b) * a.Sq + q0) * a.H + h;
  const size_t qoff = qrow * HD, ooff = qrow * HDV;
  const size_t krow = static_cast<size_t>(b) * a.Sk * a.KV + kv;
  const T* k_b = static_cast<const T*>(a.k) + krow * HD;
  const T* v_b = static_cast<const T*>(a.v) + krow * HDV;
  load_tile<T, kRows, HD>(Qs, S, static_cast<const T*>(a.q) + qoff, row_step,
                          a.Sq - q0);
  load_tile<T, kRows, HDV>(dOs, SV, static_cast<const T*>(a.dout) + ooff,
                           row_step_v, a.Sq - q0);
  tc::cp_async_commit();

  // the key tiles the block's queries reach
  const int q_last = min(q0 + kRows, a.Sq) - 1;
  const int k_lo = a.window > 0 ? max(0, q0 + a.q_off - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk - 1, q_last + a.q_off) : a.Sk - 1;
  const int t_begin = k_lo / BK, t_end = k_hi < k_lo ? t_begin : k_hi / BK + 1;
  const float sl2 = a.scale * kLog2e;
  int qi[2] = {q0 + wr + g, q0 + wr + g + 8};

  // pass 1: the row max and sum, in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (t_begin < t_end) {
    load_tile<T, BK, HD>(Ks, S, k_b + static_cast<size_t>(t_begin) * BK *
                                          key_step, key_step,
                         a.Sk - t_begin * BK);
    tc::cp_async_commit();
  }
  for (int tile = t_begin, st = 0; tile < t_end; ++tile, st ^= 1) {
    if (tile + 1 < t_end) {
      const int k1 = (tile + 1) * BK;
      load_tile<T, BK, HD>(Ks + (st ^ 1) * BK * S, S,
                           k_b + static_cast<size_t>(k1) * key_step,
                           key_step, a.Sk - k1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * BK;
    float s[BK / 8][4];
    nt<HD, BK, S, S>(s, Qs + wr * S, Ks + st * BK * S, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = live(qi[r], k0 + j * 8 + 2 * t + e, a)
                              ? s[j][2 * r + e] * sl2 : kMasked;
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      const float mn = fmaxf(m[r], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += tc::ex2(s[j][2 * r + e] - mn);
      l[r] = l[r] * tc::ex2(m[r] - mn) + sum;
      m[r] = mn;
    }
    __syncthreads();
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lse2[r] = m[r] + log2f(quad_sum(l[r]));

  // delta = rowsum(dO o O): two threads a row, half the row each
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float sum = 0.f;
    if (q0 + r < a.Sq) {
      const T* orow = static_cast<const T*>(a.o) + ooff + r * row_step_v;
      const T* drow = dOs + r * SV;
#pragma unroll 8
      for (int c = half * (HDV / 2); c < (half + 1) * (HDV / 2); ++c)
        sum += to_f32(drow[c]) * to_f32(orow[c]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[r] = sum;
      if (q0 + r < a.Sq)
        a.delta[(static_cast<size_t>(b) * a.H + h) * a.Sq + q0 + r] = sum;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qi[r] < a.Sq)
        a.lse[(static_cast<size_t>(b) * a.H + h) * a.Sq + qi[r]] = lse2[r];
  }
  __syncthreads();
  const float dl[2] = {delta_s[wr + g], delta_s[wr + g + 8]};

  // pass 2: dS and dQ += dS K
  float acc[HD / 8][4];
  zero(acc);
  auto issue = [&](int tile, int st) {
    const int k0 = tile * BK;
    load_tile<T, BK, HD>(Ks + st * BK * S, S,
                         k_b + static_cast<size_t>(k0) * key_step, key_step,
                         a.Sk - k0);
    load_tile<T, BK, HDV>(Vs + st * BK * SV, SV,
                          v_b + static_cast<size_t>(k0) * key_step_v,
                          key_step_v, a.Sk - k0);
  };
  if (t_begin < t_end) {
    issue(t_begin, 0);
    tc::cp_async_commit();
  }
  for (int tile = t_begin, st = 0; tile < t_end; ++tile, st ^= 1) {
    if (tile + 1 < t_end) {
      issue(tile + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * BK;
    const T* Kt = Ks + st * BK * S;
    float s[BK / 8][4], dp[BK / 8][4];
    nt<HD, BK, S, S>(s, Qs + wr * S, Kt, lane);
    nt<HDV, BK, SV, SV>(dp, dOs + wr * SV, Vs + st * BK * SV, lane);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float p = live(qi[r], k0 + j * 8 + 2 * t + e % 2, a)
                            ? tc::ex2(fmaf(s[j][e], sl2, -lse2[r])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]);
      }
    pa<HD, BK, S>(acc, s, Kt, lane);
    __syncthreads();
  }

  T* dq = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.Sq) continue;
    T* out = dq + (wr + g + 8 * r) * row_step;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store(out + n * 8 + 2 * t, acc[n][2 * r] * a.scale);
      store(out + n * 8 + 2 * t + 1, acc[n][2 * r + 1] * a.scale);
    }
  }
}

// --------------------------------------------------------------- dk, dv
// BQ queries per tile; rows of HD (q, k) and HDV (v, do) elements
template <typename T, int HD, int HDV, int BQ>
struct DkvCfg {
  static constexpr int S = HD + Elem<T>::kPad;
  static constexpr int SV = HDV + Elem<T>::kPad;
  static constexpr size_t kBytes =
      sizeof(T) * static_cast<size_t>((kRows + 2 * BQ) * (S + SV)) +
      sizeof(float) * 4 * BQ;
};

template <typename T, int HD, int HDV, int BQ>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  using C = DkvCfg<T, HD, HDV, BQ>;
  constexpr int S = C::S, SV = C::SV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);          // [kRows][S]
  T* Vs = Ks + kRows * S;                      // [kRows][SV]
  T* Qs = Vs + kRows * SV;                     // [2][BQ][S]
  T* dOs = Qs + 2 * BQ * S;                    // [2][BQ][SV]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * SV);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                 // [2][BQ]

  const int k0 = blockIdx.x * kRows, kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk = warp * 16;
  const size_t row_step = static_cast<size_t>(a.H) * HD;
  const size_t row_step_v = static_cast<size_t>(a.H) * HDV;
  const size_t key_step = static_cast<size_t>(a.KV) * HD;
  const size_t key_step_v = static_cast<size_t>(a.KV) * HDV;
  const size_t krow = (static_cast<size_t>(b) * a.Sk + k0) * a.KV + kv;
  const size_t koff = krow * HD, voff = krow * HDV;
  load_tile<T, kRows, HD>(Ks, S, static_cast<const T*>(a.k) + koff, key_step,
                          a.Sk - k0);
  load_tile<T, kRows, HDV>(Vs, SV, static_cast<const T*>(a.v) + voff,
                           key_step_v, a.Sk - k0);
  tc::cp_async_commit();

  // the query tiles that reach the block's keys, for each of the G heads
  const int k_last = min(k0 + kRows, a.Sk) - 1;
  // (rows: positions less q_off; none past the last row or before the
  // first, and then no tile runs and dK, dV come out zero)
  const int q_lo = a.causal ? max(0, k0 - a.q_off) : 0;
  const int q_hi = a.window > 0
                       ? min(a.Sq - 1, k_last + a.window - 1 - a.q_off)
                       : a.Sq - 1;
  const int qt0 = q_lo / BQ;
  const int n_qt = q_hi < q_lo ? 0 : q_hi / BQ - qt0 + 1;
  const int n = G * n_qt;
  auto issue = [&](int i, int st) {
    const int h = kv * G + i / n_qt, q0 = (qt0 + i % n_qt) * BQ;
    const size_t row = (static_cast<size_t>(b) * a.Sq + q0) * a.H + h;
    load_tile<T, BQ, HD>(Qs + st * BQ * S, S,
                         static_cast<const T*>(a.q) + row * HD, row_step,
                         a.Sq - q0);
    load_tile<T, BQ, HDV>(dOs + st * BQ * SV, SV,
                          static_cast<const T*>(a.dout) + row * HDV,
                          row_step_v, a.Sq - q0);
    const size_t rs = (static_cast<size_t>(b) * a.H + h) * a.Sq;
    if (threadIdx.x < 2 * BQ) {
      const int c = threadIdx.x % BQ, qi = q0 + c;
      const float* src = threadIdx.x < BQ ? a.lse : a.delta;
      float* dst = (threadIdx.x < BQ ? lse_s : dl_s) + st * BQ + c;
      tc::cp_async4(dst, src + rs + min(qi, a.Sq - 1), qi < a.Sq);
    }
  };
  float dK[HD / 8][4], dV[HDV / 8][4];
  zero(dK);
  zero(dV);
  const float sl2 = a.scale * kLog2e;
  const int kj[2] = {k0 + wk + g, k0 + wk + g + 8};
  if (n > 0) {
    issue(0, 0);
    tc::cp_async_commit();
  }
  for (int i = 0, st = 0; i < n; ++i, st ^= 1) {
    if (i + 1 < n) {
      issue(i + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + i % n_qt) * BQ;
    const T* Qt = Qs + st * BQ * S;
    const T* dOt = dOs + st * BQ * SV;
    const float* lt = lse_s + st * BQ;
    const float* dlt = dl_s + st * BQ;
    float s[BQ / 8][4], dp[BQ / 8][4];
    nt<HD, BQ, S, S>(s, Ks + wk * S, Qt, lane);      // S^T: keys x queries
    nt<HDV, BQ, SV, SV>(dp, Vs + wk * SV, dOt, lane);  // dP^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + e % 2;
        const float p = live(q0 + c, kj[e / 2], a)
                            ? tc::ex2(fmaf(s[j][e], sl2, -lt[c])) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dlt[c]);
      }
    pa<HDV, BQ, SV>(dV, s, dOt, lane);   // dV += P^T dO
    pa<HD, BQ, S>(dK, dp, Qt, lane);     // dK += dS^T Q
    __syncthreads();
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= a.Sk) continue;
    T* ok_ = static_cast<T*>(a.dk) + koff + (wk + g + 8 * r) * key_step;
    T* ov = static_cast<T*>(a.dv) + voff + (wk + g + 8 * r) * key_step_v;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      const int c = nn * 8 + 2 * t;
      store(ok_ + c, dK[nn][2 * r] * a.scale);
      store(ok_ + c + 1, dK[nn][2 * r + 1] * a.scale);
    }
#pragma unroll
    for (int nn = 0; nn < HDV / 8; ++nn) {
      const int c = nn * 8 + 2 * t;
      store(ov + c, dV[nn][2 * r]);
      store(ov + c + 1, dV[nn][2 * r + 1]);
    }
  }
}

// raise an instantiation's shared-memory limit once, at its first launch
// (not again inside a CUDA-graph capture)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

// tiles: bf16 64 keys (dq) and 64 or 32 queries (dkv, HD 64 or 128); f32
// 32 keys and 32 or 16 queries (HD 64, or 80, 128 and 192: a warp's dK and
// dV take 32 + 32, 40 + 40, 64 + 64 or 96 + 64 registers a thread, and a
// tile of 16 queries about 36 more for S^T, dP^T and the 3xTF32
// fragments) -- what the registers of one thread hold.  Rows of 80 are 20
// pieces of 16 bytes, 84 floats apart in shared memory: the fragments'
// reads stay on distinct banks, as at 68 and 132.
template <typename T, int HD, int HDV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int BK = kBf16 ? 64 : 32;
  constexpr int BQ = kBf16 ? (HD == 64 ? 64 : 32) : (HD == 64 ? 32 : 16);
  using Q = DqCfg<T, HD, HDV, BK>;
  using KVc = DkvCfg<T, HD, HDV, BQ>;
  static bool dq_ok = false, dkv_ok = false;
  cudaError_t err = allow_smem(dq_kernel<T, HD, HDV, BK>, Q::kBytes, dq_ok);
  if (err == cudaSuccess)
    err = allow_smem(dkv_kernel<T, HD, HDV, BQ>, KVc::kBytes, dkv_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g1((a.Sq + kRows - 1) / kRows, a.H, a.B);
  dq_kernel<T, HD, HDV, BK><<<g1, kThreads, Q::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((a.Sk + kRows - 1) / kRows, a.KV, a.B);
  dkv_kernel<T, HD, HDV, BQ><<<g2, kThreads, KVc::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// (hd, hd_v) = (64, 64), (128, 128), and (80, 80) and (192, 128) in f32
template <typename T>
int dispatch(const Args& a, int hd, int hd_v, cudaStream_t s) {
  if (hd == 64 && hd_v == 64) return launch<T, 64, 64>(a, s);
  if (hd == 128 && hd_v == 128) return launch<T, 128, 128>(a, s);
  if constexpr (sizeof(T) == 4) {
    if (hd == 80 && hd_v == 80) return launch<T, 80, 80>(a, s);
    if (hd == 192 && hd_v == 128) return launch<T, 192, 128>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int repro_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int hd_v, int causal, int window,
                                   int q_off, float scale, int is_bf16,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse),
               static_cast<float*>(delta), B, Sq, Sk, H, KV, causal, window,
               q_off, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, hd, hd_v, s)
                 : dispatch<float>(a, hd, hd_v, s);
}

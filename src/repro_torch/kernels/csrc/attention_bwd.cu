// The f32 backward pass of GQA attention on Hopper's tensor cores (sm_90a),
// loaded through ctypes: ``kernels/flash_attention.py::attention_bwd``'s
// ``general`` route, the backward of the training path's attention
// Function in f32 (bf16 takes attention_bwd_tc.cu).
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
// HDV), contiguous, 16-byte aligned, f32; (HD, HDV) = (64, 64), (80, 80),
// (128, 128) or (192, 128).  lse (B, H, Sq) f32 is the forward's row
// log-sum-exp in log2 units (flash_attention.cu and attention_prefill_tc.cu
// write it); dq, dk, dv come out f32; delta (B, H, Sq) f32 is scratch.  The
// kv head of q head h is h / (H / KV).  Every query row must keep at least
// one key (the wrapper raises otherwise), so the masked softmax weights are
// exactly 0.
//
// Arithmetic (FlashAttention-2's backward): with P = exp(S * scale - LSE),
//   delta = rowsum(dO o O),  dP = dO V^T,  dS = P o (dP - delta),
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G query heads of each kv head.  Every product
// in 3xTF32 (tc_mma.cuh: hi*hi + hi*lo + lo*hi of the rounded TF32 pairs),
// each tile's product summed in its own short chain and added on the CUDA
// cores.
//
// Bound on the card: per live (query, key) pair and q head, five products
// (S, dQ and dK of 2 HD FLOPs; dP and dV of 2 HDV) against a few bytes per
// element of q, k, v, o, dO and the three gradients: operations bound it,
// at 165 TFLOP/s in 3xTF32 (three TF32 products at 495).  Two kernels
// without atomics do seven: S and dP once for dQ and once for dK and dV.
//
// Design, two kernels on the caller's stream, no atomics:
// * dq_kernel, one block per (batch, q head, 64 queries), a strip of 16
//   query rows a warp.  It stages Q and dO, computes delta from dO and O,
//   takes each row's LSE from the forward, and walks the key tiles the
//   masks leave live once: S, dP, dS and dQ += dS K.  It writes dq and
//   delta.
// * dkv_kernel, one block per (batch, kv head, 64 keys), a strip of 16
//   keys a warp with dK and dV in registers.  It keeps its K and V rows in
//   shared memory and walks the G query heads of the kv head and, for each,
//   the query tiles that reach its keys (causal: from the first key on;
//   window: up to the last key plus the window), Q, dO, lse and delta by
//   cp.async; S^T = K Q^T and dP^T = V dO^T are formed per tile, so P^T and
//   dS^T are A fragments in registers as they stand.
// Tiles (K and V in dq, Q and dO in dkv) arrive by cp.async into a ring of
// two stages; every fragment is split into its TF32 pair where it is read
// (the probe's split-once variant -- a tile split into hi and lo planes
// when it lands -- ran slower: the planes' shared-memory traffic and the
// third stage outweighed the splits).  What held the first design back at
// (128, 128) and (192, 128) is latency: a block's rows and two stages of
// f32 tiles take 135-168 KB of shared memory, so one block of 4 warps --
// one warp a scheduler -- ran on an SM.  There two warps share each strip
// (8 a block, the register file's whole 64K at 255 a thread): dq's two
// warps of a strip take one half of each key tile each (at (192, 128)
// and (128, 128)), dkv's one half of each query tile (at (192, 128)),
// each holding its own dQ (dK and dV) partial sums, which the pair adds
// in shared memory at the end, the first warp's plus the second's: the
// same order every run.  Where registers already let several blocks
// share an SM, a strip keeps one warp.
// A tile the block's rows cannot reach is never loaded (a key block that
// no query reaches still writes its dK and dV: zeros); inside the tiles
// that are, every element is masked on its own.  Launches never
// synchronise; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>

#include "tc_mma.cuh"

namespace {

constexpr int kStrips = 4;           // strips of 16 rows a block
constexpr int kRows = 16 * kStrips;  // queries of a dq block, keys of a dkv
constexpr int kPad = 4;              // row padding in shared memory (floats)
constexpr float kLog2e = 1.4426950408889634f;

// the tiles of each head-dim pair: dq's keys a tile (BK) and warps a
// strip (WQ, each taking BK / WQ keys of a tile), dkv's queries a tile
// (BQ) and warps a strip (WKV).  A warp's dK and dV take HD / 2 + HDV / 2
// registers a thread, dq's dQ HD / 2, and its share of a tile's S, dP and
// P's TF32 pair about 5 (BK / WQ) / 2 more, within 255.  The probe's
// choice at each pair (probe_attention_bwd.py): at (128, 128) dkv's one
// block of 8 warps was no faster than two blocks of 4, and dq's 64-key
// tiles (32 a warp) faster than 32; at (64, 64) dkv's 16-query tiles, at
// three blocks an SM, slower than 32 at two (each A fragment's split then
// serves half as many columns)
template <int HD, int HDV>
struct Tiles {
  static constexpr int BK = HD == 128 ? 64 : 32;
  static constexpr int WQ = HD >= 128 ? 2 : 1;
  static constexpr int BQ = HD == 80 || HD == 128 ? 16 : 32;
  static constexpr int WKV = HD == 192 ? 2 : 1;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;   // (B, H, Sq), log2 units: the forward's
  float* dq;
  float* dk;
  float* dv;
  float* delta;       // (B, H, Sq)
  int B, Sq, Sk, H, KV, causal, window, q_off;
  float scale;
};

// query row qi (at position qi + q_off) and key kj
__device__ __forceinline__ bool live(int qi, int kj, const Args& a) {
  const int qp = qi + a.q_off;
  return qi < a.Sq && kj < a.Sk && (!a.causal || qp >= kj) &&
         (a.window <= 0 || qp - kj < a.window);
}

// N rows of HD floats into shared rows of ``stride`` by NT threads,
// 16-byte pieces by cp.async: row r from ``base + r * step`` where r <
// valid, zeros past it
template <int N, int HD, int NT>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* base, size_t step,
                                          int valid) {
  constexpr int PP = HD / 4;
#pragma unroll
  for (int it = 0; it < (N * PP + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (N * PP % NT && i >= N * PP) continue;
    const int r = i / PP, c = (i % PP) * 4;
    const bool ok = r < valid;
    tc::cp_async16(dst + r * stride + c, ok ? base + r * step + c : base, ok);
  }
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

// acc += P B: P (16 x BK) an accumulator in registers (layout of ``nt``),
// B (BK x HD) rows in shared memory (stride SB).  3xTF32: the product
// takes the k index of each 8-wide tile in the order 0, 2, 4, 6, 1, 3, 5,
// 7 (B's fragment loaded in that order), so P's accumulators are an A
// fragment as they stand; each 8-column slice gets the tile's product in
// its own chain of 3 BK / 8 MMAs, added to acc on the CUDA cores
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

// a pair's partial sums added, the strip's first warp's plus its second's:
// the second (half 1) writes its N accumulator tiles into ``red`` (16 rows
// a strip, stride N * 8 + kPad), the first adds them after a barrier.
// Every thread of the block calls it, its cp.async copies waited for: the
// first barrier frees ``red``
template <int N, int W>
__device__ __forceinline__ void pair_sum(float (&acc)[N][4], float* red,
                                         int strip, int half, int lane) {
  if constexpr (W == 2) {
    constexpr int SR = N * 8 + kPad;
    const int g = lane / 4, t = lane % 4;
    float* row = red + (strip * 16 + g) * SR + 2 * t;
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        row[n * 8] = acc[n][0];
        row[n * 8 + 1] = acc[n][1];
        row[8 * SR + n * 8] = acc[n][2];
        row[8 * SR + n * 8 + 1] = acc[n][3];
      }
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        acc[n][0] += row[n * 8];
        acc[n][1] += row[n * 8 + 1];
        acc[n][2] += row[8 * SR + n * 8];
        acc[n][3] += row[8 * SR + n * 8 + 1];
      }
    }
  }
}

// ---------------------------------------------------------------- dq
// BK keys per tile, BK / W a warp; rows of HD (q, k) and HDV (v, o, do)
// floats.  Shared: Q and dO rows, a ring of two K and V stages, delta
template <int HD, int HDV, int BK, int W>
struct DqCfg {
  static constexpr int kThreads = 32 * kStrips * W;
  static constexpr int S = HD + kPad;    // q and k row stride
  static constexpr int SV = HDV + kPad;  // v and do row stride
  static constexpr int kK = BK * S, kV = BK * SV;
  static constexpr size_t kBytes =
      sizeof(float) * (static_cast<size_t>(kRows) * (S + SV) +
                       2 * static_cast<size_t>(kK + kV) + kRows);
  static_assert(W == 1 || kRows * (HD + kPad) <= 2 * (kK + kV),
                "the pair's sums fit in the ring");
};

template <int HD, int HDV, int BK, int W>
__global__ void __launch_bounds__(DqCfg<HD, HDV, BK, W>::kThreads)
    dq_kernel(Args a) {
  using C = DqCfg<HD, HDV, BK, W>;
  constexpr int S = C::S, SV = C::SV, NT = C::kThreads, BN = BK / W;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [kRows][S]
  float* dOs = Qs + kRows * S;                  // [kRows][SV]
  float* Ks = dOs + kRows * SV;                 // [2][BK][S]
  float* Vs = Ks + 2 * C::kK;                   // [2][BK][SV]
  float* delta_s = Vs + 2 * C::kV;              // [kRows]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kv = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = warp % kStrips, half = warp / kStrips;
  const int wr = strip * 16, kh = half * BN;   // rows; keys of the tile
  const size_t row_step = static_cast<size_t>(a.H) * HD;
  const size_t row_step_v = static_cast<size_t>(a.H) * HDV;
  const size_t key_step = static_cast<size_t>(a.KV) * HD;
  const size_t key_step_v = static_cast<size_t>(a.KV) * HDV;
  const size_t qrow = (static_cast<size_t>(b) * a.Sq + q0) * a.H + h;
  const size_t qoff = qrow * HD, ooff = qrow * HDV;
  const size_t krow = static_cast<size_t>(b) * a.Sk * a.KV + kv;
  const float* k_b = a.k + krow * HD;
  const float* v_b = a.v + krow * HDV;
  const size_t rs = (static_cast<size_t>(b) * a.H + h) * a.Sq;
  load_tile<kRows, HD, NT>(Qs, S, a.q + qoff, row_step, a.Sq - q0);
  load_tile<kRows, HDV, NT>(dOs, SV, a.dout + ooff, row_step_v, a.Sq - q0);

  // the key tiles the block's queries reach
  const int q_last = min(q0 + kRows, a.Sq) - 1;
  const int k_lo = a.window > 0 ? max(0, q0 + a.q_off - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk - 1, q_last + a.q_off) : a.Sk - 1;
  const int t_begin = k_lo / BK, t_end = k_hi < k_lo ? t_begin : k_hi / BK + 1;
  auto issue = [&](int tile, int st) {
    const int k0 = tile * BK;
    load_tile<BK, HD, NT>(Ks + st * C::kK, S,
                          k_b + static_cast<size_t>(k0) * key_step, key_step,
                          a.Sk - k0);
    load_tile<BK, HDV, NT>(Vs + st * C::kV, SV,
                           v_b + static_cast<size_t>(k0) * key_step_v,
                           key_step_v, a.Sk - k0);
  };
  if (t_begin < t_end) issue(t_begin, 0);
  tc::cp_async_commit();                // Q, dO (and the first tile)

  const float sl2 = a.scale * kLog2e;
  const int qi[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = qi[r] < a.Sq ? a.lse[rs + qi[r]] : 0.f;

  // delta = rowsum(dO o O): NT / kRows threads a row, a part of the row
  // each (dO from global memory: its shared copy may not have landed)
  {
    constexpr int TR = NT / kRows;
    const int r = threadIdx.x / TR, part = threadIdx.x % TR;
    float sum = 0.f;
    if (q0 + r < a.Sq) {
      const float* orow = a.o + ooff + r * row_step_v;
      const float* drow = a.dout + ooff + r * row_step_v;
#pragma unroll 8
      for (int c = part * (HDV / TR); c < (part + 1) * (HDV / TR); ++c)
        sum += drow[c] * orow[c];
    }
#pragma unroll
    for (int o = 1; o < TR; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      delta_s[r] = sum;
      if (q0 + r < a.Sq) a.delta[rs + q0 + r] = sum;
    }
  }

  float acc[HD / 8][4];
  zero(acc);
  float dl[2] = {0.f, 0.f};
  for (int tile = t_begin, st = 0; tile < t_end; ++tile, st ^= 1) {
    if (tile + 1 < t_end) {
      issue(tile + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                    // the tile (and delta_s) in
    if (tile == t_begin) {
      dl[0] = delta_s[wr + g];
      dl[1] = delta_s[wr + g + 8];
    }
    const int k0 = tile * BK + kh;      // the warp's first key
    const float* Kt = Ks + st * C::kK + kh * S;
    float s[BN / 8][4], dp[BN / 8][4];
    nt<HD, BN, S, S>(s, Qs + wr * S, Kt, lane);
    nt<HDV, BN, SV, SV>(dp, dOs + wr * SV, Vs + st * C::kV + kh * SV, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float p = live(qi[r], k0 + j * 8 + 2 * t + e % 2, a)
                            ? tc::ex2(fmaf(s[j][e], sl2, -lse2[r])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]);
      }
    pa<HD, BN, S>(acc, s, Kt, lane);
    __syncthreads();                    // the stage is refilled next
  }
  tc::cp_async_wait<0>();
  pair_sum<HD / 8, W>(acc, Ks, strip, half, lane);   // in the ring

  if (half == 0) {
    float* dq = a.dq + qoff;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= a.Sq) continue;
      float* out = dq + (wr + g + 8 * r) * row_step;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        out[n * 8 + 2 * t] = acc[n][2 * r] * a.scale;
        out[n * 8 + 2 * t + 1] = acc[n][2 * r + 1] * a.scale;
      }
    }
  }
}

// --------------------------------------------------------------- dk, dv
// BQ queries per tile, BQ / W a warp; rows of HD (q, k) and HDV (v, do)
// floats.  Shared: K and V rows, a ring of two Q and dO stages with their
// lse and delta
template <int HD, int HDV, int BQ, int W>
struct DkvCfg {
  static constexpr int kThreads = 32 * kStrips * W;
  static constexpr int S = HD + kPad;
  static constexpr int SV = HDV + kPad;
  static constexpr int kQ = BQ * S, kO = BQ * SV;
  static constexpr size_t kBytes =
      sizeof(float) * (static_cast<size_t>(kRows) * (S + SV) +
                       2 * static_cast<size_t>(kQ + kO) + 4 * BQ);
  static_assert(2 * BQ <= kThreads, "a thread an lse or delta of a tile");
};

template <int HD, int HDV, int BQ, int W>
__global__ void __launch_bounds__(DkvCfg<HD, HDV, BQ, W>::kThreads)
    dkv_kernel(Args a) {
  using C = DkvCfg<HD, HDV, BQ, W>;
  constexpr int S = C::S, SV = C::SV, NT = C::kThreads, BN = BQ / W;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);   // [kRows][S]
  float* Vs = Ks + kRows * S;                   // [kRows][SV]
  float* Qs = Vs + kRows * SV;                  // [2][BQ][S]
  float* dOs = Qs + 2 * C::kQ;                  // [2][BQ][SV]
  float* lse_s = dOs + 2 * C::kO;               // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                 // [2][BQ]

  const int k0 = blockIdx.x * kRows, kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = warp % kStrips, half = warp / kStrips;
  const int wk = strip * 16, qh = half * BN;   // keys; queries of the tile
  const size_t row_step = static_cast<size_t>(a.H) * HD;
  const size_t row_step_v = static_cast<size_t>(a.H) * HDV;
  const size_t key_step = static_cast<size_t>(a.KV) * HD;
  const size_t key_step_v = static_cast<size_t>(a.KV) * HDV;
  const size_t krow = (static_cast<size_t>(b) * a.Sk + k0) * a.KV + kv;
  const size_t koff = krow * HD, voff = krow * HDV;
  load_tile<kRows, HD, NT>(Ks, S, a.k + koff, key_step, a.Sk - k0);
  load_tile<kRows, HDV, NT>(Vs, SV, a.v + voff, key_step_v, a.Sk - k0);

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
    load_tile<BQ, HD, NT>(Qs + st * C::kQ, S, a.q + row * HD, row_step,
                          a.Sq - q0);
    load_tile<BQ, HDV, NT>(dOs + st * C::kO, SV, a.dout + row * HDV,
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
  if (n > 0) issue(0, 0);
  tc::cp_async_commit();                // K, V (and the first tile)
  for (int i = 0, st = 0; i < n; ++i, st ^= 1) {
    if (i + 1 < n) {
      issue(i + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                    // the tile in
    const int q0 = (qt0 + i % n_qt) * BQ + qh;   // the warp's first query
    const float* Qt = Qs + st * C::kQ + qh * S;
    const float* dOt = dOs + st * C::kO + qh * SV;
    const float* lt = lse_s + st * BQ + qh;
    const float* dlt = dl_s + st * BQ + qh;
    float s[BN / 8][4], dp[BN / 8][4];
    nt<HD, BN, S, S>(s, Ks + wk * S, Qt, lane);        // S^T: keys x queries
    nt<HDV, BN, SV, SV>(dp, Vs + wk * SV, dOt, lane);  // dP^T
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + e % 2;
        const float p = live(q0 + c, kj[e / 2], a)
                            ? tc::ex2(fmaf(s[j][e], sl2, -lt[c])) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dlt[c]);
      }
    pa<HDV, BN, SV>(dV, s, dOt, lane);   // dV += P^T dO
    pa<HD, BN, S>(dK, dp, Qt, lane);     // dK += dS^T Q
    __syncthreads();                    // the stage is refilled next
  }
  tc::cp_async_wait<0>();
  // K and V are read no more: the pair's sums go where they were
  pair_sum<HD / 8, W>(dK, Ks, strip, half, lane);
  pair_sum<HDV / 8, W>(dV, Ks + kRows * (HD + kPad), strip, half, lane);

  if (half == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kj[r] >= a.Sk) continue;
      float* ok_ = a.dk + koff + (wk + g + 8 * r) * key_step;
      float* ov = a.dv + voff + (wk + g + 8 * r) * key_step_v;
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        const int c = nn * 8 + 2 * t;
        ok_[c] = dK[nn][2 * r] * a.scale;
        ok_[c + 1] = dK[nn][2 * r + 1] * a.scale;
      }
#pragma unroll
      for (int nn = 0; nn < HDV / 8; ++nn) {
        const int c = nn * 8 + 2 * t;
        ov[c] = dV[nn][2 * r];
        ov[c + 1] = dV[nn][2 * r + 1];
      }
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

template <int HD, int HDV>
struct Launch {
  static constexpr int BK = Tiles<HD, HDV>::BK, BQ = Tiles<HD, HDV>::BQ;
  static constexpr int WQ = Tiles<HD, HDV>::WQ, WKV = Tiles<HD, HDV>::WKV;
  using Q = DqCfg<HD, HDV, BK, WQ>;
  using KVc = DkvCfg<HD, HDV, BQ, WKV>;

  static cudaError_t allow() {
    static bool dq_ok = false, dkv_ok = false;
    cudaError_t err =
        allow_smem(dq_kernel<HD, HDV, BK, WQ>, Q::kBytes, dq_ok);
    if (err == cudaSuccess)
      err = allow_smem(dkv_kernel<HD, HDV, BQ, WKV>, KVc::kBytes, dkv_ok);
    return err;
  }

  static int run(const Args& a, cudaStream_t stream) {
    cudaError_t err = allow();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 g1((a.Sq + kRows - 1) / kRows, a.H, a.B);
    dq_kernel<HD, HDV, BK, WQ><<<g1, Q::kThreads, Q::kBytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 g2((a.Sk + kRows - 1) / kRows, a.KV, a.B);
    dkv_kernel<HD, HDV, BQ, WKV>
        <<<g2, KVc::kThreads, KVc::kBytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  // dq's and dkv's blocks an SM, registers a thread and local (spilled)
  // bytes a thread, and their tiles
  static int report(int* out) {
    cudaError_t err = allow();
    cudaFuncAttributes fa{}, fb{};
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, dq_kernel<HD, HDV, BK, WQ>, Q::kThreads, Q::kBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out + 1, dkv_kernel<HD, HDV, BQ, WKV>, KVc::kThreads, KVc::kBytes);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, dq_kernel<HD, HDV, BK, WQ>);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fb, dkv_kernel<HD, HDV, BQ, WKV>);
    out[2] = fa.numRegs;
    out[3] = fb.numRegs;
    out[4] = static_cast<int>(fa.localSizeBytes);
    out[5] = static_cast<int>(fb.localSizeBytes);
    out[6] = BK;
    out[7] = BQ;
    out[8] = WQ;
    out[9] = WKV;
    return static_cast<int>(err);
  }
};

// (hd, hd_v) = (64, 64), (80, 80), (128, 128) or (192, 128): f(Launch) of
// the pair
template <typename F>
int dispatch(int hd, int hd_v, F f) {
  if (hd == 64 && hd_v == 64) return f(Launch<64, 64>{});
  if (hd == 80 && hd_v == 80) return f(Launch<80, 80>{});
  if (hd == 128 && hd_v == 128) return f(Launch<128, 128>{});
  if (hd == 192 && hd_v == 128) return f(Launch<192, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int repro_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int hd_v, int causal, int window,
                                   int q_off, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(o),
               static_cast<const float*>(dout),
               static_cast<const float*>(lse), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(delta), B, Sq, Sk, H, KV, causal,
               window, q_off, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(hd, hd_v, [&](auto l) { return l.run(a, s); });
}

// (hd, hd_v)'s kernels on the current device: out[0..9] = dq's and dkv's
// blocks an SM, registers a thread, local bytes a thread, dq's BK, dkv's
// BQ and the two kernels' warps a strip (``probe_attention_bwd.py``
// prints them)
extern "C" int repro_attention_bwd_report(int hd, int hd_v, int* out) {
  return dispatch(hd, hd_v, [&](auto l) { return l.report(out); });
}

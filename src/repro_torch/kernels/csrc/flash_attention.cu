// GQA attention with an online softmax on Hopper's tensor cores (sm_90a),
// loaded through ctypes: the ``general`` route of
// ``kernels/flash_attention.py`` (any head dims up to 256, f32 or bf16,
// windows and explicit positions).
//
// What it replaces: src/repro/kernels/flash_attention.py::_kernel (the
// Pallas TPU kernel behind ``flash_attention``).  It also computes the masks
// that the JAX package's ``ops.attention`` sends to its jnp reference
// (src/repro/kernels/ref.py::attention_reference): optional absolute
// positions q_pos (B, Sq) and k_pos (B, Sk), where k_pos < 0 is padding,
// ``causal`` keeps q_pos >= k_pos and ``window > 0`` keeps
// q_pos - k_pos < window.  Without positions they are q_off + arange(Sq)
// and arange(Sk): with q_off 0 the Pallas kernel's causal mask, with
// q_off > 0 a rank's block of queries in a sequence split over ranks,
// against every key.
//
// q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hdv), contiguous, all
// f32 or all bf16; o (B, Sq, H, hdv) in q's dtype.  hd, hdv <= 256.  The kv
// head of q head h is h / (H / KV); K and V are never copied per head.
// lse, where not null, (B, H, Sq) f32: each row's log-sum-exp of its
// scaled scores in log2 units (m + log2(l) of the online softmax), as
// ``attention_prefill_tc.cu`` writes it -- what the f32 backward
// (attention_bwd.cu) takes from a training forward.
//
// Numerics follow the Pallas kernel: scores and the running max, sum and
// accumulator are f32; masked scores are -1e30 (not -inf), keys past the
// end of the sequence weigh exactly 0 and the final denominator is clamped
// at 1e-30.  bf16: p is rounded to bf16 before the PV product, as the
// reference casts p to v's dtype.  f32: both products in 3xTF32
// (tc_mma.cuh), in chains of at most 3 HD / 8 MMAs per accumulator (S's
// hi*hi products apart from its cross terms; each tile's P V apart from
// O, added to it on the CUDA cores), within ~1e-6 of an f32 product.
// A key tile that no
// unmasked (query, key) pair of a warp's rows reaches is skipped (without
// k_pos: decided from the rows' positions; with k_pos: per block, after
// the tile's positions arrive), which changes nothing for a row with one
// unmasked key.
//
// Bound on the card: prefill does 2 (hd + hdv) FLOPs per unmasked (query,
// key) pair and q head against a few bytes per element of q, k, v and o,
// far above the H100's ~295 FLOP/byte: operations bound it, at 989
// TFLOP/s in bf16 and 165 TFLOP/s for an f32-accurate product (three TF32
// products at 495 TFLOP/s).  The kernel it replaces ran f32 FMAs on the
// CUDA cores (67 TFLOP/s, ~5-15 TFLOP/s reached).
//
// Design (FlashAttention-2 on mma.sync): a block of 4 warps takes 128 rows
// of one (batch, kv head), or 64 where hdv > 128 or the grid would leave
// SMs with fewer than two blocks; a row is a (query, q head of the kv
// group) pair, so the G heads that share a kv head share every K/V tile.
// Each warp owns 32 or 16 rows (two m tiles or one: with two, every K/V
// fragment read from shared memory, and in f32 split, feeds two MMAs,
// which halves the instructions besides the MMAs that bound the one-tile
// version): S = Q K^T and O += P V are warp MMAs
// (bf16 m16n8k16, or m16n8k8 TF32 three times for f32) with the running
// max, sum and O in registers; P never leaves them (bf16: the S
// accumulators of two key tiles are an A fragment as they stand; f32: the
// PV product takes its keys in the order 0, 2, 4, 6, 1, 3, 5, 7 of each
// 8-key tile -- V's B fragment is loaded in that order -- so that the S
// accumulators are again an A fragment, with no shuffle).  Q stays in
// shared memory; K/V tiles of BK keys arrive by cp.async (16-byte pieces)
// into a ring of two stages, the next tile in flight while the current one
// is multiplied.  Head dims are template arguments: hd and hdv are padded
// to the next of 32, 48, 64, 80, 96, 128, 160, 192, 256 (192/128 for MLA's
// unequal dims), the padding zero-filled in shared memory once.  Rows are
// padded by 8 bf16 (16 bytes; ldmatrix reads 8 rows without a bank
// conflict) or 4 f32 (the TF32 fragments' scalar loads: row strides of 4
// mod 32 words, or 8 for V's permuted keys, hit 32 banks).  Head dims
// that are not a multiple of a 16-byte piece, or unaligned tensors, load
// element by element instead.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "tc_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 256;         // largest hd and hdv
constexpr float kMasked = -1e30f;    // the Pallas kernel's NEG_INF
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // (B, H, Sq) or null
  const int* q_pos;   // (B, Sq) or null: q_off + arange(Sq)
  const int* k_pos;   // (B, Sk) or null: arange(Sk)
  int B, Sq, Sk, H, KV, hd, hdv, causal, window, q_off;
  float scale;
};

__device__ __forceinline__ bool unmasked(int qp, int kp, const Args& a) {
  return kp >= 0 && (!a.causal || qp >= kp) &&
         (a.window <= 0 || qp - kp < a.window);
}

// an instantiation: padded head dims, BK keys per tile, MT 16-row m tiles
// per warp (rows per block kRows), and its shared-memory layout in
// elements of T
template <typename T, int HD_, int HDV_, int BK_, int MT_>
struct Cfg {
  static constexpr int HD = HD_, HDV = HDV_, BK = BK_, MT = MT_;
  static constexpr int kRows = 16 * MT * kWarps;
  static constexpr int SQK = HD + Elem<T>::kPad;    // Q and K row stride
  static constexpr int SV = HDV + Elem<T>::kPad;    // V row stride
  static constexpr int kQ = kRows * SQK;
  static constexpr int kK = BK * SQK;               // one stage
  static constexpr int kV = BK * SV;
  static constexpr size_t kBytes =
      sizeof(T) * (static_cast<size_t>(kQ) + 2 * kK + 2 * kV) +
      sizeof(int) * (2 * BK + kRows);
};

// N rows of ``dim`` (<= DP) elements into shared rows of ``stride``: row
// r from ``base + r * step`` where ``r < valid``, zeros past it.  Columns
// [dim, DP) are left alone (zeroed once).  With ``vec`` 16-byte pieces by
// cp.async (dim a multiple of a piece, 16-byte aligned rows), a fixed,
// unrolled count per thread; else element by element.
template <typename T, int N, int DP>
__device__ __forceinline__ void load_rows(T* dst, int stride, int dim,
                                          bool vec, const T* base,
                                          size_t step, int valid) {
  constexpr int L = Elem<T>::kPiece;
  constexpr int PP = DP / L;          // padded pieces per row
  if (vec) {
#pragma unroll
    for (int it = 0; it < (N * PP + kThreads - 1) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / PP, c = (i % PP) * L;
      if ((N * PP % kThreads && i >= N * PP) || c >= dim) continue;
      const bool ok = r < valid;
      tc::cp_async16(dst + r * stride + c, ok ? base + r * step + c : base,
                     ok);
    }
  } else {
    for (int i = threadIdx.x; i < N * dim; i += kThreads) {
      const int r = i / dim, c = i % dim;
      dst[r * stride + c] = r < valid ? base[r * step + c] : T(0.f);
    }
  }
}

// columns [dim, DP) of n rows: zeros
template <typename T, int DP>
__device__ __forceinline__ void zero_cols(T* dst, int stride, int n,
                                          int dim) {
  const int w = DP - dim;
  for (int i = threadIdx.x; i < n * w; i += kThreads)
    dst[(i / w) * stride + dim + i % w] = T(0.f);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T for the warp's rows and the tile's keys in 3xTF32.  The hi*hi
// products and the two cross terms go to separate accumulators, summed at
// the end: each chain of MMAs stays HD / 8 long (tc_mma.cuh)
template <typename C>
__device__ __forceinline__ void scores(float (&s)[C::MT][C::BK / 8][4],
                                       const float* Qw, const float* Kt,
                                       int g, int t) {
  constexpr int SQK = C::SQK;
  float sm[C::MT][C::BK / 8][4];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[mi][j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < C::HD; kk += 8) {
    uint32_t ah[C::MT][4], al[C::MT][4];
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi) {
      const float* qa = Qw + (mi * 16 + g) * SQK + kk + t;
      tc::split_tf32(qa[0], ah[mi][0], al[mi][0]);
      tc::split_tf32(qa[8 * SQK], ah[mi][1], al[mi][1]);
      tc::split_tf32(qa[4], ah[mi][2], al[mi][2]);
      tc::split_tf32(qa[8 * SQK + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      const float* kb = Kt + (j * 8 + g) * SQK + kk + t;
      uint32_t bh[2], bl[2];
      tc::split_tf32(kb[0], bh[0], bl[0]);
      tc::split_tf32(kb[4], bh[1], bl[1]);
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi) {
        tc::mma_tf32(sm[mi][j], al[mi], bh);
        tc::mma_tf32(sm[mi][j], ah[mi], bl);
        tc::mma_tf32(s[mi][j], ah[mi], bh);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mi][j][e] += sm[mi][j][e];
}

// S = Q K^T in bf16: A from Q by ldmatrix, B (two key tiles) from K, each
// B fragment used by the warp's MT m tiles
template <typename C>
__device__ __forceinline__ void scores(float (&s)[C::MT][C::BK / 8][4],
                                       const __nv_bfloat16* Qw,
                                       const __nv_bfloat16* Kt, int lane) {
  constexpr int SQK = C::SQK;
#pragma unroll
  for (int kk = 0; kk < C::HD; kk += 16) {
    uint32_t af[C::MT][4];
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi)
      tc::ldmatrix_x4(af[mi], Qw + (mi * 16 + lane % 16) * SQK + kk +
                                  (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < C::BK / 16; ++jp) {
      uint32_t bf[4];
      tc::ldmatrix_x4(bf, Kt + (jp * 16 + (lane / 16) * 8 + lane % 8) * SQK +
                              kk + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi) {
        tc::mma_bf16(s[mi][2 * jp], af[mi], bf);
        tc::mma_bf16(s[mi][2 * jp + 1], af[mi], bf + 2);
      }
    }
  }
}

// O = alpha O + P V in 3xTF32.  The PV product takes the keys of each
// 8-key tile in the order 0, 2, 4, 6, 1, 3, 5, 7 (V's B fragment is loaded
// in that order), so that P's accumulators are its A fragment as they
// stand.  Each 8-column slice of O gets the tile's P V in a fresh chain of
// 3 BK / 8 MMAs, then O = alpha O + that on the CUDA cores (tc_mma.cuh)
template <typename C>
__device__ __forceinline__ void accumulate(
    float (&o)[C::MT][C::HDV / 8][4], const float (&p)[C::MT][C::BK / 8][4],
    const float (&alpha)[C::MT][2], const float* Vt, int g, int t) {
  constexpr int SV = C::SV;
  uint32_t ph[C::MT][C::BK / 8][4], pl[C::MT][C::BK / 8][4];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      tc::split_tf32(p[mi][j][0], ph[mi][j][0], pl[mi][j][0]);  // (g, 2t)
      tc::split_tf32(p[mi][j][2], ph[mi][j][1], pl[mi][j][1]);  // (g+8, 2t)
      tc::split_tf32(p[mi][j][1], ph[mi][j][2], pl[mi][j][2]);  // (g, 2t+1)
      tc::split_tf32(p[mi][j][3], ph[mi][j][3], pl[mi][j][3]);
    }
#pragma unroll
  for (int n = 0; n < C::HDV / 8; ++n) {
    float pv[C::MT][4];
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[mi][e] = 0.f;
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      const float* vb = Vt + (j * 8 + 2 * t) * SV + n * 8 + g;
      uint32_t bh[2], bl[2];
      tc::split_tf32(vb[0], bh[0], bl[0]);
      tc::split_tf32(vb[SV], bh[1], bl[1]);
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi)
        tc::mma_3xtf32(pv[mi], ph[mi][j], pl[mi][j], bh, bl);
    }
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[mi][n][e] = fmaf(o[mi][n][e], alpha[mi][e / 2], pv[mi][e]);
  }
}

// O = alpha O + P V in bf16: P rounded to bf16 as an A fragment in
// registers (two key tiles' accumulators), V's B fragments by
// ldmatrix.trans, each used by the warp's MT m tiles
template <typename C>
__device__ __forceinline__ void accumulate(
    float (&o)[C::MT][C::HDV / 8][4], const float (&p)[C::MT][C::BK / 8][4],
    const float (&alpha)[C::MT][2], const __nv_bfloat16* Vt, int lane) {
  constexpr int SV = C::SV;
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int n = 0; n < C::HDV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][n][e] *= alpha[mi][e / 2];
#pragma unroll
  for (int c = 0; c < C::BK / 16; ++c) {
    uint32_t pa[C::MT][4];
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi) {
      pa[mi][0] = tc::pack_bf16(p[mi][2 * c][0], p[mi][2 * c][1]);
      pa[mi][1] = tc::pack_bf16(p[mi][2 * c][2], p[mi][2 * c][3]);
      pa[mi][2] = tc::pack_bf16(p[mi][2 * c + 1][0], p[mi][2 * c + 1][1]);
      pa[mi][3] = tc::pack_bf16(p[mi][2 * c + 1][2], p[mi][2 * c + 1][3]);
    }
#pragma unroll
    for (int np = 0; np < C::HDV / 16; ++np) {
      uint32_t vf[4];
      tc::ldmatrix_x4_trans(
          vf, Vt + (c * 16 + ((lane / 8) % 2) * 8 + lane % 8) * SV +
                  np * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi) {
        tc::mma_bf16(o[mi][2 * np], pa[mi], vf);
        tc::mma_bf16(o[mi][2 * np + 1], pa[mi], vf + 2);
      }
    }
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a, int vec) {
  constexpr int HD = C::HD, HDV = C::HDV, BK = C::BK, MT = C::MT;
  constexpr int SQK = C::SQK, SV = C::SV, BQ = C::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);                     // [BQ][SQK]
  T* Ks = Qs + C::kQ;                                     // [2][BK][SQK]
  T* Vs = Ks + 2 * C::kK;                                 // [2][BK][SV]
  int* kpos_s = reinterpret_cast<int*>(Vs + 2 * C::kV);   // [2][BK]
  int* qpos_s = kpos_s + 2 * BK;                          // [BQ]
  __shared__ int q_lo, q_hi;

  const int G = a.H / a.KV;
  const int rows = a.Sq * G;       // (query, head in group) rows of (b, kv)
  const int r0 = blockIdx.x * BQ;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hd = a.hd, hdv = a.hdv, Sk = a.Sk;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  // the padding columns: zeros, never written again
  zero_cols<T, HD>(Qs, SQK, BQ, hd);
  zero_cols<T, HD>(Ks, SQK, 2 * BK, hd);
  zero_cols<T, HDV>(Vs, SV, 2 * BK, hdv);
  if (threadIdx.x == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = r0 + r;
    int qp = 0;
    if (row < rows) {
      const int qi = row / G;
      qp = a.q_pos ? a.q_pos[static_cast<size_t>(b) * a.Sq + qi]
                   : qi + a.q_off;
      atomicMin(&q_lo, qp);
      atomicMax(&q_hi, qp);
    }
    qpos_s[r] = qp;
  }
  // Q: row r is (query (r0 + r) / G, q head kv * G + (r0 + r) % G), each
  // piece (or element, without vec) from its own row's address
  {
    constexpr int L = Elem<T>::kPiece, PP = HD / L;
    for (int i = threadIdx.x; i < BQ * (vec ? PP : hd); i += kThreads) {
      const int r = vec ? i / PP : i / hd;
      const int c = vec ? (i % PP) * L : i % hd;
      if (c >= hd) continue;
      const int row = r0 + r;
      const T* src = q;
      const bool ok = row < rows;
      if (ok) {
        const int qi = row / G, h = kv * G + row % G;
        src = q + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + h) * hd + c;
      }
      if (vec)
        tc::cp_async16(Qs + r * SQK + c, src, ok);
      else
        Qs[r * SQK + c] = ok ? *src : T(0.f);
    }
  }
  const size_t k_step = static_cast<size_t>(a.KV) * hd;
  const size_t v_step = static_cast<size_t>(a.KV) * hdv;
  const T* k_b = k + (static_cast<size_t>(b) * Sk * a.KV + kv) * hd;
  const T* v_b = v + (static_cast<size_t>(b) * Sk * a.KV + kv) * hdv;
  auto issue = [&](int tile, int st) {
    const int k0 = tile * BK;
    load_rows<T, BK, HD>(Ks + st * C::kK, SQK, hd, vec, k_b + k0 * k_step,
                         k_step, Sk - k0);
    load_rows<T, BK, HDV>(Vs + st * C::kV, SV, hdv, vec, v_b + k0 * v_step,
                          v_step, Sk - k0);
    if (a.k_pos && threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      tc::cp_async4(kpos_s + st * BK + threadIdx.x,
                    a.k_pos + static_cast<size_t>(b) * Sk + min(j, Sk - 1),
                    j < Sk);
    }
  };
  __syncthreads();                 // q_lo, q_hi and qpos_s

  // the key tiles any row of the block may reach; with k_pos every tile
  const int n_tiles = (Sk + BK - 1) / BK;
  int t_begin = 0, t_end = n_tiles;
  if (!a.k_pos) {
    if (a.causal) t_end = q_hi < 0 ? 0 : min(n_tiles, q_hi / BK + 1);
    if (a.window > 0) t_begin = max(0, q_lo - a.window + 1) / BK;
  }
  // this warp's rows (m tile mi: rows wr + 16 mi + g and + 8), their
  // positions and the least and largest of them
  const int wr = warp * 16 * MT;
  int qp[MT][2];
  int w_lo = INT_MAX, w_hi = INT_MIN;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + mi * 16 + g + 8 * h;
      qp[mi][h] = qpos_s[r];
      if (r0 + r < rows) {
        w_lo = min(w_lo, qp[mi][h]);
        w_hi = max(w_hi, qp[mi][h]);
      }
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, off));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, off));
  }
  const bool warp_rows = w_hi != INT_MIN;   // the warp has a row to write

  float acc[MT][HDV / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }
  const float sl2 = a.scale * kLog2e;   // scores in log2 units

  if (t_begin < t_end) issue(t_begin, 0);
  tc::cp_async_commit();                // Q (and the first tile)
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
    const int kend = min(k0 + BK, Sk);
    const int* kp_t = kpos_s + st * BK;
    bool live, masked = true;
    if (a.k_pos) {            // conservative: q_lo/q_hi bound the rows
      int lv = 0;
      if (threadIdx.x < BK) {
        const int kp = kp_t[threadIdx.x];
        lv = k0 + threadIdx.x < Sk && kp >= 0 && (!a.causal || q_hi >= kp) &&
             (a.window <= 0 || q_lo - kp < a.window);
      }
      live = __syncthreads_or(lv) && warp_rows;
    } else {
      live = warp_rows && (!a.causal || k0 <= w_hi) &&
             (a.window <= 0 || w_lo - (kend - 1) < a.window);
      masked = kend < k0 + BK || (a.causal && k0 + BK - 1 > w_lo) ||
               (a.window > 0 && w_hi - k0 >= a.window);
    }
    if (live) {
      const T* Kt = Ks + st * C::kK;
      const T* Vt = Vs + st * C::kV;
      const T* Qw = Qs + wr * SQK;
      float s[MT][BK / 8][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
      if constexpr (sizeof(T) == 4)
        scores<C>(s, Qw, Kt, g, t);
      else
        scores<C>(s, Qw, Kt, lane);

      // masked tiles: scores in log2 units with the masks applied
      // (``mul`` 1); else raw, the scale folded into the exponent's FMA
      float mul = sl2;
      if (masked) {
        mul = 1.f;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x0 = s[mi][j][e] * sl2, x1 = s[mi][j][2 + e] * sl2;
              const int c = j * 8 + 2 * t + e;
              if (k0 + c >= Sk) {
                x0 = x1 = -INFINITY;        // past the end: weight 0
              } else {
                const int kp = a.k_pos ? kp_t[c] : k0 + c;
                if (!unmasked(qp[mi][0], kp, a)) x0 = kMasked;
                if (!unmasked(qp[mi][1], kp, a)) x1 = kMasked;
              }
              s[mi][j][e] = x0;
              s[mi][j][2 + e] = x1;
            }
      }
      float alpha[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mx0 = fmaxf(mx0, s[mi][j][e]);
            mx1 = fmaxf(mx1, s[mi][j][2 + e]);
          }
        const float mn0 = fmaxf(m[mi][0], quad_max(mx0) * mul);
        const float mn1 = fmaxf(m[mi][1], quad_max(mx1) * mul);
        alpha[mi][0] = tc::ex2(m[mi][0] - mn0);
        alpha[mi][1] = tc::ex2(m[mi][1] - mn1);
        m[mi][0] = mn0;
        m[mi][1] = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[mi][j][e] = tc::ex2(fmaf(s[mi][j][e], mul, -mn0));
            s[mi][j][2 + e] = tc::ex2(fmaf(s[mi][j][2 + e], mul, -mn1));
            sum0 += s[mi][j][e];
            sum1 += s[mi][j][2 + e];
          }
        // this thread's share of the row sums; summed over the quad at
        // the end
        l[mi][0] = l[mi][0] * alpha[mi][0] + sum0;
        l[mi][1] = l[mi][1] * alpha[mi][1] + sum1;
      }
      if constexpr (sizeof(T) == 4)
        accumulate<C>(acc, s, alpha, Vt, g, t);
      else
        accumulate<C>(acc, s, alpha, Vt, lane);
    }
    __syncthreads();                // the stage is refilled next
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d = fmaxf(quad_sum(l[mi][h]), 1e-30f);
      const int row = r0 + wr + mi * 16 + g + 8 * h;
      if (row >= rows) continue;
      const int qi = row / G, hh = kv * G + row % G;
      if (a.lse && t == 0)
        a.lse[(static_cast<size_t>(b) * a.H + hh) * a.Sq + qi] =
            m[mi][h] + log2f(d);
      T* out = o + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + hh) * hdv;
#pragma unroll
      for (int n = 0; n < HDV / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < hdv) store(out + col, acc[mi][n][2 * h] / d);
        if (col + 1 < hdv) store(out + col + 1, acc[mi][n][2 * h + 1] / d);
      }
    }
}

template <typename T, typename C>
int launch_cfg(const Args& a, int vec, cudaStream_t stream) {
  // Raise the instantiation's shared-memory limit once, at its first
  // launch: not again inside a CUDA-graph capture.
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const int rows = a.Sq * (a.H / a.KV);
  const dim3 grid((rows + C::kRows - 1) / C::kRows, a.KV, a.B);
  flash_kernel<T, C><<<grid, kThreads, C::kBytes, stream>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

// the current device's SM count, read once per device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return counts[dev];
}

template <typename T, int HD, int HDV>
int launch(const Args& a, int vec, cudaStream_t stream) {
  // Two m tiles per warp (128-row blocks) where hdv <= 128 and the grid
  // still gives every SM two blocks: each K/V fragment read from shared
  // memory (and, in f32, split) then feeds two MMAs; else one.  Key tiles
  // as long as the registers and two stages of shared memory allow two or
  // more blocks per SM.
  constexpr bool kBf16 = sizeof(T) == 2;
  if constexpr (HDV <= 128) {
    constexpr int BK = kBf16 ? (HD <= 96 && HDV <= 96 ? 64 : 32)
                             : (HD <= 64 && HDV <= 64 ? 32 : 16);
    using C2 = Cfg<T, HD, HDV, BK, 2>;
    const long blocks = static_cast<long>(
        (a.Sq * (a.H / a.KV) + C2::kRows - 1) / C2::kRows) * a.KV * a.B;
    if (blocks >= 2L * sm_count()) return launch_cfg<T, C2>(a, vec, stream);
  }
  constexpr int BK1 =
      (kBf16 ? HD <= 128 && HDV <= 128 : HD <= 64 && HDV <= 64) ? 64 : 32;
  return launch_cfg<T, Cfg<T, HD, HDV, BK1, 1>>(a, vec, stream);
}

// the padded head dims of a call: 192/128 for MLA's shape, else both
// dims padded to the next instantiated width
template <typename T>
int dispatch(const Args& a, int vec, cudaStream_t s) {
  const int hd = a.hd, hdv = a.hdv, m = hd > hdv ? hd : hdv;
  if (hd > 128 && hd <= 192 && hdv <= 128)
    return launch<T, 192, 128>(a, vec, s);
  if (m <= 32) return launch<T, 32, 32>(a, vec, s);
  if (m <= 48) return launch<T, 48, 48>(a, vec, s);
  if (m <= 64) return launch<T, 64, 64>(a, vec, s);
  if (m <= 80) return launch<T, 80, 80>(a, vec, s);
  if (m <= 96) return launch<T, 96, 96>(a, vec, s);
  if (m <= 128) return launch<T, 128, 128>(a, vec, s);
  if (m <= 160) return launch<T, 160, 160>(a, vec, s);
  if (m <= 192) return launch<T, 192, 192>(a, vec, s);
  return launch<T, 256, 256>(a, vec, s);
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* q_pos, const void* k_pos,
                                     int B, int Sq, int Sk, int H, int KV,
                                     int hd, int hdv, int causal, int window,
                                     int q_off, float scale, int is_bf16,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxDim || hdv <= 0 ||
      hdv > kMaxDim || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse),
               static_cast<const int*>(q_pos),
               static_cast<const int*>(k_pos), B, Sq, Sk, H, KV, hd, hdv,
               causal, window, q_off, scale};
  // 16-byte pieces: whole pieces per row and 16-byte aligned tensors
  const int piece = is_bf16 ? 8 : 4;
  const int vec = hd % piece == 0 && hdv % piece == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, vec, s)
                 : dispatch<float>(a, vec, s);
}

// The layers' elementwise work, fused, for NVIDIA Hopper (sm_90a), loaded
// through ctypes: rmsnorm, rotary embedding, the Mamba mixer's causal
// depthwise conv with its bias and SiLU, and the SiLU gate, each a forward
// and a backward.
//
// What they replace: no TPU kernel.  The JAX package writes each op as jnp
// (src/repro/models/layers.py: rmsnorm, rope, mamba_mixer's conv, swiglu's
// and the mixer's gate; src/repro/models/moe.py's expert FFNs) that XLA
// fuses into a pass or two of the jitted step; the port ran each as a
// chain of eager aten ops on f32 copies (the chains stay, in
// kernels/ref.py, as these kernels' plain versions).  These are the passes.
//
// Numerics: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no contraction into FMAs), in the plain version's order, with
// the plain version's roundings to the working dtype.  rope (cosf/sinf of
// pos * freq, freqs handed in as the plain expression computes them), the
// conv (taps in order, rounded once, the bias added in the dtype, SiLU as
// x / (1 + expf(-x))) and the gate's forward (SiLU rounded, then the
// product) repeat the plain versions' operations; rmsnorm's row sums run
// in another order than torch's reduction.  The backwards compute in f32
// and round once at each output; the conv's recomputes v exactly as the
// forward rounds it, then, in bf16, takes SiLU's derivative with the fast
// exp and division and adds with FMAs (in f32 every operation rounded on
// its own).
//
// Bound on the card: bytes.  Each forward reads its inputs once and writes
// its output once (rmsnorm's second read of a row comes from L1/L2); each
// backward reads its inputs and the cotangent once and writes the input
// gradients, plus, where there is a weight, a reduction over rows.  None
// does more than a few FLOPs a byte (the conv's backward about ten a
// byte: its instructions come close to the bytes' time).
//
// Determinism: no atomics.  rmsnorm's dw and the conv's dw and db are sums
// over rows in two passes: per-part partial sums (a fixed set of rows per
// part, added in order), then a dwsum kernel adding the parts in order
// (``colsum``).  Warp sums are xor butterflies, whose every lane ends with
// the same bits.  Two runs repeat bit for bit.
//
// Design:
//  * rmsnorm: one warp a row, eight rows a 256-thread block, four elements
//    a lane an access where D and the row stride allow; the row's sum of
//    squares in f32, then the output pass.  Its backward reads x and dy
//    once: a block a band of rows, a row's elements held in registers by a
//    group of threads, dw's partials in shared memory (see the kernel).
//  * rope: one thread per (b, s, i < hd / 2), which computes cos and sin
//    of its angle once and rotates the pair (i, i + hd / 2) of every head.
//    x may be a strided view (MLA's rope part of a wider row).
//  * the conv: from zeros (a training step, prefill), u staged in shared
//    memory by 16-byte cp.async, a block a tile of eight chunks of 16
//    steps and 64 channels, a warp a chunk walked from shared memory
//    (``fused_conv_tile_kernel``); u may be a column slice of in_proj's
//    output (its row stride given).  From a state (decode) one thread per
//    (b, four adjacent channels -- one where they are not aligned) walks
//    the whole sequence with the last d_conv inputs in registers, so the
//    thread that reads a channel's state is the one that writes it, in
//    place (``fused_conv_kernel``).  Its backward stages u and dy the
//    same way, a block a tile of eight chunks, a warp a chunk; the
//    chunks' first dv shared so that only a tile's last chunk recomputes
//    past its end, and dw and db reduced in the block (see the kernel).
//  * the gate: four consecutive elements a thread (one 8- or 16-byte
//    access each where aligned), a 256-thread block a 1024-element chunk
//    of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "tc_mma.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the plain version's cast to the working dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// four consecutive elements by one 16-byte (f32) or 8-byte (bf16) access
__device__ __forceinline__ void ld4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float o[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void st4(float* p, const float o[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float o[4]) {
  uint2 v;
  *reinterpret_cast<__nv_bfloat162*>(&v.x) = __halves2bfloat162(
      __float2bfloat16_rn(o[0]), __float2bfloat16_rn(o[1]));
  *reinterpret_cast<__nv_bfloat162*>(&v.y) = __halves2bfloat162(
      __float2bfloat16_rn(o[2]), __float2bfloat16_rn(o[3]));
  *reinterpret_cast<uint2*>(p) = v;
}

// two consecutive elements by one 8-byte (f32) or 4-byte (bf16) access
__device__ __forceinline__ void ld2(const float* p, float o[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float o[2]) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  o[0] = __low2float(v); o[1] = __high2float(v);
}
__device__ __forceinline__ void st2(float* p, const float o[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, const float o[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(
      __float2bfloat16_rn(o[0]), __float2bfloat16_rn(o[1]));
}

// every lane ends with the same bits: lane i and lane i ^ o add the same
// two values at each level
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// SiLU as torch's kernel computes it: x / (1 + exp(-x)), in f32
__device__ __forceinline__ float silu_f(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

constexpr int NORM_WARPS = 8;   // rows of a 256-thread rmsnorm block

// ---------------------------------------------------------------- rmsnorm
// VEC: D, the row stride and every pointer aligned for four elements a
// lane an access (the sums then run in another order than without)
template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(256)
    fused_rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         T* __restrict__ y, int64_t R, int D, int64_t sx,
                         float inv_d, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * NORM_WARPS + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + row * sx;
  T* yr = y + row * (int64_t)D;
  float ss = 0.f;
  if (VEC) {
#pragma unroll 2
    for (int d = 4 * lane; d < D; d += 128) {
      float v[4];
      ld4(xr + d, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
    }
  } else {
#pragma unroll 4
    for (int d = lane; d < D; d += 32) {
      const float v = to_f(xr[d]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
  if (VEC) {
#pragma unroll 2
    for (int d = 4 * lane; d < D; d += 128) {
      float v[4], wv[4];
      ld4(xr + d, v);
      ld4(w + d, wv);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(__fmul_rn(v[k], r), wv[k]);
      st4(yr + d, v);
    }
  } else {
#pragma unroll 4
    for (int d = lane; d < D; d += 32)
      yr[d] = from_f<T>(__fmul_rn(__fmul_rn(to_f(xr[d]), r), to_f(w[d])));
  }
}

// ---------------------------------------------------- rmsnorm's backward
// dx = r (w dy) - x r^3 mean(x w dy), dw = the sum over rows of dy x r, in
// one pass over x and dy.  A block owns a band of consecutive rows (the
// wrapper's plan, ``fused.norm_bwd_plan``: it depends on (R, D) and the
// dtype alone, never on the card, so dw's summation order does too).
// Its threads form row groups of tx threads (tx / 32 warps), ty of them a
// block (the plan's too); group g takes the band's rows g, g + ty, ...  A
// thread holds NORM_H elements of a row -- units of four (one access each)
// where VEC, else single elements, unit k of thread t at t + tx k -- and
// w's at the same columns, bf16 still packed two to a register
// (``NormRow``), so that many rows are in flight on an SM.  A row's two
// sums reduce over the warp by butterfly and over the group's warps
// through shared memory in warp order; dx is written from the registers;
// dy x r is added into the group's own f32 row of dw partials in shared
// memory (a thread touches only its own columns).  At the end the groups'
// rows add in group order into the band's row of part (P, D);
// ``fused_rmsnorm_dwsum_kernel`` adds the bands in order.
constexpr int NORM_H = 16;         // elements of a row a thread holds
constexpr int NORM_MAX_TX = 512;   // threads of a block at most

// the row sums' exchange (two buffers of ty x warps float2) and the
// groups' dw partials (ty x D f32)
inline size_t norm_smem(int D, int tx, int ty) {
  return sizeof(float) * (4 * (size_t)ty * (tx / 32) + (size_t)ty * D);
}

template <int E, typename T>
__device__ __forceinline__ void lde(const T* p, float* o) {
  if constexpr (E == 4)
    ld4(p, o);
  else
    o[0] = to_f(p[0]);
}
template <int E, typename T>
__device__ __forceinline__ void ste(T* p, const float* o) {
  if constexpr (E == 4)
    st4(p, o);
  else
    p[0] = from_f<T>(o[0]);
}

// NORM_H elements of a row as a thread holds them: G units of E; bf16
// units of four packed two to a 32-bit word, the rest one f32 a word
template <typename T, int E>
struct NormRow {
  static constexpr bool PACK = sizeof(T) == 2 && E == 4;
  static constexpr int G = NORM_H / E, N = PACK ? NORM_H / 2 : NORM_H;
  static constexpr int WPU = N / G;   // words a unit
  uint32_t r[N];
  __device__ __forceinline__ void zero(int k) {
#pragma unroll
    for (int j = 0; j < WPU; ++j) r[k * WPU + j] = 0u;
  }
  __device__ __forceinline__ void load(const T* p, int k) {
    if constexpr (PACK) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r[2 * k] = v.x;
      r[2 * k + 1] = v.y;
    } else {
      float o[E];
      lde<E>(p, o);
#pragma unroll
      for (int e = 0; e < E; ++e) r[k * E + e] = __float_as_uint(o[e]);
    }
  }
  // element h = k E + e
  __device__ __forceinline__ float at(int h) const {
    if constexpr (PACK) {
      const uint32_t w = r[h >> 1];
      return __uint_as_float((h & 1) ? (w & 0xffff0000u) : (w << 16));
    } else {
      return __uint_as_float(r[h]);
    }
  }
};

template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(NORM_MAX_TX, sizeof(T) == 2 ? 2 : 1)
    fused_rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                             const T* __restrict__ dy, T* __restrict__ dx,
                             float* __restrict__ part, int64_t R, int D,
                             int64_t sx, int band, int TX, float inv_d,
                             float eps) {
  constexpr int E = VEC ? 4 : 1, G = NORM_H / E;
  extern __shared__ float smem[];
  const int TY = blockDim.x / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int wpr = TX / 32, wx = tx / 32, lane = threadIdx.x % 32;
  float* sums = smem + 4 * TY * wpr;   // [TY][D]
  float* mine = sums + ty * D;
  const int64_t r0 = (int64_t)blockIdx.x * band;
  const int64_t r1 = r0 + band < R ? r0 + band : R;
  NormRow<W, E> wr;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int d = (tx + TX * k) * E;
    if (d < D) {
      wr.load(w + d, k);
#pragma unroll
      for (int e = 0; e < E; ++e) mine[d + e] = 0.f;
    } else {
      wr.zero(k);
    }
  }
  const int iters = (band + TY - 1) / TY;
  for (int i = 0; i < iters; ++i) {
    const int64_t row = r0 + ty + (int64_t)i * TY;
    const bool live = row < r1;
    NormRow<T, E> xr, gr;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int d = (tx + TX * k) * E;
      if (live && d < D) {
        xr.load(x + row * sx + d, k);
        gr.load(dy + row * (int64_t)D + d, k);
      } else {
        xr.zero(k);
        gr.zero(k);
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int h = 0; h < NORM_H; ++h) {
      const float xv = xr.at(h);
      ss = __fadd_rn(ss, __fmul_rn(xv, xv));
      dot = __fadd_rn(dot, __fmul_rn(xv, __fmul_rn(wr.at(h), gr.at(h))));
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (wpr > 1) {   // the group's warps in order; two buffers, one barrier
      float* rb = smem + 2 * ((i & 1) * TY + ty) * wpr;
      if (lane == 0) {
        rb[2 * wx] = ss;
        rb[2 * wx + 1] = dot;
      }
      __syncthreads();
      ss = rb[0];
      dot = rb[1];
      for (int j = 1; j < wpr; ++j) {
        ss = __fadd_rn(ss, rb[2 * j]);
        dot = __fadd_rn(dot, rb[2 * j + 1]);
      }
    }
    if (!live) continue;
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r),
                              __fmul_rn(dot, inv_d));
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int d = (tx + TX * k) * E;
      if (d < D) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int h = k * E + e;
          const float xv = xr.at(h), gv = gr.at(h);
          o[e] = __fsub_rn(__fmul_rn(r, __fmul_rn(wr.at(h), gv)),
                           __fmul_rn(xv, c));
          mine[d + e] = __fadd_rn(mine[d + e],
                                  __fmul_rn(__fmul_rn(gv, xv), r));
        }
        ste<E>(dx + row * (int64_t)D + d, o);
      }
    }
  }
  __syncthreads();
  float* out = part + (int64_t)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = sums[d];
    for (int g = 1; g < TY; ++g) v = __fadd_rn(v, sums[g * D + d]);
    out[d] = v;
  }
}

// out = the sum of part (P, N) f32 over its P rows in a fixed order: a
// 256-thread block takes 32 columns, its warp j adds rows [P j / 8,
// P (j + 1) / 8) in order, then the eight warps' sums add in warp order.
// Columns below n0 go to out0, the rest to out1 (the conv's dw, then db).
template <typename O>
__device__ __forceinline__ void colsum(const float* __restrict__ part, int P,
                                       int64_t N, O* __restrict__ out0,
                                       int64_t n0, O* __restrict__ out1) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int64_t c = (int64_t)blockIdx.x * 32 + lane;
  const int p0 = (int)((int64_t)P * wp / 8);
  const int p1 = (int)((int64_t)P * (wp + 1) / 8);
  float acc = 0.f;
  if (c < N) {
#pragma unroll 8
    for (int p = p0; p < p1; ++p)
      acc = __fadd_rn(acc, part[(int64_t)p * N + c]);
  }
  red[wp][lane] = acc;
  __syncthreads();
  if (wp || c >= N) return;
  for (int j = 1; j < 8; ++j) acc = __fadd_rn(acc, red[j][lane]);
  if (c < n0)
    out0[c] = from_f<O>(acc);
  else
    out1[c - n0] = from_f<O>(acc);
}

// dw (D,): rmsnorm's bands added in order
template <typename W>
__global__ void __launch_bounds__(256)
    fused_rmsnorm_dwsum_kernel(const float* __restrict__ part, int P, int D,
                               W* __restrict__ dw) {
  colsum<W>(part, P, D, dw, D, nullptr);
}

// ------------------------------------------------------------------- rope
template <typename T>
__global__ void __launch_bounds__(256)
    fused_rope_kernel(const T* __restrict__ x, const int* __restrict__ pos,
                      const float* __restrict__ freqs, T* __restrict__ out,
                      int B, int S, int H, int half, int64_t sxb,
                      int64_t sxs, int64_t sxh, int64_t spb, int64_t sps,
                      int negate) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * S * half) return;
  const int i = (int)(t % half);
  const int64_t bs = t / half;
  const int b = (int)(bs / S), s = (int)(bs % S);
  const float ang = __fmul_rn((float)pos[b * spb + s * sps], freqs[i]);
  const float c = cosf(ang);
  float sn = sinf(ang);
  if (negate) sn = -sn;
  const T* xb = x + b * sxb + s * sxs;
  T* ob = out + bs * ((int64_t)H * 2 * half);
  for (int h = 0; h < H; ++h) {
    const float x1 = to_f(xb[h * sxh + i]);
    const float x2 = to_f(xb[h * sxh + i + half]);
    ob[(int64_t)h * 2 * half + i] =
        from_f<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    ob[(int64_t)h * 2 * half + i + half] =
        from_f<T>(__fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, c)));
  }
}

// ---------------------------------------------------------------- the conv
// u (B, S, di) at u[b * sub + s * sus + c]; w (K, di); b (di,); state
// (B, K - 1, di) contiguous; y (B, S, di) contiguous.  From a state
// (decode, launch-bound: a step or a few), a thread takes CV adjacent
// channels of a sequence: 4 (one access each) where di, u's strides and
// the pointers are aligned for it, else 1.
template <int CV, typename T>
__device__ __forceinline__ void ldv(const T* p, float o[CV]) {
  if constexpr (CV == 4)
    ld4(p, o);
  else if constexpr (CV == 2)
    ld2(p, o);
  else
    o[0] = to_f(p[0]);
}
template <int CV, typename T>
__device__ __forceinline__ void stv(T* p, const float o[CV]) {
  if constexpr (CV == 4)
    st4(p, o);
  else if constexpr (CV == 2)
    st2(p, o);
  else
    p[0] = from_f<T>(o[0]);
}

// the taps' products and sums in order, rounded once, the bias added in
// T, rounded: SiLU's input
template <typename T, int K>
__device__ __forceinline__ float conv_v(const float (&win)[K],
                                        const float (&wf)[K], float bf) {
  float acc = __fmul_rn(win[0], wf[0]);
#pragma unroll
  for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(win[j], wf[j]));
  return round_to<T>(__fadd_rn(round_to<T>(acc), bf));
}

// from a state: a thread CV channels of one sequence, every step, the
// state read before it is written (in place)
template <typename T, int K, int CV>
__global__ void __launch_bounds__(256)
    fused_conv_kernel(const T* __restrict__ u, const T* __restrict__ w,
                      const T* __restrict__ bias, const T* state_in,
                      T* __restrict__ y, T* state_out, int B, int S, int di,
                      int64_t sub, int64_t sus) {
  const int ncv = di / CV;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * ncv) return;
  const int c = (int)(t % ncv) * CV, bb = (int)(t / ncv);
  float wf[CV][K], win[CV][K], bf[CV], tmp[CV];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ldv<CV>(w + (int64_t)j * di + c, tmp);
#pragma unroll
    for (int q = 0; q < CV; ++q) wf[q][j] = tmp[q];
  }
  ldv<CV>(bias + c, bf);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {   // the inputs before u
    ldv<CV>(state_in + ((int64_t)bb * (K - 1) + j) * di + c, tmp);
#pragma unroll
    for (int q = 0; q < CV; ++q) win[q][j] = tmp[q];
  }
  for (int s = 0; s < S; ++s) {
    ldv<CV>(u + bb * sub + s * sus + c, tmp);
#pragma unroll
    for (int q = 0; q < CV; ++q) {
      win[q][K - 1] = tmp[q];
      tmp[q] = silu_f(conv_v<T, K>(win[q], wf[q], bf[q]));
#pragma unroll
      for (int j = 0; j < K - 1; ++j) win[q][j] = win[q][j + 1];
    }
    stv<CV>(y + ((int64_t)bb * S + s) * di + c, tmp);
  }
  // the last K - 1 inputs of the padded sequence: the new state
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
#pragma unroll
    for (int q = 0; q < CV; ++q) tmp[q] = win[q][j];
    stv<CV>(state_out + ((int64_t)bb * (K - 1) + j) * di + c, tmp);
  }
}

// SiLU's derivative s (1 + v (1 - s)), s = sigmoid(v).  FAST (bf16): the
// fast exponential and division, a gradient's factor with bf16's
// precision to spare; else every operation rounded on its own.
template <bool FAST>
__device__ __forceinline__ float dsilu(float v) {
  if constexpr (FAST) {
    const float s = __fdividef(1.f, 1.f + __expf(-v));
    return s * (1.f + v * (1.f - s));
  } else {
    const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
    return __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(v, __fsub_rn(1.f, s))));
  }
}
// acc + a b: one FMA (FAST), else the product and the sum rounded each
template <bool FAST>
__device__ __forceinline__ float mac(float a, float b, float acc) {
  if constexpr (FAST)
    return fmaf(a, b, acc);
  else
    return __fadd_rn(acc, __fmul_rn(a, b));
}

// The conv's backward in tiles staged in shared memory.  A 256-thread
// block takes CONV_CW channels of one sequence (a lane CONV_CV adjacent
// ones) and CONV_CY consecutive chunks of L steps, a warp a chunk.  A warp
// stages its chunk's u and dy rows (CONV_CW channels each) into a ring of
// CONV_NS slots of conv_sub<T>() rows, one slot ahead of its walk: by
// 16-byte cp.async where di, the strides and the pointers are aligned for
// it (VEC), else one element at a time; zeros outside the sequence and
// past di.  The K - 1 inputs before the chunk, and u and dy of the K - 1
// steps after it, are staged with the first slot.  A lane then walks its
// channels down the chunk from shared memory (``ConvWalk``): it keeps the
// last K inputs, recomputes v as the forward rounds it (``conv_v``), dv =
// dy silu'(v), adds dv and dv times each tap's input into its partials of
// db and dw, and writes du[t] once dv(t + K - 1) is in (du[t] = sum_j
// dv(t + K - 1 - j) w[j]).  The first K - 1 dv of each chunk go to shared
// memory (``xch``), where the chunk before takes them for its last K - 1
// du after one barrier; only the tile's last chunk, and the sequence's,
// walk on past their end (zeros past S).  The CONV_CY chunks' partials
// then add in shared memory in chunk order into the tile's row of part
// ((B * tiles), K + 1, di), which ``fused_conv_dwsum_kernel`` adds in
// tile order: no atomics.
constexpr int CONV_CY = 8;                  // chunks of a block: its warps
constexpr int CONV_CV = 2;                  // channels of a lane
constexpr int CONV_CW = 32 * CONV_CV;       // channels of a block
constexpr int CONV_NS = 2;                  // slots of a warp's ring
constexpr int CONV_HALO = 3;                // K - 1 rows, K up to 4
// rows of a slot: 2 KB of u and 2 KB of dy
template <typename T>
__host__ __device__ constexpr int conv_sub() {
  return 2048 / (CONV_CW * (int)sizeof(T));
}
// elements a warp stages: its ring (u and dy a slot), u before its chunk,
// u and dy after it
template <typename T>
__host__ __device__ constexpr int conv_warp_elems() {
  return (CONV_NS * 2 * conv_sub<T>() + 3 * CONV_HALO) * CONV_CW;
}
// a block's dynamic shared memory: the warps' stages, then ``xch``
// (CONV_CY, CONV_HALO, CONV_CW) f32; the partials' sum (CONV_CY, K + 1,
// CONV_CW) f32 reuses the stages after the walk
template <typename T>
constexpr size_t conv_smem() {
  return CONV_CY * (conv_warp_elems<T>() * sizeof(T) +
                    CONV_HALO * CONV_CW * sizeof(float));
}
static_assert(CONV_CY * 5 * CONV_CW * sizeof(float) <=
                  CONV_CY * conv_warp_elems<__nv_bfloat16>() * 2,
              "the partials' sum fits in the stages");

// rows t0 .. t0 + n - 1 of an operand whose row t starts at g + t * rs,
// channels c0 .. c0 + CONV_CW - 1, into n rows of CONV_CW at dst; zeros
// outside [0, S) x [0, di)
template <typename T, bool VEC>
__device__ __forceinline__ void conv_stage(T* dst, const T* g, int64_t rs,
                                           int t0, int n, int S, int c0,
                                           int di, int lane) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T), C = CONV_CW / E;
    for (int e = lane; e < n * C; e += 32) {
      const int r = e / C, k = (e % C) * E, t = t0 + r;
      const bool ok = t >= 0 && t < S && c0 + k < di;
      tc::cp_async16(dst + r * CONV_CW + k, ok ? g + t * rs + c0 + k : g,
                     ok);
    }
  } else {
    for (int e = lane; e < n * CONV_CW; e += 32) {
      const int r = e / CONV_CW, k = e % CONV_CW, t = t0 + r;
      dst[r * CONV_CW + k] = t >= 0 && t < S && c0 + k < di
                                 ? g[t * rs + c0 + k]
                                 : from_f<T>(0.f);
    }
  }
}

// du's row at a lane's channels c, c + 1 (those before di)
template <typename T, bool VEC>
__device__ __forceinline__ void conv_store(T* row, int c, int di,
                                           const float (&o)[CONV_CV]) {
  if constexpr (VEC) {
    if (c < di) st2(row + c, o);
  } else {
#pragma unroll
    for (int q = 0; q < CONV_CV; ++q)
      if (c + q < di) row[c + q] = from_f<T>(o[q]);
  }
}

// The conv's forward from zeros in tiles staged in shared memory, as the
// backward stages them.  A 256-thread block takes CONV_CW channels of one
// sequence (a lane CONV_CV adjacent ones) and CONV_CY consecutive chunks
// of L steps (``fused.conv_fwd_plan``: 16), a warp a chunk.  A warp stages its chunk's u rows into a
// ring of CONV_NS slots of conv_sub<T>() rows (2 KB), one slot ahead of
// its walk, the K - 1 rows before the chunk with the first slot; by
// 16-byte cp.async where di, the strides and the pointers are aligned for
// it (VEC), else one element at a time; zeros outside the sequence and
// past di.  A lane then walks its channels down the chunk from shared
// memory with the last K inputs in registers, as ``conv_v`` and
// ``silu_f`` round them, and stores y a row at a time (a warp's row one
// 128- or 256-byte store).  The warp that walks the sequence's last step
// writes the new state: the last K - 1 inputs (zeros before the
// sequence).  What it fixes: the one-thread-a-chunk walk issued one 8-byte
// load a step and a thread, about 6 KB in flight an SM against the ~20 KB
// that the memory's latency asks; here each warp's loads leave as 2 KB of
// 16-byte copies that hold no registers.  What is left is the walk's ~35
// instructions an element (SiLU's expf and IEEE division, two roundings
// to the dtype), about the bytes' time at full issue: five blocks an SM
// (48 registers, a few bytes spilled) and chunks of 16 steps hide more of
// its latency than four blocks and 32 steps did (probe_fused_bwd.py
// --fwd).
template <typename T>
__host__ __device__ constexpr int conv_fwd_warp_elems() {
  return (CONV_NS * conv_sub<T>() + CONV_HALO) * CONV_CW;
}
template <typename T>
constexpr size_t conv_fwd_smem() {
  return CONV_CY * conv_fwd_warp_elems<T>() * sizeof(T);
}

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(32 * CONV_CY, 5)
    fused_conv_tile_kernel(const T* __restrict__ u, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ y,
                           T* __restrict__ state_out, int S, int di,
                           int64_t sub, int64_t sus, int L) {
  constexpr int CV = CONV_CV, CW = CONV_CW, SUB = conv_sub<T>();
  constexpr int NS = CONV_NS;
  extern __shared__ __align__(16) unsigned char conv_raw[];
  const int lane = threadIdx.x % 32, wy = threadIdx.x / 32;
  T* ring = reinterpret_cast<T*>(conv_raw) + wy * conv_fwd_warp_elems<T>();
  T* pre = ring + NS * SUB * CW;       // (K - 1, CW): u before the chunk
  const int c0 = blockIdx.x * CW, cl = lane * CV, c = c0 + cl;
  const int bb = blockIdx.z, s0 = (blockIdx.y * CONV_CY + wy) * L;
  if (s0 >= S) return;
  const T* ub = u + bb * sub;
  T* yb = y + (int64_t)bb * S * di;
  float wf[CV][K], win[CV][K], bf[CV], uv[CV], o[CV];
#pragma unroll
  for (int q = 0; q < CV; ++q) {
    bf[q] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) wf[q][j] = win[q][j] = 0.f;
    if (c + q < di) {
#pragma unroll
      for (int j = 0; j < K; ++j) wf[q][j] = to_f(w[(int64_t)j * di + c + q]);
      bf[q] = to_f(bias[c + q]);
    }
  }
  // the slots that hold steps before S
  const int n = ((S - s0 < L ? S - s0 : L) + SUB - 1) / SUB;
  conv_stage<T, VEC>(pre, ub, sus, s0 - (K - 1), K - 1, S, c0, di, lane);
  auto stage = [&](int i) {
    conv_stage<T, VEC>(ring + (i % NS) * SUB * CW, ub, sus, s0 + i * SUB,
                       SUB, S, c0, di, lane);
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n) stage(i);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + NS - 1 < n) stage(i + NS - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<NS - 1>();
    __syncwarp();
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j)
#pragma unroll
        for (int q = 0; q < CV; ++q) win[q][j] = to_f(pre[j * CW + cl + q]);
    }
    const T* su = ring + (i % NS) * SUB * CW + cl;
    const int t0 = s0 + i * SUB;
    // row r: y at step t0 + r into o
    auto row = [&](int r) {
      ldv<CV>(su + r * CW, uv);
#pragma unroll
      for (int q = 0; q < CV; ++q) {
        win[q][K - 1] = uv[q];          // win[q][j] = u(t - K + 1 + j)
        o[q] = silu_f(conv_v<T, K>(win[q], wf[q], bf[q]));
#pragma unroll
        for (int j = 0; j < K - 1; ++j) win[q][j] = win[q][j + 1];
      }
    };
    if (t0 + SUB < S) {                // the slot ends before S - 1
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        row(r);
        conv_store<T, VEC>(yb + (int64_t)(t0 + r) * di, c, di, o);
      }
    } else {
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        const int t = t0 + r;
        row(r);
        if (t < S) conv_store<T, VEC>(yb + (int64_t)t * di, c, di, o);
        if (t == S - 1 && state_out) {   // the last K - 1 inputs
#pragma unroll
          for (int j = 0; j < K - 1; ++j) {
#pragma unroll
            for (int q = 0; q < CV; ++q) o[q] = win[q][j];
            conv_store<T, VEC>(state_out + ((int64_t)bb * (K - 1) + j) * di,
                               c, di, o);
          }
        }
      }
    }
    __syncwarp();
  }
}

// one lane's walk down its channels: the taps, the last K inputs and dv,
// the partials of dw and db
template <typename T, int K>
struct ConvWalk {
  static constexpr bool FAST = sizeof(T) == 2;
  float wf[CONV_CV][K], win[CONV_CV][K], dvw[CONV_CV][K], dwp[CONV_CV][K];
  float bf[CONV_CV], dbp[CONV_CV];

  // one step from u and dy at it (own: its dv goes into dw and db); o =
  // du at the step K - 1 back
  __device__ __forceinline__ void step(const float (&uv)[CONV_CV],
                                       const float (&gv)[CONV_CV], bool own,
                                       float (&o)[CONV_CV]) {
#pragma unroll
    for (int q = 0; q < CONV_CV; ++q) {
      win[q][K - 1] = uv[q];            // win[q][j] = u(s - K + 1 + j)
      const float d = dsilu<FAST>(conv_v<T, K>(win[q], wf[q], bf[q]));
      const float dv = FAST ? gv[q] * d : __fmul_rn(gv[q], d);
      if (own) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          dwp[q][j] = mac<FAST>(dv, win[q][j], dwp[q][j]);
        dbp[q] = FAST ? dbp[q] + dv : __fadd_rn(dbp[q], dv);
      }
#pragma unroll
      for (int j = 0; j < K - 1; ++j) win[q][j] = win[q][j + 1];
      push(q, dv, o);
    }
  }
  // dv(s) in: o[q] = du(s - K + 1)
  __device__ __forceinline__ void push(int q, float dv, float (&o)[CONV_CV]) {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) dvw[q][j] = dvw[q][j + 1];
    dvw[q][K - 1] = dv;                 // dvw[q][K - 1 - j] = dv(s - j)
    float a = FAST ? dvw[q][K - 1] * wf[q][0]
                   : __fmul_rn(dvw[q][K - 1], wf[q][0]);
#pragma unroll
    for (int j = 1; j < K; ++j) a = mac<FAST>(dvw[q][K - 1 - j], wf[q][j], a);
    o[q] = a;
  }
};

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(32 * CONV_CY, 2)
    fused_conv_bwd_kernel(const T* __restrict__ u, const T* __restrict__ w,
                          const T* __restrict__ bias,
                          const T* __restrict__ dy, T* __restrict__ du,
                          float* __restrict__ part, int S, int di,
                          int64_t sub, int64_t sus, int L) {
  constexpr int CV = CONV_CV, CW = CONV_CW, SUB = conv_sub<T>();
  constexpr int NS = CONV_NS, H = CONV_HALO;
  extern __shared__ __align__(16) unsigned char conv_raw[];
  const int lane = threadIdx.x % 32, y = threadIdx.x / 32;
  T* ring = reinterpret_cast<T*>(conv_raw) + y * conv_warp_elems<T>();
  T* pre = ring + NS * 2 * SUB * CW;   // (H, CW): u before the chunk
  T* post = pre + H * CW;              // (2, H, CW): u, dy after it
  float* xch = reinterpret_cast<float*>(
      conv_raw + CONV_CY * conv_warp_elems<T>() * sizeof(T));
  float* red = reinterpret_cast<float*>(conv_raw);
  const int c0 = blockIdx.x * CW, cl = lane * CV, c = c0 + cl;
  const int bb = blockIdx.z, s0 = (blockIdx.y * CONV_CY + y) * L;
  const bool run = s0 < S;
  // the tile's last chunk, and the sequence's, walk K - 1 steps on
  const bool tail = y == CONV_CY - 1 || s0 + L >= S;
  const bool guard = s0 + L > S;       // du's steps may pass S
  const T* ub = u + bb * sub;
  const T* gb = dy + (int64_t)bb * S * di;
  T* dub = du + (int64_t)bb * S * di;
  ConvWalk<T, K> wk;
  float uv[CV], gv[CV], o[CV];
#pragma unroll
  for (int q = 0; q < CV; ++q) {
    wk.dbp[q] = wk.bf[q] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      wk.wf[q][j] = wk.win[q][j] = wk.dvw[q][j] = wk.dwp[q][j] = 0.f;
    if (c + q < di) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        wk.wf[q][j] = to_f(w[(int64_t)j * di + c + q]);
      wk.bf[q] = to_f(bias[c + q]);
    }
  }
  if (run) {
    const int n = L / SUB;
    conv_stage<T, VEC>(pre, ub, sus, s0 - (K - 1), K - 1, S, c0, di, lane);
    if (tail) {
      conv_stage<T, VEC>(post, ub, sus, s0 + L, K - 1, S, c0, di, lane);
      conv_stage<T, VEC>(post + H * CW, gb, di, s0 + L, K - 1, S, c0, di,
                         lane);
    }
    // slot i % NS: rows s0 + i SUB .. of u, then of dy
    auto stage = [&](int i) {
      T* sl = ring + (i % NS) * 2 * SUB * CW;
      conv_stage<T, VEC>(sl, ub, sus, s0 + i * SUB, SUB, S, c0, di, lane);
      conv_stage<T, VEC>(sl + SUB * CW, gb, di, s0 + i * SUB, SUB, S, c0,
                         di, lane);
    };
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < n) stage(i);
      tc::cp_async_commit();
    }
    for (int i = 0; i < n; ++i) {
      if (i + NS - 1 < n) stage(i + NS - 1);
      tc::cp_async_commit();
      tc::cp_async_wait<NS - 1>();
      __syncwarp();
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < K - 1; ++j)
#pragma unroll
          for (int q = 0; q < CV; ++q)
            wk.win[q][j] = to_f(pre[j * CW + cl + q]);
      }
      const T* su = ring + (i % NS) * 2 * SUB * CW + cl;
      const int t0 = s0 + i * SUB - (K - 1);   // du's step at row 0
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        ldv<CV>(su + r * CW, uv);
        ldv<CV>(su + (SUB + r) * CW, gv);
        wk.step(uv, gv, true, o);
        if (i == 0 && r == K - 2) {   // dv(s0) .. dv(s0 + K - 2)
#pragma unroll
          for (int j = 0; j < K - 1; ++j)
#pragma unroll
            for (int q = 0; q < CV; ++q)
              xch[(y * H + j) * CW + cl + q] = wk.dvw[q][j + 1];
        }
        if ((i > 0 || r >= K - 1) && (!guard || t0 + r < S))
          conv_store<T, VEC>(dub + (int64_t)(t0 + r) * di, c, di, o);
      }
      __syncwarp();
    }
    if (tail) {   // dv on to s0 + L + K - 2: the chunk's last K - 1 du
#pragma unroll
      for (int r = 0; r < K - 1; ++r) {
        ldv<CV>(post + r * CW + cl, uv);
        ldv<CV>(post + (H + r) * CW + cl, gv);
        wk.step(uv, gv, false, o);
        const int t = s0 + L - (K - 1) + r;
        if (!guard || t < S)
          conv_store<T, VEC>(dub + (int64_t)t * di, c, di, o);
      }
    }
  }
  __syncthreads();
  if (run && !tail) {   // the last K - 1 du from the next chunk's first dv
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
#pragma unroll
      for (int q = 0; q < CV; ++q)
        wk.push(q, xch[((y + 1) * H + i) * CW + cl + q], o);
      conv_store<T, VEC>(dub + (int64_t)(s0 + L - (K - 1) + i) * di, c, di,
                         o);
    }
  }
#pragma unroll
  for (int q = 0; q < CV; ++q) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      red[(y * (K + 1) + j) * CW + cl + q] = wk.dwp[q][j];
    red[(y * (K + 1) + K) * CW + cl + q] = wk.dbp[q];
  }
  __syncthreads();
  const int64_t prow =
      ((int64_t)bb * gridDim.y + blockIdx.y) * (K + 1) * (int64_t)di;
  for (int e = threadIdx.x; e < (K + 1) * CW; e += blockDim.x) {
    const int j = e / CW, col = e % CW;
    if (c0 + col >= di) continue;
    float v = red[j * CW + col];
#pragma unroll
    for (int g = 1; g < CONV_CY; ++g)
      v = __fadd_rn(v, red[(g * (K + 1) + j) * CW + col]);
    part[prow + (int64_t)j * di + c0 + col] = v;
  }
}

// dw (K, di) and db (di,): the conv's tiles added in order
template <typename T>
__global__ void __launch_bounds__(256)
    fused_conv_dwsum_kernel(const float* __restrict__ part, int P, int K,
                            int di, T* __restrict__ dw, T* __restrict__ db) {
  colsum<T>(part, P, (int64_t)(K + 1) * di, dw, (int64_t)K * di, db);
}

// ---------------------------------------------------------------- the gate
// one thread four consecutive elements of a row (blockIdx.x the row,
// blockIdx.y its 1024-element chunk); VEC: one access each where D, the
// row strides and the pointers are aligned for it
constexpr int GATE_CHUNK = 4 * 256;

__device__ __forceinline__ float gate_f(float g, float u, bool bf16) {
  const float h = silu_f(g);
  return __fmul_rn(bf16 ? round_to<__nv_bfloat16>(h) : h, u);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
    fused_gate_kernel(const T* __restrict__ g, const T* __restrict__ u,
                      T* __restrict__ y, int D, int64_t sg, int64_t su) {
  const int64_t row = blockIdx.x;
  const int d0 = blockIdx.y * GATE_CHUNK + 4 * threadIdx.x;
  if (d0 >= D) return;
  const T* gr = g + row * sg;
  const T* ur = u + row * su;
  T* yr = y + row * (int64_t)D;
  constexpr bool BF = sizeof(T) == 2;
  if (VEC) {
    float gv[4], uv[4];
    ld4(gr + d0, gv);
    ld4(ur + d0, uv);
#pragma unroll
    for (int k = 0; k < 4; ++k) gv[k] = gate_f(gv[k], uv[k], BF);
    st4(yr + d0, gv);
  } else {
    for (int d = d0; d < d0 + 4 && d < D; ++d)
      yr[d] = from_f<T>(gate_f(to_f(gr[d]), to_f(ur[d]), BF));
  }
}

// (dg, du) of one element: du = dy silu(g), dg = dy u silu'(g)
__device__ __forceinline__ void gate_bwd_f(float gf, float uf, float dyf,
                                           float& dg, float& du) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gf)));
  du = __fmul_rn(dyf, __fmul_rn(gf, s));
  const float ds =
      __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(gf, __fsub_rn(1.f, s))));
  dg = __fmul_rn(__fmul_rn(dyf, uf), ds);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
    fused_gate_bwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                          const T* __restrict__ dy, T* __restrict__ dg,
                          T* __restrict__ du, int D, int64_t sg,
                          int64_t su) {
  const int64_t row = blockIdx.x;
  const int d0 = blockIdx.y * GATE_CHUNK + 4 * threadIdx.x;
  if (d0 >= D) return;
  const T* gr = g + row * sg;
  const T* ur = u + row * su;
  const int64_t o = row * (int64_t)D;
  if (VEC) {
    float gv[4], uv[4], dv[4], a[4], b[4];
    ld4(gr + d0, gv);
    ld4(ur + d0, uv);
    ld4(dy + o + d0, dv);
#pragma unroll
    for (int k = 0; k < 4; ++k) gate_bwd_f(gv[k], uv[k], dv[k], a[k], b[k]);
    st4(dg + o + d0, a);
    st4(du + o + d0, b);
  } else {
    for (int d = d0; d < d0 + 4 && d < D; ++d) {
      float a, b;
      gate_bwd_f(to_f(gr[d]), to_f(ur[d]), to_f(dy[o + d]), a, b);
      dg[o + d] = from_f<T>(a);
      du[o + d] = from_f<T>(b);
    }
  }
}

int blocks_for(int64_t n) { return (int)((n + 255) / 256); }

// p aligned for one access of four T
template <typename T>
bool al4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// ------------------------------------------------------------ launchers
template <typename T, typename W>
int rmsnorm_launch(const void* x, const void* w, void* y, int64_t R, int D,
                   int64_t sx, float eps, cudaStream_t s) {
  const int64_t blocks = (R + NORM_WARPS - 1) / NORM_WARPS;
  const bool vec = D % 4 == 0 && sx % 4 == 0 && al4<T>(x) && al4<W>(w) &&
                   al4<T>(y);
  if (vec)
    fused_rmsnorm_kernel<T, W, true><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), R, D, sx, 1.f / (float)D, eps);
  else
    fused_rmsnorm_kernel<T, W, false><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), R, D, sx, 1.f / (float)D, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy,
                       void* dx, void* dw, void* part, int64_t R, int D,
                       int64_t sx, int tx, int ty, int band, float eps,
                       cudaStream_t s) {
  // the plan's groups must hold a row (NORM_H elements a thread) and fit
  // a block
  if (tx < 32 || tx % 32 || ty < 1 || tx * ty > NORM_MAX_TX ||
      (int64_t)tx * NORM_H < D || band < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && sx % 4 == 0 && al4<T>(x) && al4<W>(w) &&
                   al4<T>(dy) && al4<T>(dx);
  const int64_t P = (R + band - 1) / band;
  const size_t smem = norm_smem(D, tx, ty);
  if (vec)
    fused_rmsnorm_bwd_kernel<T, W, true><<<(unsigned)P, tx * ty, smem, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(part), R, D, sx, band, tx, 1.f / (float)D, eps);
  else
    fused_rmsnorm_bwd_kernel<T, W, false><<<(unsigned)P, tx * ty, smem, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(part), R, D, sx, band, tx, 1.f / (float)D, eps);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  fused_rmsnorm_dwsum_kernel<W><<<(D + 31) / 32, 256, 0, s>>>(
      static_cast<const float*>(part), (int)P, D, static_cast<W*>(dw));
  return (int)cudaGetLastError();
}

// CV channels a thread where di, u's strides and every pointer allow
template <typename T, int CV = 4>
bool conv_vec(int di, int64_t sub, int64_t sus,
              std::initializer_list<const void*> ptrs) {
  if (di % CV || sub % CV || sus % CV) return false;
  for (const void* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % (CV * sizeof(T))) return false;
  return true;
}

// from zeros (state_in null): the staged tiles, ``chunk`` the plan's
// steps a warp (whole slots); from a state: a thread a channel group over
// the whole sequence (``chunk`` unused)
template <typename T, int K>
int conv_launch_k(const void* u, const void* w, const void* b,
                  const void* state_in, void* y, void* state_out, int B,
                  int S, int di, int64_t sub, int64_t sus, int chunk,
                  cudaStream_t s) {
  if (!state_in) {
    if (chunk < conv_sub<T>() || chunk % conv_sub<T>())
      return (int)cudaErrorInvalidValue;
    const int tiles = ((S + chunk - 1) / chunk + CONV_CY - 1) / CONV_CY;
    const dim3 grid((di + CONV_CW - 1) / CONV_CW, tiles, B);
#define REPRO_CONV_TILE(VEC)                                                 \
  fused_conv_tile_kernel<T, K, VEC>                                          \
      <<<grid, 32 * CONV_CY, conv_fwd_smem<T>(), s>>>(                       \
          static_cast<const T*>(u), static_cast<const T*>(w),                \
          static_cast<const T*>(b), static_cast<T*>(y),                      \
          static_cast<T*>(state_out), S, di, sub, sus, chunk)
    if (conv_vec<T, (int)(16 / sizeof(T))>(di, sub, sus, {u, y, state_out}))
      REPRO_CONV_TILE(true);
    else
      REPRO_CONV_TILE(false);
#undef REPRO_CONV_TILE
    return (int)cudaGetLastError();
  }
  if (!state_out) return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * di;
  if (conv_vec<T>(di, sub, sus, {u, w, b, state_in, y, state_out}))
    fused_conv_kernel<T, K, 4><<<blocks_for(lanes / 4), 256, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(state_in),
        static_cast<T*>(y), static_cast<T*>(state_out), B, S, di, sub, sus);
  else
    fused_conv_kernel<T, K, 1><<<blocks_for(lanes), 256, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(state_in),
        static_cast<T*>(y), static_cast<T*>(state_out), B, S, di, sub, sus);
  return (int)cudaGetLastError();
}

// the staged kernel of one alignment, its shared memory allowed at its
// first launch: not again inside a CUDA-graph capture
template <typename T, int K, bool VEC>
int conv_bwd_main(const void* u, const void* w, const void* b,
                  const void* dy, void* du, void* part, dim3 grid, int S,
                  int di, int64_t sub, int64_t sus, int L, cudaStream_t s) {
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_conv_bwd_kernel<T, K, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)conv_smem<T>());
    if (err != cudaSuccess) return (int)err;
    limit_set = true;
  }
  fused_conv_bwd_kernel<T, K, VEC><<<grid, 32 * CONV_CY, conv_smem<T>(), s>>>(
      static_cast<const T*>(u), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(dy),
      static_cast<T*>(du), static_cast<float*>(part), S, di, sub, sus, L);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int conv_bwd_launch_k(const void* u, const void* w, const void* b,
                      const void* dy, void* du, void* dw, void* db,
                      void* part, int B, int S, int di, int64_t sub,
                      int64_t sus, int L, int parts, cudaStream_t s) {
  // the plan's chunks: whole slots of the ring; its parts: one a tile
  if (L < conv_sub<T>() || L % conv_sub<T>()) return (int)cudaErrorInvalidValue;
  const int tiles = ((S + L - 1) / L + CONV_CY - 1) / CONV_CY;
  if (parts != B * tiles) return (int)cudaErrorInvalidValue;
  const dim3 grid((di + CONV_CW - 1) / CONV_CW, tiles, B);
  const int err =
      conv_vec<T, (int)(16 / sizeof(T))>(di, sub, sus, {u, dy, du})
          ? conv_bwd_main<T, K, true>(u, w, b, dy, du, part, grid, S, di,
                                      sub, sus, L, s)
          : conv_bwd_main<T, K, false>(u, w, b, dy, du, part, grid, S, di,
                                       sub, sus, L, s);
  if (err) return err;
  const int64_t N = (int64_t)(K + 1) * di;
  fused_conv_dwsum_kernel<T><<<(unsigned)((N + 31) / 32), 256, 0, s>>>(
      static_cast<const float*>(part), parts, K, di, static_cast<T*>(dw),
      static_cast<T*>(db));
  return (int)cudaGetLastError();
}

template <typename T>
int gate_launch(const void* g, const void* u, void* y, int64_t R, int D,
                int64_t sg, int64_t su, cudaStream_t s) {
  const dim3 grid((unsigned)R, (D + GATE_CHUNK - 1) / GATE_CHUNK);
  const bool vec = D % 4 == 0 && sg % 4 == 0 && su % 4 == 0 && al4<T>(g) &&
                   al4<T>(u) && al4<T>(y);
  if (vec)
    fused_gate_kernel<T, true><<<grid, 256, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<T*>(y), D, sg, su);
  else
    fused_gate_kernel<T, false><<<grid, 256, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<T*>(y), D, sg, su);
  return (int)cudaGetLastError();
}

template <typename T>
int gate_bwd_launch(const void* g, const void* u, const void* dy, void* dg,
                    void* du, int64_t R, int D, int64_t sg, int64_t su,
                    cudaStream_t s) {
  const dim3 grid((unsigned)R, (D + GATE_CHUNK - 1) / GATE_CHUNK);
  const bool vec = D % 4 == 0 && sg % 4 == 0 && su % 4 == 0 && al4<T>(g) &&
                   al4<T>(u) && al4<T>(dy) && al4<T>(dg) && al4<T>(du);
  if (vec)
    fused_gate_bwd_kernel<T, true><<<grid, 256, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<const T*>(dy), static_cast<T*>(dg), static_cast<T*>(du),
        D, sg, su);
  else
    fused_gate_bwd_kernel<T, false><<<grid, 256, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<const T*>(dy), static_cast<T*>(dg), static_cast<T*>(du),
        D, sg, su);
  return (int)cudaGetLastError();
}

}  // namespace

// (x, w, y, R, D, x row stride, eps, x_bf16, w_bf16, stream): y (R, D)
// contiguous
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y,
                             long long R, int D, long long sx, float eps,
                             int x_bf16, int w_bf16, void* stream) {
  if (R <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return w_bf16 ? rmsnorm_launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, R,
                                                                 D, sx, eps, s)
                  : rmsnorm_launch<__nv_bfloat16, float>(x, w, y, R, D, sx,
                                                         eps, s);
  return w_bf16 ? rmsnorm_launch<float, __nv_bfloat16>(x, w, y, R, D, sx,
                                                       eps, s)
                : rmsnorm_launch<float, float>(x, w, y, R, D, sx, eps, s);
}

// (x, w, dy, dx, dw, part, R, D, x row stride, tx, ty, band, eps, x_bf16,
//  w_bf16, stream); dy, dx (R, D) contiguous; the plan (``norm_bwd_plan``):
//  row groups of tx threads (a multiple of 32, NORM_H elements a thread: D
//  up to 8192), ty of them a block, bands of ``band`` rows; part
//  (ceil(R / band), D) f32 scratch
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, void* part, long long R,
                                 int D, long long sx, int tx, int ty,
                                 int band, float eps, int x_bf16, int w_bf16,
                                 void* stream) {
  if (R <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return w_bf16 ? rmsnorm_bwd_launch<__nv_bfloat16, __nv_bfloat16>(
                        x, w, dy, dx, dw, part, R, D, sx, tx, ty, band, eps,
                        s)
                  : rmsnorm_bwd_launch<__nv_bfloat16, float>(
                        x, w, dy, dx, dw, part, R, D, sx, tx, ty, band, eps,
                        s);
  return w_bf16 ? rmsnorm_bwd_launch<float, __nv_bfloat16>(
                      x, w, dy, dx, dw, part, R, D, sx, tx, ty, band, eps, s)
                : rmsnorm_bwd_launch<float, float>(x, w, dy, dx, dw, part, R,
                                                   D, sx, tx, ty, band, eps,
                                                   s);
}

// (x, pos, freqs, out, B, S, H, half, x strides b/s/h, pos strides b/s,
//  negate, is_bf16, stream); x's last dim contiguous, out (B, S, H, 2 half)
//  contiguous, pos int32, freqs (half,) f32
extern "C" int repro_rope(const void* x, const void* pos, const void* freqs,
                          void* out, int B, int S, int H, int half,
                          long long sxb, long long sxs, long long sxh,
                          long long spb, long long sps, int negate,
                          int is_bf16, void* stream) {
  const int64_t n = (int64_t)B * S * half;
  if (n <= 0 || H <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    fused_rope_kernel<__nv_bfloat16><<<blocks_for(n), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(pos),
        static_cast<const float*>(freqs), static_cast<__nv_bfloat16*>(out), B,
        S, H, half, sxb, sxs, sxh, spb, sps, negate);
  else
    fused_rope_kernel<float><<<blocks_for(n), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(pos),
        static_cast<const float*>(freqs), static_cast<float*>(out), B, S, H,
        half, sxb, sxs, sxh, spb, sps, negate);
  return (int)cudaGetLastError();
}

// (u, w, b, state_in, y, state_out, B, S, di, K, u strides b/s, chunk,
//  is_bf16, stream); state_in null: zeros before u, staged tiles whose
//  chunk is ``fused.conv_fwd_plan``'s steps, state_out null: no new
//  state; else the state before u, state_out (state_in itself: in place)
//  the new one
extern "C" int repro_causal_conv(const void* u, const void* w, const void* b,
                                 const void* state_in, void* y,
                                 void* state_out, int B, int S, int di, int K,
                                 long long sub, long long sus, int chunk,
                                 int is_bf16, void* stream) {
  if ((int64_t)B * S * di <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CONV(T, KK)                                                   \
  return conv_launch_k<T, KK>(u, w, b, state_in, y, state_out, B, S, di,   \
                              sub, sus, chunk, s)
  if (is_bf16) {
    switch (K) {
      case 2: REPRO_CONV(__nv_bfloat16, 2);
      case 3: REPRO_CONV(__nv_bfloat16, 3);
      case 4: REPRO_CONV(__nv_bfloat16, 4);
    }
  } else {
    switch (K) {
      case 2: REPRO_CONV(float, 2);
      case 3: REPRO_CONV(float, 3);
      case 4: REPRO_CONV(float, 4);
    }
  }
#undef REPRO_CONV
  return (int)cudaErrorInvalidValue;
}

// (u, w, b, dy, du, dw, db, part, B, S, di, K, u strides b/s, steps,
//  parts, is_bf16, stream); dy, du (B, S, di) contiguous; the plan
//  (``conv_bwd_plan``): chunks of ``steps`` steps (a multiple of
//  conv_sub<T>()), ``parts`` = B ceil(ceil(S / steps) / CONV_CY) tiles;
//  part (parts, K + 1, di) f32 scratch
extern "C" int repro_causal_conv_bwd(const void* u, const void* w,
                                     const void* b, const void* dy, void* du,
                                     void* dw, void* db, void* part, int B,
                                     int S, int di, int K, long long sub,
                                     long long sus, int steps, int parts,
                                     int is_bf16, void* stream) {
  if ((int64_t)B * S * di <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CONV_BWD(T, KK)                                                \
  return conv_bwd_launch_k<T, KK>(u, w, b, dy, du, dw, db, part, B, S, di,  \
                                  sub, sus, steps, parts, s)
  if (is_bf16) {
    switch (K) {
      case 2: REPRO_CONV_BWD(__nv_bfloat16, 2);
      case 3: REPRO_CONV_BWD(__nv_bfloat16, 3);
      case 4: REPRO_CONV_BWD(__nv_bfloat16, 4);
    }
  } else {
    switch (K) {
      case 2: REPRO_CONV_BWD(float, 2);
      case 3: REPRO_CONV_BWD(float, 3);
      case 4: REPRO_CONV_BWD(float, 4);
    }
  }
#undef REPRO_CONV_BWD
  return (int)cudaErrorInvalidValue;
}

// (g, u, y, R, D, g row stride, u row stride, is_bf16, stream); y (R, D)
// contiguous
extern "C" int repro_silu_gate(const void* g, const void* u, void* y,
                               long long R, int D, long long sg, long long su,
                               int is_bf16, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? gate_launch<__nv_bfloat16>(g, u, y, R, D, sg, su, s)
                 : gate_launch<float>(g, u, y, R, D, sg, su, s);
}

// (g, u, dy, dg, du, R, D, g row stride, u row stride, is_bf16, stream);
// dy, dg, du (R, D) contiguous
extern "C" int repro_silu_gate_bwd(const void* g, const void* u,
                                   const void* dy, void* dg, void* du,
                                   long long R, int D, long long sg,
                                   long long su, int is_bf16, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? gate_bwd_launch<__nv_bfloat16>(g, u, dy, dg, du, R, D, sg,
                                                  su, s)
                 : gate_bwd_launch<float>(g, u, dy, dg, du, R, D, sg, su, s);
}

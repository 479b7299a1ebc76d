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
// and round once at each output.
//
// Bound on the card: bytes.  Each forward reads its inputs once and writes
// its output once (rmsnorm's second read of a row comes from L1/L2); each
// backward reads its inputs and the cotangent once and writes the input
// gradients, plus, where there is a weight, a reduction over rows.  None
// does more than a few FLOPs a byte.
//
// Determinism: no atomics.  rmsnorm's dw and the conv's dw and db are sums
// over rows in two passes: per-part partial sums (a fixed set of rows per
// part, added in order), then one thread per column adding the parts in
// order.  Warp sums are xor butterflies, whose every lane ends with the
// same bits.  Two runs repeat bit for bit.
//
// Design, simple first:
//  * rmsnorm: one warp a row, eight rows a 256-thread block, four elements
//    a lane an access where D and the row stride allow; the row's sum of
//    squares in f32, then the output pass.  The backward's row pass
//    recomputes r and writes it (R,) f32 for the dw pass.
//  * rope: one thread per (b, s, i < hd / 2), which computes cos and sin
//    of its angle once and rotates the pair (i, i + hd / 2) of every head.
//    x may be a strided view (MLA's rope part of a wider row).
//  * the conv: one thread per (b, chunk of CHUNK steps, four adjacent
//    channels -- one where they are not aligned), which keeps the last
//    d_conv inputs in registers and walks its chunk; u may
//    be a column slice of in_proj's output (its row stride given).  From a
//    state (decode) one chunk covers the sequence, so the thread that reads
//    a channel's state is the one that writes it, in place.
//  * the gate: four consecutive elements a thread (one 8- or 16-byte
//    access each where aligned), a 256-thread block a 1024-element chunk
//    of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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
// SiLU's derivative s (1 + v (1 - s)), s = sigmoid(v)
__device__ __forceinline__ float dsilu_f(float v) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
  return __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(v, __fsub_rn(1.f, s))));
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

// dx = r (w dy) - x r^3 mean(x w dy); r per row into rstd
template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(256)
    fused_rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                             const T* __restrict__ dy, T* __restrict__ dx,
                             float* __restrict__ rstd, int64_t R, int D,
                             int64_t sx, float inv_d, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * NORM_WARPS + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + row * sx;
  const T* gr = dy + row * (int64_t)D;
  T* out = dx + row * (int64_t)D;
  float ss = 0.f, dot = 0.f;
  if (VEC) {
#pragma unroll 2
    for (int d = 4 * lane; d < D; d += 128) {
      float v[4], wv[4], g[4];
      ld4(xr + d, v);
      ld4(w + d, wv);
      ld4(gr + d, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
        dot = __fadd_rn(dot, __fmul_rn(v[k], __fmul_rn(wv[k], g[k])));
      }
    }
  } else {
#pragma unroll 4
    for (int d = lane; d < D; d += 32) {
      const float v = to_f(xr[d]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
      dot = __fadd_rn(dot, __fmul_rn(v, __fmul_rn(to_f(w[d]),
                                                  to_f(gr[d]))));
    }
  }
  ss = warp_sum(ss);
  dot = warp_sum(dot);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
  const float c = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r),
                            __fmul_rn(dot, inv_d));
  if (lane == 0) rstd[row] = r;
  if (VEC) {
#pragma unroll 2
    for (int d = 4 * lane; d < D; d += 128) {
      float v[4], wv[4], g[4];
      ld4(xr + d, v);
      ld4(w + d, wv);
      ld4(gr + d, g);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = __fsub_rn(__fmul_rn(r, __fmul_rn(wv[k], g[k])),
                         __fmul_rn(v[k], c));
      st4(out + d, v);
    }
  } else {
#pragma unroll 4
    for (int d = lane; d < D; d += 32) {
      const float wdy = __fmul_rn(to_f(w[d]), to_f(gr[d]));
      out[d] = from_f<T>(__fsub_rn(__fmul_rn(r, wdy),
                                   __fmul_rn(to_f(xr[d]), c)));
    }
  }
}

// part[p, d] = sum over rows p * rows_per .. of dy x r, in row order
template <typename T>
__global__ void __launch_bounds__(256)
    fused_rmsnorm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ rstd,
                            float* __restrict__ part, int64_t R, int D,
                            int64_t sx, int rows_per) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per;
  const int64_t r1 = r0 + rows_per < R ? r0 + rows_per : R;
  float acc = 0.f;
#pragma unroll 4
  for (int64_t row = r0; row < r1; ++row)
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(to_f(dy[row * D + d]),
                                             to_f(x[row * sx + d])),
                                   rstd[row]));
  part[(int64_t)blockIdx.y * D + d] = acc;
}

template <typename W>
__global__ void __launch_bounds__(256)
    fused_rmsnorm_dwsum_kernel(const float* __restrict__ part,
                               W* __restrict__ dw, int P, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc = __fadd_rn(acc, part[(int64_t)p * D + d]);
  dw[d] = from_f<W>(acc);
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
// (B, K - 1, di) contiguous; y (B, S, di) contiguous.  A thread takes CV
// adjacent channels: 4 (one access each) where di, u's strides and the
// pointers are aligned for it, else 1.
template <int CV, typename T>
__device__ __forceinline__ void ldv(const T* p, float o[CV]) {
  if constexpr (CV == 4)
    ld4(p, o);
  else
    o[0] = to_f(p[0]);
}
template <int CV, typename T>
__device__ __forceinline__ void stv(T* p, const float o[CV]) {
  if constexpr (CV == 4)
    st4(p, o);
  else
    p[0] = from_f<T>(o[0]);
}

// the input at step t (< 0: the state's row, or zeros)
template <typename T, int K, int CV>
__device__ __forceinline__ void conv_in(const T* __restrict__ u,
                                        const T* state, int bb, int t, int c,
                                        int di, int64_t sub, int64_t sus,
                                        float o[CV]) {
  if (t >= 0) {
    ldv<CV>(u + bb * sub + t * sus + c, o);
  } else if (state) {
    ldv<CV>(state + ((int64_t)bb * (K - 1) + (K - 1 + t)) * di + c, o);
  } else {
#pragma unroll
    for (int q = 0; q < CV; ++q) o[q] = 0.f;
  }
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

template <typename T, int K, int CV>
__global__ void __launch_bounds__(256)
    fused_conv_kernel(const T* __restrict__ u, const T* __restrict__ w,
                      const T* __restrict__ bias, const T* state_in,
                      T* __restrict__ y, T* state_out, int B, int S, int di,
                      int64_t sub, int64_t sus, int chunk, int nchunk) {
  const int ncv = di / CV;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * nchunk * ncv) return;
  const int c = (int)(t % ncv) * CV;
  const int64_t bc = t / ncv;
  const int ch = (int)(bc % nchunk), bb = (int)(bc / nchunk);
  const int s0 = ch * chunk, s1 = s0 + chunk < S ? s0 + chunk : S;
  float wf[CV][K], win[CV][K], bf[CV], tmp[CV];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ldv<CV>(w + (int64_t)j * di + c, tmp);
#pragma unroll
    for (int q = 0; q < CV; ++q) wf[q][j] = tmp[q];
  }
  ldv<CV>(bias + c, bf);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    conv_in<T, K, CV>(u, state_in, bb, s0 - (K - 1) + j, c, di, sub, sus,
                      tmp);
#pragma unroll
    for (int q = 0; q < CV; ++q) win[q][j] = tmp[q];
  }
  for (int s = s0; s < s1; ++s) {
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
  if (state_out && ch == nchunk - 1) {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
#pragma unroll
      for (int q = 0; q < CV; ++q) tmp[q] = win[q][j];
      stv<CV>(state_out + ((int64_t)bb * (K - 1) + j) * di + c, tmp);
    }
  }
}

// du (B, S, di) contiguous; part ((B * nchunk), K + 1, di): each chunk's
// sums of dv * tap j's input (j < K) and of dv (j = K) over its steps
template <typename T, int K, int CV>
__global__ void __launch_bounds__(256)
    fused_conv_bwd_kernel(const T* __restrict__ u, const T* __restrict__ w,
                          const T* __restrict__ bias,
                          const T* __restrict__ dy, T* __restrict__ du,
                          float* __restrict__ part, int B, int S, int di,
                          int64_t sub, int64_t sus, int chunk, int nchunk) {
  const int ncv = di / CV;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * nchunk * ncv) return;
  const int c = (int)(t % ncv) * CV;
  const int64_t bc = t / ncv;
  const int ch = (int)(bc % nchunk), bb = (int)(bc / nchunk);
  const int s0 = ch * chunk, s1 = s0 + chunk < S ? s0 + chunk : S;
  float wf[CV][K], win[CV][K], dvw[CV][K], dwp[CV][K], bf[CV], dbp[CV];
  float tmp[CV], g[CV];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ldv<CV>(w + (int64_t)j * di + c, tmp);
#pragma unroll
    for (int q = 0; q < CV; ++q) {
      wf[q][j] = tmp[q];
      dvw[q][j] = 0.f;
      dwp[q][j] = 0.f;
    }
  }
  ldv<CV>(bias + c, bf);
#pragma unroll
  for (int q = 0; q < CV; ++q) dbp[q] = 0.f;
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    conv_in<T, K, CV>(u, nullptr, bb, s0 - (K - 1) + j, c, di, sub, sus,
                      tmp);
#pragma unroll
    for (int q = 0; q < CV; ++q) win[q][j] = tmp[q];
  }
  // dv at steps s0 .. s1 + K - 2 (0 past S); du[s] once dv(s + K - 1) is in
  for (int s = s0; s < s1 + K - 1; ++s) {
    const bool live = s < S;
    if (live) {
      ldv<CV>(u + bb * sub + s * sus + c, tmp);
      ldv<CV>(dy + ((int64_t)bb * S + s) * di + c, g);
    }
#pragma unroll
    for (int q = 0; q < CV; ++q) {
      float dv = 0.f;
      if (live) {
        win[q][K - 1] = tmp[q];
        dv = __fmul_rn(g[q], dsilu_f(conv_v<T, K>(win[q], wf[q], bf[q])));
        if (s < s1) {
#pragma unroll
          for (int j = 0; j < K; ++j)
            dwp[q][j] = __fadd_rn(dwp[q][j], __fmul_rn(dv, win[q][j]));
          dbp[q] = __fadd_rn(dbp[q], dv);
        }
#pragma unroll
        for (int j = 0; j < K - 1; ++j) win[q][j] = win[q][j + 1];
      }
#pragma unroll
      for (int j = 0; j < K - 1; ++j) dvw[q][j] = dvw[q][j + 1];
      dvw[q][K - 1] = dv;               // dvw[q][K - 1 - j] = dv(s - j)
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j)
        acc = __fadd_rn(acc, __fmul_rn(dvw[q][K - 1 - j], wf[q][j]));
      g[q] = acc;
    }
    const int so = s - (K - 1);
    if (so >= s0 && so < S) stv<CV>(du + ((int64_t)bb * S + so) * di + c, g);
  }
  float* pp = part + (bc * (K + 1)) * di + c;
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int q = 0; q < CV; ++q) tmp[q] = dwp[q][j];
    stv<CV>(pp + (int64_t)j * di, tmp);
  }
  stv<CV>(pp + (int64_t)K * di, dbp);
}

// dw (K, di) and db (di,): the parts added in order, one thread a column
template <typename T>
__global__ void __launch_bounds__(256)
    fused_conv_dwsum_kernel(const float* __restrict__ part,
                            T* __restrict__ dw, T* __restrict__ db, int P,
                            int K, int di) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)(K + 1) * di) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p)
    acc = __fadd_rn(acc, part[(int64_t)p * (K + 1) * di + t]);
  if (t < (int64_t)K * di)
    dw[t] = from_f<T>(acc);
  else
    db[t - (int64_t)K * di] = from_f<T>(acc);
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
                       void* dx, void* dw, void* rstd, void* part, int64_t R,
                       int D, int64_t sx, int rows_per, float eps,
                       cudaStream_t s) {
  const int64_t blocks = (R + NORM_WARPS - 1) / NORM_WARPS;
  const bool vec = D % 4 == 0 && sx % 4 == 0 && al4<T>(x) && al4<W>(w) &&
                   al4<T>(dy) && al4<T>(dx);
  if (vec)
    fused_rmsnorm_bwd_kernel<T, W, true><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(rstd), R, D, sx, 1.f / (float)D, eps);
  else
    fused_rmsnorm_bwd_kernel<T, W, false><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(rstd), R, D, sx, 1.f / (float)D, eps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int P = (int)((R + rows_per - 1) / rows_per);
  fused_rmsnorm_dw_kernel<T><<<dim3(blocks_for(D), P), 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(rstd), static_cast<float*>(part), R, D, sx,
      rows_per);
  err = (int)cudaGetLastError();
  if (err) return err;
  fused_rmsnorm_dwsum_kernel<W><<<blocks_for(D), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<W*>(dw), P, D);
  return (int)cudaGetLastError();
}

// four channels a thread where di, u's strides and every pointer allow
template <typename T>
bool conv_vec(int di, int64_t sub, int64_t sus,
              std::initializer_list<const void*> ptrs) {
  if (di % 4 || sub % 4 || sus % 4) return false;
  for (const void* p : ptrs)
    if (p && !al4<T>(p)) return false;
  return true;
}

template <typename T, int K>
int conv_launch_k(const void* u, const void* w, const void* b,
                  const void* state_in, void* y, void* state_out, int B,
                  int S, int di, int64_t sub, int64_t sus, int chunk,
                  cudaStream_t s) {
  const int nchunk = (S + chunk - 1) / chunk;
  const int64_t lanes = (int64_t)B * nchunk * di;
  if (conv_vec<T>(di, sub, sus, {u, w, b, state_in, y, state_out}))
    fused_conv_kernel<T, K, 4><<<blocks_for(lanes / 4), 256, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(state_in),
        static_cast<T*>(y), static_cast<T*>(state_out), B, S, di, sub, sus,
        chunk, nchunk);
  else
    fused_conv_kernel<T, K, 1><<<blocks_for(lanes), 256, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(state_in),
        static_cast<T*>(y), static_cast<T*>(state_out), B, S, di, sub, sus,
        chunk, nchunk);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int conv_bwd_launch_k(const void* u, const void* w, const void* b,
                      const void* dy, void* du, void* dw, void* db,
                      void* part, int B, int S, int di, int64_t sub,
                      int64_t sus, int chunk, cudaStream_t s) {
  const int nchunk = (S + chunk - 1) / chunk;
  const int64_t lanes = (int64_t)B * nchunk * di;
  if (conv_vec<T>(di, sub, sus, {u, w, b, dy, du}) && al4<float>(part))
    fused_conv_bwd_kernel<T, K, 4><<<blocks_for(lanes / 4), 256, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(dy),
        static_cast<T*>(du), static_cast<float*>(part), B, S, di, sub, sus,
        chunk, nchunk);
  else
    fused_conv_bwd_kernel<T, K, 1><<<blocks_for(lanes), 256, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(dy),
        static_cast<T*>(du), static_cast<float*>(part), B, S, di, sub, sus,
        chunk, nchunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  fused_conv_dwsum_kernel<T><<<blocks_for((int64_t)(K + 1) * di), 256, 0,
                               s>>>(
      static_cast<const float*>(part), static_cast<T*>(dw),
      static_cast<T*>(db), B * nchunk, K, di);
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

// (x, w, dy, dx, dw, rstd, part, R, D, x row stride, rows_per, eps, x_bf16,
//  w_bf16, stream); dy, dx (R, D) contiguous, rstd (R,) and part
//  (ceil(R / rows_per), D) f32 scratch
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, void* rstd, void* part,
                                 long long R, int D, long long sx,
                                 int rows_per, float eps, int x_bf16,
                                 int w_bf16, void* stream) {
  if (R <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return w_bf16
               ? rmsnorm_bwd_launch<__nv_bfloat16, __nv_bfloat16>(
                     x, w, dy, dx, dw, rstd, part, R, D, sx, rows_per, eps, s)
               : rmsnorm_bwd_launch<__nv_bfloat16, float>(
                     x, w, dy, dx, dw, rstd, part, R, D, sx, rows_per, eps, s);
  return w_bf16 ? rmsnorm_bwd_launch<float, __nv_bfloat16>(
                      x, w, dy, dx, dw, rstd, part, R, D, sx, rows_per, eps, s)
                : rmsnorm_bwd_launch<float, float>(x, w, dy, dx, dw, rstd,
                                                   part, R, D, sx, rows_per,
                                                   eps, s);
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
//  is_bf16, stream); state_in null: zeros before u; state_out null: no new
//  state; state_in == state_out (in place) needs chunk >= S
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

// (u, w, b, dy, du, dw, db, part, B, S, di, K, u strides b/s, chunk,
//  is_bf16, stream); dy, du (B, S, di) contiguous; part (B * ceil(S /
//  chunk), K + 1, di) f32 scratch
extern "C" int repro_causal_conv_bwd(const void* u, const void* w,
                                     const void* b, const void* dy, void* du,
                                     void* dw, void* db, void* part, int B,
                                     int S, int di, int K, long long sub,
                                     long long sus, int chunk, int is_bf16,
                                     void* stream) {
  if ((int64_t)B * S * di <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CONV_BWD(T, KK)                                                \
  return conv_bwd_launch_k<T, KK>(u, w, b, dy, du, dw, db, part, B, S, di,  \
                                  sub, sus, chunk, s)
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

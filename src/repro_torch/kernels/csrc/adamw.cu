// AdamW's update of one parameter leaf for NVIDIA Hopper (sm_90a), loaded
// through ctypes.
//
// What it replaces: no TPU kernel.  The JAX package's update
// (src/repro/optim/adamw.py::apply_updates, its per-leaf ``upd``) is jnp
// that XLA fuses into one pass a leaf; the port ran it as about fifteen
// eager elementwise operations a leaf (``optim/adamw.py``'s plain loop,
// which stays as this kernel's plain version).  This is that one pass.
//
// Per element, in f32, with the step's scalars read from a device tensor
// (clip scale, lr, 1 - b1^t, 1 - b2^t: a CUDA graph's replay reads each
// step's values) and the configuration's constants as arguments:
//     g  = grad * scale
//     m' = m * b1 + (1 - b1) * g                  (stored in m's dtype)
//     v' = v * b2 + ((1 - b2) * g) * g
//     w' = w - lr * ((m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)
//                    + wd * w)                    (the f32 master)
//     p  = w'                                     (cast to p's dtype)
// each operation rounded on its own (__fmul_rn and friends: no fused
// multiply-add), in the plain version's order, so the two agree bit for
// bit where the plain version runs on the card.  The delta takes m' in
// f32, before a bf16 m is rounded, as the reference's does.
//
// g is bf16 or f32, m f32 (bf16 under ``compress_moments``), v and the
// master f32, the parameter bf16 or f32; all contiguous and of one length.
//
// Bound on the card: bytes.  Read g, m, v and the master, write m, v, the
// master and the parameter: 28 bytes an element for a bf16 leaf with f32
// moments, 4 FLOPs a byte at most -- far under the 295 a byte where the
// tensor cores would bind.  hymba-1.5b's 1.66 B parameters move 46 GB, 14 ms
// at 3.35 TB/s.
//
// Design: a grid-stride loop over groups of four elements, each array read
// and written with one vector access a group (16 bytes for f32, 8 for bf16)
// where every pointer is aligned for it, then a scalar tail; with any
// pointer misaligned (a view into a larger buffer) every element goes the
// scalar way.  At most eight 256-thread blocks an SM; a small leaf takes
// the blocks its length needs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

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

__device__ __forceinline__ void load4(const float* p, int64_t i,
                                      float out[4]) {
  const float4 x = reinterpret_cast<const float4*>(p)[i];
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int64_t i,
                                      float out[4]) {
  const uint2 x = reinterpret_cast<const uint2*>(p)[i];
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  out[0] = __low2float(a); out[1] = __high2float(a);
  out[2] = __low2float(b); out[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, int64_t i,
                                       const float in[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i,
                                       const float in[4]) {
  uint2 x;
  *reinterpret_cast<__nv_bfloat162*>(&x.x) =
      __halves2bfloat162(__float2bfloat16_rn(in[0]),
                         __float2bfloat16_rn(in[1]));
  *reinterpret_cast<__nv_bfloat162*>(&x.y) =
      __halves2bfloat162(__float2bfloat16_rn(in[2]),
                         __float2bfloat16_rn(in[3]));
  reinterpret_cast<uint2*>(p)[i] = x;
}

// one element: the plain version's operations in its order, each rounded
__device__ __forceinline__ void update(float g, float& m, float& v, float& w,
                                       float scale, float lr, float b1c,
                                       float b2c, const Consts& c) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.omb1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(g, c.omb2), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps);
  const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m, b1c), den),
                                __fmul_rn(w, c.wd));
  w = __fsub_rn(w, __fmul_rn(lr, delta));
}

template <typename G, typename M, typename P, bool VEC>
__global__ void __launch_bounds__(256)
    adamw_kernel(const G* __restrict__ g, M* __restrict__ m,
                 float* __restrict__ v, float* __restrict__ w,
                 P* __restrict__ p, const float* __restrict__ scalars,
                 int64_t n, Consts c) {
  const float scale = scalars[0], lr = scalars[1], b1c = scalars[2],
              b2c = scalars[3];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t start = 0;
  if (VEC) {
    const int64_t n4 = n / 4;
    for (int64_t i = t; i < n4; i += stride) {
      float gg[4], mm[4], vv[4], ww[4];
      load4(g, i, gg);
      load4(m, i, mm);
      load4(v, i, vv);
      load4(w, i, ww);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        update(gg[k], mm[k], vv[k], ww[k], scale, lr, b1c, b2c, c);
      store4(m, i, mm);
      store4(v, i, vv);
      store4(w, i, ww);
      store4(p, i, ww);
    }
    start = n4 * 4;
  }
  for (int64_t i = start + t; i < n; i += stride) {
    float mm = to_f(m[i]), vv = v[i], ww = w[i];
    update(to_f(g[i]), mm, vv, ww, scale, lr, b1c, b2c, c);
    m[i] = from_f<M>(mm);
    v[i] = vv;
    w[i] = ww;
    p[i] = from_f<P>(ww);
  }
}

template <typename T>
bool aligned4(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % (4 * sizeof(T)) == 0;
}

template <typename G, typename M, typename P>
int launch(const void* g, void* m, void* v, void* w, void* p,
           const void* scalars, int64_t n, const Consts& c,
           cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool vec = aligned4<G>(g) && aligned4<M>(m) && aligned4<float>(v) &&
                   aligned4<float>(w) && aligned4<P>(p);
  const int64_t work = vec ? n / 4 + 4 : n;
  const int64_t want = (work + 255) / 256;
  const int blocks = (int)(want < 8 * sms ? want : 8 * sms);
  if (vec)
    adamw_kernel<G, M, P, true><<<blocks, 256, 0, s>>>(
        static_cast<const G*>(g), static_cast<M*>(m), static_cast<float*>(v),
        static_cast<float*>(w), static_cast<P*>(p),
        static_cast<const float*>(scalars), n, c);
  else
    adamw_kernel<G, M, P, false><<<blocks, 256, 0, s>>>(
        static_cast<const G*>(g), static_cast<M*>(m), static_cast<float*>(v),
        static_cast<float*>(w), static_cast<P*>(p),
        static_cast<const float*>(scalars), n, c);
  return (int)cudaGetLastError();
}

template <typename G, typename M>
int launch_p(int p_bf16, const void* g, void* m, void* v, void* w, void* p,
             const void* scalars, int64_t n, const Consts& c,
             cudaStream_t s) {
  return p_bf16 ? launch<G, M, __nv_bfloat16>(g, m, v, w, p, scalars, n, c, s)
                : launch<G, M, float>(g, m, v, w, p, scalars, n, c, s);
}

template <typename G>
int launch_m(int m_bf16, int p_bf16, const void* g, void* m, void* v,
             void* w, void* p, const void* scalars, int64_t n,
             const Consts& c, cudaStream_t s) {
  return m_bf16 ? launch_p<G, __nv_bfloat16>(p_bf16, g, m, v, w, p, scalars,
                                             n, c, s)
                : launch_p<G, float>(p_bf16, g, m, v, w, p, scalars, n, c, s);
}

}  // namespace

// (g, m, v, master, p, scalars, n, g_bf16, m_bf16, p_bf16, b1, 1 - b1, b2,
//  1 - b2, eps, weight_decay, stream); scalars: 4 f32 on the device
extern "C" int repro_adamw(const void* g, void* m, void* v, void* w, void* p,
                           const void* scalars, long long n, int g_bf16,
                           int m_bf16, int p_bf16, float b1, float omb1,
                           float b2, float omb2, float eps, float wd,
                           void* stream) {
  if (n <= 0) return 0;
  const Consts c{b1, omb1, b2, omb2, eps, wd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g_bf16 ? launch_m<__nv_bfloat16>(m_bf16, p_bf16, g, m, v, w, p,
                                          scalars, n, c, s)
                : launch_m<float>(m_bf16, p_bf16, g, m, v, w, p, scalars, n,
                                  c, s);
}

// The backward pass of the Mamba-1 selective scan from a zero state on
// NVIDIA Hopper (sm_90a), loaded through ctypes:
// ``kernels/mamba_scan.py::mamba_scan_bwd``, the backward of the training
// path's scan Function.
//
// What it stands for: the gradient of src/repro/kernels/mamba_scan.py
// ::_kernel (the Pallas TPU kernel behind ``mamba_scan``).  The JAX package
// has no backward of its own for that kernel -- jax.grad cannot
// differentiate its pallas_call -- so its training path only differentiates
// the jnp reference.  Forward, per channel (b, d) and state n, in f32:
//     h_t = a_t h_{t-1} + x_t B_t,  a_t = exp(dt_t A[d]),  x_t = dt_t u_t,
//     y_t = sum_n h_t C_t + D[d] u_t,   h_{-1} = 0.
// Backward from dy, with g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1}:
//     dC_t += dy_t h_t,  dB_t += g_t x_t        (summed over the channels)
//     du_t = dy_t D + dt_t sum_n g_t B_t
//     ddt_t = u_t sum_n g_t B_t + sum_n g_t (a_t h_{t-1}) A
//     dA += sum_{b,t} g_t (a_t h_{t-1}) dt_t,  dD += sum_{b,t} dy_t u_t
// with a_t h_{t-1} taken as h_t - x_t B_t.
//
// u, dt, dy (B, S, di) and Bc, Cc (B, S, N), contiguous, all f32 or all
// bf16; A (di, N), D (di,) f32.  du, ddt (B, S, di) and dBc, dCc (B, S, N)
// come out in u's dtype, dA (di, N) and dD (di,) in f32.  Scratch (f32):
// the checkpoints (B, S / kT, N, di), the per-block partial sums of dBc
// and dCc (di / 32, B, S, 2N), and per batch row dA (B, di, N) and dD
// (B, di).
//
// Bound on the card: the larger of the bytes (u, dt, dy, du and ddt once;
// Bc, Cc, dBc and dCc once; A, D, dA and dD once) and the least
// arithmetic: per (t, d, n) one forward recurrence for the states and the
// reverse walk, 13 FMA-pipe instructions and two exps -- which bind, as
// the forward scan's exps do.  This kernel recomputes each chunk's states
// once more (three exps).
//
// Design, deterministic (no atomics):
// * scan_bwd_kernel: a block holds 32 channels of one batch row; a
//   channel's N states are spread over G = N / K lanes, K = min(N, 4)
//   states a lane (at N = 16: 4 lanes a channel, 8 channels a warp, 4
//   warps), so hymba's shape runs 1,600 warps.  Every lane of a block
//   reads the same Bc and Cc.  The block stages each chunk of kT = 16
//   steps (u, dt, dy of its channels and Bc, Cc, converted to f32) into
//   shared memory with coalesced loads, so a dependent global load is paid
//   once a chunk, not once a step.  It runs the recurrence forward and
//   writes the state at every chunk boundary; then walks the chunks in
//   reverse: each chunk's states are recomputed from its checkpoint into
//   shared memory, and its steps are walked backwards carrying g.  Per
//   step the G lanes of a channel sum their terms of du and ddt by
//   shuffles, and the warp's channels sum their 2N contributions to dBc
//   and dCc by a butterfly reduce-scatter (7 shuffles at N = 16: lane j of
//   a state group ends with one value); the warps' sums meet in shared
//   memory, and each chunk writes du, ddt and one partial of dBc and dCc
//   per (block, b, t) with coalesced stores.  dA and dD stay in registers
//   over the sequence.
// * finish_kernel sums the partials over the di / 32 blocks (dBc, dCc) and
//   dA and dD over the batch rows, in a fixed order.
// The softplus of dt and A = -exp(A_log) stay outside, under autograd.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 16;                // steps per checkpointed chunk
constexpr int kFinishThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 2^x, one MUFU.EX2; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Args {
  const void* u;
  const void* dt;
  const float* A;
  const void* Bc;
  const void* Cc;
  const float* D;
  const void* dy;
  void* du;
  void* ddt;
  float* dA;
  void* dBc;
  void* dCc;
  float* dD;
  float* ckpt;      // (B, nC, N, di)
  float* part;      // (di / 32, B, S, 2N)
  float* dA_part;   // (B, di, N)
  float* dD_part;   // (B, di)
  int B, S, di;
};

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

constexpr int kChannels = 32;         // channels of a block

// how a channel's N states spread over a warp's lanes
template <int N>
struct Shape {
  static constexpr int K = N < 4 ? N : 4;        // states a lane
  static constexpr int G = N / K;                // lanes a channel
  static constexpr int CW = 32 / G;              // channels a warp
  static constexpr int W = kChannels / CW;       // warps a block
  // shared memory, f32: the staged chunk (u, dt, dy [kT][32]; Bc, Cc
  // [kT][N]), its states [kT][32][N], the warps' partials of dBc and dCc
  // [W][kT][2N], du and ddt [kT][32]
  static constexpr size_t kBytes =
      4 * static_cast<size_t>(5 * kT * kChannels + 2 * kT * N +
                              kT * kChannels * N + W * kT * 2 * N);
};

// V values a lane summed over the channels of its warp (the lanes
// c * G + g of one state group g; V a power of two <= 32 / G): lane
// c * G + g returns the sum of value c / (32 / G / V).  The first log2 V
// levels of the butterfly halve the values each lane carries; the rest
// sum
template <int V, int G>
__device__ __forceinline__ float reduce_channels(float (&v)[V], int lane) {
  constexpr int kLevels = log2i(V), kAll = log2i(32 / G);
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const int w = V >> lv, off = 16 >> lv;
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const float send = upper ? v[i] : v[i + w / 2];
      const float keep = upper ? v[i + w / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float x = v[0];
#pragma unroll
  for (int lv = kLevels; lv < kAll; ++lv)
    x += __shfl_xor_sync(0xffffffffu, x, 16 >> lv);
  return x;
}

template <typename T, int N>
__global__ void __launch_bounds__(128) scan_bwd_kernel(Args a) {
  using C = Shape<N>;
  constexpr int K = C::K, G = C::G, CW = C::CW, W = C::W, V = 2 * K;
  constexpr int kThreads = 32 * W;
  extern __shared__ __align__(16) float sm[];
  float* su = sm;                          // [kT][32]
  float* sdt = su + kT * kChannels;
  float* sdy = sdt + kT * kChannels;
  float* sdu = sdy + kT * kChannels;
  float* sddt = sdu + kT * kChannels;
  float* sB = sddt + kT * kChannels;       // [kT][N]
  float* sC = sB + kT * N;
  float* hs = sC + kT * N;                 // [kT][32][N]
  float* red = hs + kT * kChannels * N;    // [W][kT][2N]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cw = lane / G, g = lane % G;
  const int ch = warp * CW + cw;           // the lane's channel in the block
  const int blk = blockIdx.x, b = blockIdx.y;
  const int S = a.S, di = a.di;
  const int d0 = blk * kChannels, d = d0 + ch;
  const bool ok = d < di;
  const int nC = (S + kT - 1) / kT;
  const T* u = static_cast<const T*>(a.u);
  const T* dt = static_cast<const T*>(a.dt);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bc = static_cast<const T*>(a.Bc);
  const T* Cc = static_cast<const T*>(a.Cc);
  float A2[K], Af[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Af[k] = ok ? a.A[static_cast<size_t>(d) * N + g * K + k] : 0.f;
    A2[k] = Af[k] * kLog2e;
  }
  const float Dd = ok ? a.D[d] : 0.f;
  auto ckpt = [&](int c, int k) -> float& {
    return a.ckpt[((static_cast<size_t>(b) * nC + c) * N + g * K + k) * di +
                  d];
  };
  // chunk c of the block's inputs to shared memory (f32, zeros past the
  // ends); dy and Cc only for the reverse walk
  auto stage = [&](int c, bool rev) {
    const int t0 = c * kT;
    for (int i = tid; i < kT * kChannels; i += kThreads) {
      const int t = t0 + i / kChannels, dd = d0 + i % kChannels;
      const bool live = t < S && dd < di;
      const size_t off = (static_cast<size_t>(b) * S + t) * di + dd;
      su[i] = live ? to_f32(u[off]) : 0.f;
      sdt[i] = live ? to_f32(dt[off]) : 0.f;
      if (rev) sdy[i] = live ? to_f32(dy[off]) : 0.f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const bool live = t0 + i / N < S;
      const size_t off = (static_cast<size_t>(b) * S + t0) * N + i;
      sB[i] = live ? to_f32(Bc[off]) : 0.f;
      if (rev) sC[i] = live ? to_f32(Cc[off]) : 0.f;
    }
  };
  // one step of the recurrence, the chunk's step tt
  auto step = [&](float (&h)[K], int tt) {
    const float dd = sdt[tt * kChannels + ch];
    const float x = dd * su[tt * kChannels + ch];
    const float* Bt = sB + tt * N + g * K;
#pragma unroll
    for (int k = 0; k < K; ++k)
      h[k] = fmaf(ex2(dd * A2[k]), h[k], x * Bt[k]);
  };

  // forward: the state before every chunk
  float h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) h[k] = 0.f;
  for (int c = 0; c < nC; ++c) {
    if (ok) {
#pragma unroll
      for (int k = 0; k < K; ++k) ckpt(c, k) = h[k];
    }
    stage(c, false);
    __syncthreads();
    const int steps = min(kT, S - c * kT);
    for (int tt = 0; tt < steps; ++tt) step(h, tt);
    __syncthreads();
  }

  // reverse, chunk by chunk
  float ag[K], dA[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ag[k] = dA[k] = 0.f;
  float dDs = 0.f;
  T* du = static_cast<T*>(a.du);
  T* ddt = static_cast<T*>(a.ddt);
  constexpr int kDup = CW / V;              // lanes holding each value
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kT, steps = min(kT, S - t0);
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = ok ? ckpt(c, k) : 0.f;
    stage(c, true);
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      step(h, tt);
#pragma unroll
      for (int k = 0; k < K; ++k)
        hs[(tt * kChannels + ch) * N + g * K + k] = h[k];
    }
    for (int tt = steps - 1; tt >= 0; --tt) {
      const float uu = su[tt * kChannels + ch], dd = sdt[tt * kChannels + ch];
      const float gy = sdy[tt * kChannels + ch];
      const float x = dd * uu;
      const float* Bt = sB + tt * N + g * K;
      const float* Ct = sC + tt * N + g * K;
      const float* ht = hs + (tt * kChannels + ch) * N + g * K;
      float vals[V];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float Bn = Bt[k];
        const float gn = fmaf(gy, Ct[k], ag[k]);
        const float hn = ht[k];
        vals[k] = gn * x;                     // dBc
        vals[K + k] = gy * hn;                // dCc
        s1 = fmaf(gn, Bn, s1);
        const float gha = gn * fmaf(-x, Bn, hn);   // g (a_t h_{t-1})
        s2 = fmaf(gha, Af[k], s2);
        dA[k] = fmaf(gha, dd, dA[k]);
        ag[k] = ex2(dd * A2[k]) * gn;
      }
#pragma unroll
      for (int off = 1; off < G; off *= 2) {   // over the channel's lanes
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (g == 0) {
        sdu[tt * kChannels + ch] = fmaf(gy, Dd, s1 * dd);
        sddt[tt * kChannels + ch] = fmaf(s1, uu, s2);
        dDs = fmaf(gy, uu, dDs);
      }
      const float sum = reduce_channels<V, G>(vals, lane);
      if (cw % kDup == 0) {
        const int v = cw / kDup;
        const int j = v < K ? g * K + v : N + g * K + v - K;
        red[(warp * kT + tt) * 2 * N + j] = sum;
      }
    }
    __syncthreads();
    // the chunk's du and ddt, and the block's partials of dBc and dCc
    for (int i = tid; i < kT * kChannels; i += kThreads) {
      const int t = t0 + i / kChannels, dd = d0 + i % kChannels;
      if (t < S && dd < di) {
        const size_t off = (static_cast<size_t>(b) * S + t) * di + dd;
        store(du + off, sdu[i]);
        store(ddt + off, sddt[i]);
      }
    }
    for (int i = tid; i < kT * 2 * N; i += kThreads) {
      const int tt = i / (2 * N), j = i % (2 * N);
      if (t0 + tt >= S) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) sum += red[(w * kT + tt) * 2 * N + j];
      a.part[((static_cast<size_t>(blk) * a.B + b) * S + t0 + tt) * 2 * N +
             j] = sum;
    }
    __syncthreads();
  }
  if (ok) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      a.dA_part[(static_cast<size_t>(b) * di + d) * N + g * K + k] = dA[k];
    if (g == 0) a.dD_part[static_cast<size_t>(b) * di + d] = dDs;
  }
}

// dBc and dCc: the partials summed over the blocks; dA and dD over the
// batch rows
template <typename T, int N>
__global__ void __launch_bounds__(kFinishThreads) finish_kernel(Args a,
                                                                int nblk) {
  constexpr int V = 2 * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kFinishThreads +
                   threadIdx.x;
  const size_t n1 = static_cast<size_t>(a.B) * a.S * V;
  const size_t n2 = static_cast<size_t>(a.di) * N;
  if (i < n1) {
    float sum = 0.f;
    for (int w = 0; w < nblk; ++w) sum += a.part[w * n1 + i];
    const size_t bt = i / V;
    const int j = static_cast<int>(i % V);
    if (j < N)
      store(static_cast<T*>(a.dBc) + bt * N + j, sum);
    else
      store(static_cast<T*>(a.dCc) + bt * N + j - N, sum);
  } else if (i < n1 + n2) {
    const size_t k = i - n1;
    float sum = 0.f;
    for (int b = 0; b < a.B; ++b) sum += a.dA_part[b * n2 + k];
    a.dA[k] = sum;
  } else if (i < n1 + n2 + a.di) {
    const size_t k = i - n1 - n2;
    float sum = 0.f;
    for (int b = 0; b < a.B; ++b)
      sum += a.dD_part[static_cast<size_t>(b) * a.di + k];
    a.dD[k] = sum;
  }
}

template <typename T, int N>
int launch(const Args& a, cudaStream_t s) {
  using C = Shape<N>;
  // raise the shared-memory limit once, at the first launch (not again
  // inside a CUDA-graph capture)
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const int nblk = (a.di + kChannels - 1) / kChannels;
  scan_bwd_kernel<T, N><<<dim3(nblk, a.B), 32 * C::W, C::kBytes, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(a.B) * a.S * 2 * N +
                       static_cast<size_t>(a.di) * (N + 1);
  const unsigned grid =
      static_cast<unsigned>((total + kFinishThreads - 1) / kFinishThreads);
  finish_kernel<T, N><<<grid, kFinishThreads, 0, s>>>(a, nblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const Args& a, int N, cudaStream_t s) {
  switch (N) {
    case 1: return launch<T, 1>(a, s);
    case 2: return launch<T, 2>(a, s);
    case 4: return launch<T, 4>(a, s);
    case 8: return launch<T, 8>(a, s);
    case 16: return launch<T, 16>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int repro_mamba_scan_bwd(
    const void* u, const void* dt, const void* A, const void* Bc,
    const void* Cc, const void* D, const void* dy, void* du, void* ddt,
    void* dA, void* dBc, void* dCc, void* dD, void* ckpt, void* part,
    void* dA_part, void* dD_part, int B, int S, int di, int N, int chunk,
    int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  if (chunk != kT) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{u, dt, static_cast<const float*>(A), Bc, Cc,
               static_cast<const float*>(D), dy, du, ddt,
               static_cast<float*>(dA), dBc, dCc, static_cast<float*>(dD),
               static_cast<float*>(ckpt), static_cast<float*>(part),
               static_cast<float*>(dA_part), static_cast<float*>(dD_part), B,
               S, di};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_n<__nv_bfloat16>(a, N, s)
                 : launch_n<float>(a, N, s);
}

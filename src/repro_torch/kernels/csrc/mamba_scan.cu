// Mamba-1 selective scan for NVIDIA Hopper (sm_90a), loaded through ctypes.
//
// What it replaces: src/repro/kernels/mamba_scan.py::_kernel (the Pallas
// TPU kernel behind ``mamba_scan``).  It also takes an initial state, which
// the JAX package's ``ops.mamba_scan`` sends to its jnp reference
// (src/repro/kernels/ref.py::mamba_scan_reference): the decode step runs it
// with S = 1 and the cached state.
//
// u, dt (B, S, di) and Bc, Cc (B, S, N), contiguous, all f32 or all bf16;
// A (di, N), D (di,) and the optional init (B, di, N) in f32.  Per channel
// (b, d), in f32:
//     h <- exp(dt_t * A[d]) * h + (dt_t * u_t) * Bc_t        (N-vector)
//     y_t = sum_n h[n] * Cc_t[n] + D[d] * u_t
// y (B, S, di) in u's dtype, and the last state (B, di, N) in f32.
//
// Bound on the card: every element of u, dt and y moves once, plus Bc and
// Cc, for about 5 operations per (t, d, n) -- the exp, the dt*A product,
// the state update and the output product.  At hymba's (4, 2048, 3200, 16)
// in bf16 that is 157 MB against 2.1 G operations: the bytes bound it
// (47 us at 3.35 TB/s against 31 us at the 67 TFLOP/s f32 rate).
//
// Design, simple first: one thread per (b, d) channel keeps its N-vector
// state and its row of A in registers and walks the sequence in order; the
// TPU's sequential grid over chunks becomes this in-block loop, and nothing
// carries between blocks.  A block holds kCh channels of one batch row.
// Per chunk of kT steps the block stages u and dt (kT x kCh) and Bc, Cc
// (kT x N, shared by all its channels) in shared memory with coalesced
// loads, runs the recurrence out of shared memory, writes y over u in
// place and stores it back coalesced.  B * di threads is all the
// parallelism (12,800 at hymba's shape, ~3 warps per SM), so the chain of
// dependent steps, not the memory, sets the time; splitting N across
// lanes is the next step.  Launches go on the caller's stream and never
// synchronise; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;   // channels (threads) per block
constexpr int kT = 64;    // time steps staged per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kCh)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bc,
            const T* __restrict__ Cc, const float* __restrict__ D,
            const float* __restrict__ init, T* __restrict__ y,
            float* __restrict__ last, int S, int di) {
  __shared__ float u_s[kT][kCh];    // u, then y in place
  __shared__ float dt_s[kT][kCh];
  __shared__ float B_s[kT][N];
  __shared__ float C_s[kT][N];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + threadIdx.x;
  const bool on = d < di;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = on ? A[static_cast<size_t>(d) * N + n] : 0.f;
    h[n] = (on && init) ? init[(static_cast<size_t>(b) * di + d) * N + n] : 0.f;
  }
  const float Dd = on ? D[d] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int T_ = min(kT, S - t0);
    for (int i = threadIdx.x; i < T_ * kCh; i += kCh) {
      const int t = i / kCh, c = i % kCh;
      const bool ok = d0 + c < di;
      const size_t g = (static_cast<size_t>(b) * S + t0 + t) * di + d0 + c;
      u_s[t][c] = ok ? to_f32(u[g]) : 0.f;
      dt_s[t][c] = ok ? to_f32(dt[g]) : 0.f;
    }
    for (int i = threadIdx.x; i < T_ * N; i += kCh) {
      const int t = i / N, n = i % N;
      const size_t g = (static_cast<size_t>(b) * S + t0 + t) * N + n;
      B_s[t][n] = to_f32(Bc[g]);
      C_s[t][n] = to_f32(Cc[g]);
    }
    __syncthreads();
    for (int t = 0; t < T_; ++t) {
      const float ut = u_s[t][threadIdx.x];
      const float dtt = dt_s[t][threadIdx.x];
      const float du = dtt * ut;
      float yt = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtt * a[n]) * h[n] + du * B_s[t][n];
        yt += h[n] * C_s[t][n];
      }
      u_s[t][threadIdx.x] = yt + ut * Dd;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T_ * kCh; i += kCh) {
      const int t = i / kCh, c = i % kCh;
      if (d0 + c < di)
        store(y + (static_cast<size_t>(b) * S + t0 + t) * di + d0 + c,
              u_s[t][c]);
    }
    __syncthreads();
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      last[(static_cast<size_t>(b) * di + d) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const void* A, const void* Bc,
           const void* Cc, const void* D, const void* init, void* y,
           void* last, int B, int S, int di, cudaStream_t stream) {
  const dim3 grid((di + kCh - 1) / kCh, B);
  scan_kernel<T, N><<<grid, kCh, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<const float*>(D),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(last), S, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* u, const void* dt, const void* A, const void* Bc,
             const void* Cc, const void* D, const void* init, void* y,
             void* last, int B, int S, int di, int N, cudaStream_t s) {
  switch (N) {
    case 1: return launch<T, 1>(u, dt, A, Bc, Cc, D, init, y, last, B, S, di, s);
    case 2: return launch<T, 2>(u, dt, A, Bc, Cc, D, init, y, last, B, S, di, s);
    case 4: return launch<T, 4>(u, dt, A, Bc, Cc, D, init, y, last, B, S, di, s);
    case 8: return launch<T, 8>(u, dt, A, Bc, Cc, D, init, y, last, B, S, di, s);
    case 16: return launch<T, 16>(u, dt, A, Bc, Cc, D, init, y, last, B, S, di, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_mamba_scan(const void* u, const void* dt, const void* A,
                                const void* Bc, const void* Cc, const void* D,
                                const void* init, void* y, void* last, int B,
                                int S, int di, int N, int is_bf16,
                                void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_n<__nv_bfloat16>(u, dt, A, Bc, Cc, D, init, y, last,
                                          B, S, di, N, s)
                 : launch_n<float>(u, dt, A, Bc, Cc, D, init, y, last, B, S,
                                   di, N, s);
}

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
// Bound on the card: the larger of two terms.
//   bytes: u, dt and y once, Bc and Cc once, A, D and the states once;
//   arithmetic: per (t, d, n) four FMA-pipe instructions -- dt * A,
//     (dt * u) * B, the state's FMA and y's FMA -- and one exp2.  An SM
//     issues 128 FMA-pipe instructions and 16 MUFU.EX2 per clock, and an
//     exp2 emulated on the FMA pipe (range split and a degree-6
//     polynomial) takes about 10 instructions, so the fastest split sends
//     14/18 of the exps to the special-function unit and the rest to the
//     FMA pipe, which then finish together.
// At hymba's prefill, (4, 2048, 3200, 16) in bf16: 157 MB (47 us at 3.35
// TB/s); 419 M exps take 100 us on the special-function units alone (132
// SMs at 1.98 GHz) and the rest of the recurrence 50 us on the FMA pipes;
// split, the arithmetic takes 78 us and binds.  At its decode step (S = 1)
// the bytes do: the state read and written, 1.64 MB, 0.58 us.
//
// Design.
// * Prefill (scan_kernel): the N states of a channel are spread over a
//   group of G = N / K lanes, K states per lane (K = 4: four lanes per
//   channel at N = 16, eight channels per warp), so hymba's shape runs 1,600
//   warps instead of 400.  Each batch row's whole sequence stays in its
//   warp: nothing carries between warps and no exp is computed twice.
// * Every warp is its own pipeline: it stages its own channels' u and dt and
//   its own copy of the row's Bc and Cc, and synchronises only with
//   __syncwarp.  A block is one warp: with nothing shared, small blocks
//   spread the warps evenly (hymba's 1,600 over 132 SMs: at most 13 on an
//   SM, where 4-warp blocks put 16 on some).
// * Loads: chunks of kT = 16 steps of u, dt (kT x CW channels) and Bc, Cc
//   (kT x N) go by cp.async (16-byte pieces, zero-filled past the edges)
//   into a ring of three buffers, two chunks ahead of the compute; one pass
//   per chunk converts them to f32 (dt, dt * u, B, C).  Steps past S and
//   channels past di are zeros, which leave a state as it is (exp(0) = 1,
//   no input), so every chunk runs all kT steps.  Shapes whose rows are not
//   16-byte aligned load and store element by element instead.
// * Each lane keeps its K states and A * log2(e) in registers; each exp is
//   one MUFU.EX2 of a non-negative argument (``decay2``, which says why),
//   and within a chunk the state is kept scaled by powers of two so that
//   the factor this costs needs no multiply.  A chunk's steps run unrolled
//   with loads only; then the G lanes of each channel sum their partial y's
//   by a butterfly reduce-scatter, G steps at a time (G - 1 shuffles for G
//   steps, every step's independent of the others), after which lane g
//   holds step g's sum, adds D * u and writes y to a tile that goes out
//   with 16-byte stores.
// * What holds it back, as far as probes without a profiler show: latency
//   more than issue rate -- with the exps removed most of the time stayed,
//   and each SM holds 12-13 warps at hymba's shape, too few to hide the
//   dependent loads, exps and shuffles of each step.
// * Decode (step_kernel, S = 1): the same K states per lane over 256-thread
//   blocks of B * di channels; init, A and last move as 16-byte vectors,
//   y is reduced by shuffles.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStatesPerLane = 4;   // K, at most; a channel takes N / K lanes
constexpr int kT = 16;              // time steps per staged chunk
constexpr int kStages = 3;          // staging ring of each warp
constexpr int kStepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int lanes_k(int N) {
  return N < kStatesPerLane ? N : kStatesPerLane;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero() {
  T z;
  store(&z, 0.f);
  return z;
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// K consecutive floats, as 16-byte vectors where K allows and the caller
// vouches for the alignment
template <int K, bool VEC>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
  if constexpr (VEC && K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = p[i];
  }
}
template <int K, bool VEC>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (VEC && K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = v[i];
  }
}

// 2^x, one MUFU.EX2; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2 exp(dt * A) from a2 = A * log2(e): 2^(y + 1) with y = dt * a2.  The
// special-function unit truncates the fraction of a negative argument, so
// ex2 of y itself comes out 1-2 ulp low for most y in (-1, 0) -- a bias that
// a state with a long memory (exp(dt * A) near 1) accumulates step after
// step.  For y in [-1, 0) the argument y + 1 lies in [0, 1), rounded once by
// the FMA; dt = 0 gives exactly 2.
__device__ __forceinline__ float decay2(float dt, float a2) {
  return ex2(fmaf(dt, a2, 1.f));
}
__device__ __forceinline__ float pow2(int e) {   // 2^e, -126 <= e <= 127
  return __int_as_float((e + 127) << 23);
}

// 16 bytes global -> shared, the first ``src_bytes`` of them read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_two_newest() {
  asm volatile("cp.async.wait_group 2;\n" ::);
}

// channels of one warp: one per group of N / K lanes
__host__ __device__ constexpr int warp_channels(int N) {
  return 32 / (N / lanes_k(N));
}

// shared memory of one warp, in bytes: the staging ring (u, dt as
// [kT][CW], Bc, Cc as [kT][N], in T), the f32 chunk (dt, dt * u, B, C) and
// the y tile in T; CW is the warp's channel count
template <typename T, int N>
__host__ __device__ constexpr int stage_bytes() {
  return (2 * kT * warp_channels(N) + 2 * kT * N) *
         static_cast<int>(sizeof(T));
}
template <typename T, int N>
__host__ __device__ constexpr int warp_bytes() {
  return kStages * stage_bytes<T, N>() +
         (2 * kT * warp_channels(N) + 2 * kT * N) * 4 +
         kT * warp_channels(N) * static_cast<int>(sizeof(T));
}

struct Tile {      // chunk ``t0`` of batch row ``b``, the warp's channels
  int b, t0, S, di, d0;
  __device__ int steps() const { return min(kT, S - t0); }
  __device__ size_t row(int t) const {
    return (static_cast<size_t>(b) * S + t0 + t) * di + d0;
  }
};

// issue the loads of one chunk into a staging buffer (VEC: cp.async, else
// plain loads and stores), by the 32 lanes of one warp
template <typename T, int N, bool VEC>
__device__ __forceinline__ void stage(unsigned char* st, const T* u,
                                      const T* dt, const T* Bc, const T* Cc,
                                      const Tile& c, int lane) {
  constexpr int CW = warp_channels(N);
  T* us = reinterpret_cast<T*>(st);
  T* dts = us + kT * CW;
  T* Bs = dts + kT * CW;
  T* Cs = Bs + kT * N;
  const int steps = c.steps();
  const size_t bc0 = (static_cast<size_t>(c.b) * c.S + c.t0) * N;
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);    // elements per piece
    constexpr int RP = CW / E;           // pieces per row
    static_assert(RP * E == CW, "a warp's rows are 16-byte pieces");
    for (int i = lane; i < kT * RP; i += 32) {
      const int t = i / RP, ch = (i % RP) * E;
      const bool ok = t < steps && c.d0 + ch < c.di;  // pieces whole: E | di
      const size_t g = ok ? c.row(t) + ch : 0;
      cp_async16(us + t * CW + ch, u + g, ok ? 16 : 0);
      cp_async16(dts + t * CW + ch, dt + g, ok ? 16 : 0);
    }
    // the chunk's kT x N values of Bc and Cc are one contiguous range
    for (int i = lane; i < kT * N / E; i += 32) {
      const int e0 = i * E;
      const int n = max(0, min(E, steps * N - e0));
      const size_t g = n ? bc0 + e0 : 0;
      cp_async16(Bs + e0, Bc + g, n * static_cast<int>(sizeof(T)));
      cp_async16(Cs + e0, Cc + g, n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = lane; i < kT * CW; i += 32) {
      const int t = i / CW, ch = i % CW;
      const bool ok = t < steps && c.d0 + ch < c.di;
      const size_t g = ok ? c.row(t) + ch : 0;
      us[i] = ok ? u[g] : zero<T>();
      dts[i] = ok ? dt[g] : zero<T>();
    }
    for (int i = lane; i < kT * N; i += 32) {
      const bool ok = i < steps * N;
      Bs[i] = ok ? Bc[bc0 + i] : zero<T>();
      Cs[i] = ok ? Cc[bc0 + i] : zero<T>();
    }
  }
}

// one staged chunk to f32, two values a lane at a time: dt, dt * u (the
// product the reference rounds) times 2^(t + 1), B, and C times 2^-(t + 1)
// for the chunk's step t (the scaled state of scan_kernel)
template <typename T, int N>
__device__ __forceinline__ void convert(const unsigned char* st, float* dtf,
                                        float* duf, float* Bf, float* Cf,
                                        int lane) {
  constexpr int CW = warp_channels(N);
  const T* us = reinterpret_cast<const T*>(st);
  const T* dts = us + kT * CW;
  const T* Bs = dts + kT * CW;
  const T* Cs = Bs + kT * N;
  for (int o = 2 * lane; o < kT * CW; o += 64) {
    const float2 d = load2(dts + o), x = load2(us + o);
    const float up = pow2(o / CW + 1);
    *reinterpret_cast<float2*>(dtf + o) = d;
    *reinterpret_cast<float2*>(duf + o) =
        make_float2(d.x * x.x * up, d.y * x.y * up);
  }
  for (int o = 2 * lane; o < kT * N; o += 64) {
    const float2 c = load2(Cs + o);
    // N = 1: the pair spans two steps
    const float d0 = pow2(-(o / N + 1)), d1 = pow2(-((o + 1) / N + 1));
    *reinterpret_cast<float2*>(Bf + o) = load2(Bs + o);
    *reinterpret_cast<float2*>(Cf + o) = make_float2(c.x * d0, c.y * d1);
  }
}

// a chunk's y tile to device memory, its valid steps and channels
template <typename T, int N, bool VEC>
__device__ __forceinline__ void store_y(const T* ys, T* y, const Tile& c,
                                        int lane) {
  constexpr int CW = warp_channels(N);
  const int steps = c.steps();
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T), RP = CW / E;
    for (int i = lane; i < steps * RP; i += 32) {
      const int t = i / RP, ch = (i % RP) * E;
      if (c.d0 + ch < c.di)
        *reinterpret_cast<uint4*>(y + c.row(t) + ch) =
            *reinterpret_cast<const uint4*>(ys + t * CW + ch);
    }
  } else {
    for (int i = lane; i < steps * CW; i += 32) {
      const int t = i / CW, ch = i % CW;
      if (c.d0 + ch < c.di) y[c.row(t) + ch] = ys[i];
    }
  }
}

template <typename T, int N, int K, bool VEC>
__global__ void __launch_bounds__(32)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bc,
            const T* __restrict__ Cc, const float* __restrict__ D,
            const float* __restrict__ init, T* __restrict__ y,
            float* __restrict__ last, int S, int di) {
  constexpr int G = N / K;                 // lanes per channel
  constexpr int CW = warp_channels(N);     // channels per warp
  extern __shared__ __align__(16) unsigned char smem[];
  // one warp per block; the "% 32" lets the compiler bound the lane's
  // offsets, which shortens the address arithmetic of the unrolled loop
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y, d0 = blockIdx.x * CW;
  float* dtf = reinterpret_cast<float*>(smem + kStages * stage_bytes<T, N>());
  float* duf = dtf + kT * CW;
  float* Bf = duf + kT * CW;
  float* Cf = Bf + kT * N;
  T* ys = reinterpret_cast<T*>(Cf + kT * N);

  // lane g of a channel's group holds its states g*K .. g*K + K - 1
  const int g = lane % G, ch = lane / G, d = d0 + ch;
  const bool on = d < di;
  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = g * K + k;
    a2[k] = on ? A[static_cast<size_t>(d) * N + n] * kLog2e : 0.f;
    h[k] = (on && init) ? init[(static_cast<size_t>(b) * di + d) * N + n]
                        : 0.f;
  }
  const float Dd = on ? D[d] : 0.f;

  const int chunks = (S + kT - 1) / kT;
  auto tile = [&](int i) { return Tile{b, i * kT, S, di, d0}; };
  auto ring = [&](int i) { return smem + (i % kStages) * stage_bytes<T, N>(); };

  // two chunks in flight ahead of the one computed
  stage<T, N, VEC>(ring(0), u, dt, Bc, Cc, tile(0), lane);
  cp_async_commit();
  if (chunks > 1) stage<T, N, VEC>(ring(1), u, dt, Bc, Cc, tile(1), lane);
  cp_async_commit();
  for (int i = 0; i < chunks; ++i) {
    if (i + 2 < chunks)
      stage<T, N, VEC>(ring(i + 2), u, dt, Bc, Cc, tile(i + 2), lane);
    cp_async_commit();
    cp_async_wait_all_but_two_newest();
    __syncwarp();      // chunk i staged by every lane
    convert<T, N>(ring(i), dtf, duf, Bf, Cf, lane);
    __syncwarp();

    // the chunk's steps, loads only; then the sums over each group's lanes,
    // the shuffles of all the chunk's steps independent of each other;
    // then y, written to the tile.  Within the chunk the lane keeps
    // H = 2^(t + 1) h after step t: H <- (2 exp(dt A)) H + 2^(t + 1) dt u B
    // and y = H . 2^-(t + 1) C, the scales folded into the converted du and
    // C.  Powers of two change no rounding, and the 2 of the decay (decay2)
    // costs no multiply.
    float yp[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float dtv = dtf[t * CW + ch], duv = duf[t * CW + ch];
      float bv[K], cv[K];
      load_k<K, true>(Bf + t * N + g * K, bv);
      load_k<K, true>(Cf + t * N + g * K, cv);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        h[k] = fmaf(decay2(dtv, a2[k]), h[k], duv * bv[k]);
        acc = fmaf(h[k], cv[k], acc);
      }
      yp[t] = acc;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] *= pow2(-kT);
    // reduce-scatter over the group, G steps at a time: lane g ends with
    // the sum of step t + g in yp[t]
#pragma unroll
    for (int t = 0; t < kT; t += G) {
#pragma unroll
      for (int s = G / 2; s >= 1; s /= 2) {
        const bool hi = g & s;
#pragma unroll
        for (int j = 0; j < s; ++j) {
          const float keep = hi ? yp[t + j + s] : yp[t + j];
          const float send = hi ? yp[t + j] : yp[t + j + s];
          yp[t + j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
        }
      }
    }
    const T* us = reinterpret_cast<const T*>(ring(i));
#pragma unroll
    for (int t = 0; t < kT; t += G) {
      const int o = (t + g) * CW + ch;
      store(ys + o, fmaf(Dd, to_f32(us[o]), yp[t]));
    }
    __syncwarp();      // the y tile written, the ring slot and chunk read
    store_y<T, N, VEC>(ys, y, tile(i), lane);
  }
  if (on)
    store_k<K, false>(last + (static_cast<size_t>(b) * di + d) * N + g * K, h);
}

// the decode step: one step from ``init`` (or zeros) for every channel
template <typename T, int N, int K, bool VEC>
__global__ void __launch_bounds__(kStepThreads)
step_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bc,
            const T* __restrict__ Cc, const float* __restrict__ D,
            const float* __restrict__ init, T* __restrict__ y,
            float* __restrict__ last, int B, int di) {
  constexpr int G = N / K;
  const long long lane = static_cast<long long>(blockIdx.x) * kStepThreads +
                         threadIdx.x;
  const bool on = lane < static_cast<long long>(B) * di * G;
  const int chan = on ? static_cast<int>(lane / G) : 0;
  const int g = static_cast<int>(lane % G);
  const int b = chan / di, d = chan % di;
  const size_t st = static_cast<size_t>(chan) * N + g * K;
  float a[K], h[K];
  load_k<K, VEC>(A + static_cast<size_t>(d) * N + g * K, a);
  if (init) {
    load_k<K, VEC>(init + st, h);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = 0.f;
  }
  const float uv = to_f32(u[chan]), dtv = to_f32(dt[chan]);
  const float duv = dtv * uv;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = g * K + k;
    h[k] = fmaf(0.5f * decay2(dtv, a[k] * kLog2e), h[k],
                duv * to_f32(Bc[static_cast<size_t>(b) * N + n]));
    acc = fmaf(h[k], to_f32(Cc[static_cast<size_t>(b) * N + n]), acc);
  }
#pragma unroll
  for (int s = G / 2; s >= 1; s /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (on) {
    if (g == 0) store(y + chan, fmaf(D[d], uv, acc));
    store_k<K, VEC>(last + st, h);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int N>
dim3 step_grid(int B, int di) {
  const long long lanes = static_cast<long long>(B) * di * (N / lanes_k(N));
  return dim3(static_cast<unsigned>((lanes + kStepThreads - 1) /
                                    kStepThreads));
}

template <typename T, int N, int K, bool VEC>
int run_step(const void* u, const void* dt, const void* A, const void* Bc,
             const void* Cc, const void* D, const void* init, void* y,
             void* last, int B, int di, cudaStream_t stream) {
  step_kernel<T, N, K, VEC><<<step_grid<N>(B, di), kStepThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<const float*>(D),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(last), B, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N, int K, bool VEC>
int run_scan(const void* u, const void* dt, const void* A, const void* Bc,
             const void* Cc, const void* D, const void* init, void* y,
             void* last, int B, int S, int di, cudaStream_t stream) {
  constexpr int CW = warp_channels(N);
  const dim3 grid((di + CW - 1) / CW, B);   // one warp per block
  scan_kernel<T, N, K, VEC><<<grid, 32, warp_bytes<T, N>(), stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<const float*>(D),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(last), S, di);
  return static_cast<int>(cudaGetLastError());
}

// S = 1 takes the step kernel, longer sequences the scan; each with 16-byte
// accesses where the shapes and pointers allow them
template <typename T, int N>
int launch(const void* u, const void* dt, const void* A, const void* Bc,
           const void* Cc, const void* D, const void* init, void* y,
           void* last, int B, int S, int di, cudaStream_t stream) {
  constexpr int K = lanes_k(N);
  if (S == 1) {
    const bool vec = K % 4 == 0 && aligned16(A) && aligned16(last) &&
                     (init == nullptr || aligned16(init));
    return vec ? run_step<T, N, K, true>(u, dt, A, Bc, Cc, D, init, y, last,
                                         B, di, stream)
               : run_step<T, N, K, false>(u, dt, A, Bc, Cc, D, init, y, last,
                                          B, di, stream);
  }
  const bool vec = (static_cast<long long>(di) * sizeof(T)) % 16 == 0 &&
                   (static_cast<long long>(S) * N * sizeof(T)) % 16 == 0 &&
                   aligned16(u) && aligned16(dt) && aligned16(Bc) &&
                   aligned16(Cc) && aligned16(y);
  return vec ? run_scan<T, N, K, true>(u, dt, A, Bc, Cc, D, init, y, last, B,
                                       S, di, stream)
             : run_scan<T, N, K, false>(u, dt, A, Bc, Cc, D, init, y, last, B,
                                        S, di, stream);
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

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
// with g_t (a_t h_{t-1}) taken as (a_t g_t) h_{t-1}, a_t g_t being the
// carry into step t - 1.
//
// u, dt, dy (B, S, di) and Bc, Cc (B, S, N), contiguous, all f32 or all
// bf16; A (di, N), D (di,) f32.  du, ddt (B, S, di) and dBc, dCc (B, S, N)
// come out in u's dtype, dA (di, N) and dD (di,) in f32.  Scratch, all f32,
// shapes from ``mamba_scan.py::bwd_plan``: the local checkpoints (B, S /
// kT, di, N) and the dt summed from the segment's start to each (B, S /
// kT, di); the segment summaries hend, gsum (B, nseg, di, N) and dtsum (B,
// nseg, di); the partial sums of dBc and dCc per 32-channel block (di / 32,
// B, S, 2N); dA and dD per (batch row, segment) (B, nseg, di, N), (B, nseg,
// di).
//
// Bound on the card: the larger of the bytes (u, dt, dy, du and ddt once;
// Bc, Cc, dBc and dCc once; A, D, dA and dD once) and the least
// arithmetic: per (t, d, n) one forward recurrence for the states and the
// reverse walk, 13 FMA-pipe instructions and two exps -- which bind.  At
// hymba's training shape (4, 2048, 3200, 16) in bf16: 0.184 ms (the bytes
// alone 0.079 ms).
//
// Design.  Both recurrences are linear, so the sequence is cut into nseg
// segments of L steps (a multiple of kT = 8; 8 segments of 256 steps at
// hymba's shape, ``mamba_scan.bwd_plan``) that run in parallel, one block
// per (32 channels, batch row, segment) in each pass:
// * seg_fwd_kernel (pass 1): the forward recurrence over the segment from
//   h = 0, writing the local state and the dt summed so far at every
//   chunk boundary, and the segment's summaries: its local end state
//   hend, Sum dt (whose exp is the segment's decay: prod_t a_t =
//   exp(A Sum dt)), and gsum = sum_t (prod_{k <= t} a_k) dy_t C_t, the
//   carry a_{t0} g_{t0} that the segment sends to the one before it when
//   nothing comes from behind it.  The product runs from the segment's
//   first step: the carry out of a segment holds the decay of its own
//   first step.  One exp per (t, d, n), shared by the state and the
//   product.
// * seg_bwd_kernel (pass 2): each lane first folds the summaries in a
//   fixed order -- those before its segment into the true start state
//   (h <- exp(A Sum dt_j) h + hend_j), those after it into the true carry
//   (G <- gsum_j + exp(A Sum dt_j) G) -- then walks the segment's chunks
//   in reverse: the chunk's start state is the checkpoint fixed up, h_loc
//   + exp(A Sum dt) h_start (one exp per chunk); the chunk's kT steps are
//   recomputed with their states and decays kept in registers, then
//   walked backwards carrying a_t g_t.  One exp per (t, d, n): the walk
//   reuses the recompute's decays.
// * finish_kernel sums the dBc and dCc partials over the di / 32 blocks
//   and dA and dD over the (batch row, segment) partials, in a fixed order.
// Inside a block: the block stages each chunk of u, dt, dy (kT x 32) and
// Bc, Cc (kT x N) by cp.async, a 16-byte piece a thread, into a ring of
// three buffers two chunks ahead of the compute, and converts it to f32
// (dt, dt * u, u, dy, B, C) once for all its warps.  A lane holds KC = 2
// adjacent channels and K = 2 states of each (at N = 16: 8 lanes a
// channel pair, 8 channels a warp, 4 warps; small N take fewer), so the
// sums over the channels (dBc, dCc) start in the lane and end in a
// butterfly reduce-scatter over the warp's channel groups (3 shuffles a
// step at N = 16), and the block's warps meet in shared memory; the sums
// over a channel's states (for du and ddt) go to shared memory per step
// (padded against bank conflicts, ``SpLayout``) and are added, with du
// and ddt written, in a pass over the chunk after it.  The chunk's kT
// steps run unrolled, states and decays in registers (at most 128 a
// thread: four blocks an SM).  Steps past S and channels past di are
// zeros, which leave the states and carries as they are.  Every exp is
// one MUFU.EX2 of dt A log2(e) + 1, non-negative where the decay is near
// 1 (``decay``).  Deterministic: no atomics, every sum in a fixed order.
//
// What holds it back (H100, hymba's shape in bf16, PERF.md section 7):
// 0.88 ms against the 0.184 ms bound -- pass 1 0.23, pass 2 0.60, the
// finish 0.04.  Timing probes built apart from this source found pass 2
// 0.25 ms faster without its walk, 0.13 ms faster without the pass that
// writes du, ddt and the dBc/dCc partials, and only 0.02 and 0.01 ms
// faster without the exps or the butterfly.  Beyond the
// bound's 263 MB the kernel moves the checkpoints (210 MB written, read
// back) and the partials (105 MB written, read back): about 1.05 GB in
// all, 0.31 ms at the card's 3.35 TB/s.
// Launches go on the caller's stream and never synchronise; the launcher
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 8;                 // steps per checkpointed chunk
constexpr int kStages = 3;            // staging ring of a block
constexpr int kChannels = 32;         // channels of a block
constexpr int kFinishThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

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

// V consecutive floats, as one vector load or store where V allows (the
// caller keeps them aligned)
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// 2^x, one MUFU.EX2; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(dt * A) from a2 = A * log2(e), as 2^(y + 1) / 2 with y = dt * a2:
// the special-function unit truncates the fraction of a negative argument,
// so ex2 of y itself comes out 1-2 ulp low for most y in (-1, 0) -- a bias
// that a state with a long memory accumulates step after step (see
// mamba_scan.cu::decay2).  dt = 0 gives exactly 1.
__device__ __forceinline__ float decay(float dt, float a2) {
  return 0.5f * ex2(fmaf(dt, a2, 1.f));
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


__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

// how a block's 32 channels and N states spread over its lanes: a lane
// holds KC adjacent channels and K states of each; the G lanes of a
// channel group hold its N states; a warp holds CG groups
template <int N>
struct Shape {
  static constexpr int K = N < 2 ? N : 2;          // states a lane
  static constexpr int G = N / K;                  // lanes a channel group
  static constexpr int CG = 32 / G;                // groups a warp
  static constexpr int KC = N < 4 ? 1 : 2;         // channels a lane
  static constexpr int CW = CG * KC;               // channels a warp
  static constexpr int W = kChannels / CW;         // warps a block
  static constexpr int kThreads = 32 * W;
  // the walk's dBc/dCc values: 2K, each summed over the lane's channels,
  // then over the warp's CG groups
  static constexpr int V = 2 * K;
  static_assert(V <= CG && CW <= kChannels, "a shape the lanes hold");
};

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
  float* ckpt;      // (B, nC, di, N): local state at each chunk's start
  float* cumdt;     // (B, nC, di): dt summed from the segment's start
  float* hend;      // (B, nseg, di, N): local end state of each segment
  float* gsum;      // (B, nseg, di, N): carry out of each segment, alone
  float* dtsum;     // (B, nseg, di): dt summed over each segment
  float* part;      // (di / 32, B, S, 2N): dBc, dCc per 32-channel block
  float* dA_part;   // (B, nseg, di, N)
  float* dD_part;   // (B, nseg, di)
  int B, S, di, L, nseg;
};

// pass 2's per-step sums over each lane's states, 2 KC floats a lane
// (s1, s2 of each channel): [W][kT][CG][G] entries, padded (4 floats a
// group, 16 a warp) so that the chunk pass, whose threads read one
// channel's G entries each, meets no more than two to a bank
template <int N>
struct SpLayout {
  using C = Shape<N>;
  static constexpr int kEntry = 2 * C::KC;
  static constexpr int kGroup = C::G * kEntry + 4;
  static constexpr int kRow = C::CG * kGroup;          // one warp's step
  static constexpr int kWarp = kT * kRow + 16;
  static constexpr int kFloats = C::W * kWarp;
  __host__ __device__ static constexpr int at(int w, int t, int cg, int g) {
    return w * kWarp + t * kRow + cg * kGroup + g * kEntry;
  }
};

// shared memory of a block, in bytes, and its pieces' offsets: the
// staging ring (u, dt, dy as [kT][32], Bc, Cc as [kT][N], in T); the f32
// chunk (dt, x = dt * u, u, dy as [kT][32], B, C as [kT][N]); pass 2's
// per-step sums over each lane's states (``SpLayout``) and the warps'
// dBc/dCc sums [W][kT][2N]
template <typename T, int N>
struct Smem {
  static constexpr int kStage =
      (3 * kT * kChannels + 2 * kT * N) * static_cast<int>(sizeof(T));
  static constexpr int kF32 = kStages * kStage;
  static constexpr int kSp = kF32 + (4 * kT * kChannels + 2 * kT * N) * 4;
  static constexpr int kRed = kSp + SpLayout<N>::kFloats * 4;
  static constexpr int kFwd = kSp;
  static constexpr int kBwd = kRed + Shape<N>::W * kT * 2 * N * 4;
};

struct Tile {      // ``steps`` steps from ``t0`` of row ``b``, 32 channels
  int b, t0, steps, S, di, d0;
  __device__ size_t row(int t) const {
    return (static_cast<size_t>(b) * S + t0 + t) * di + d0;
  }
};

// issue the loads of a chunk into a staging buffer (VEC: cp.async, one
// 16-byte piece a thread at a time, else plain loads and stores), by the
// block's threads; steps past ``c.steps`` are zeros
template <typename T, int N, bool VEC>
__device__ __forceinline__ void stage(unsigned char* st, const Args& a,
                                      const Tile& c, int tid) {
  constexpr int kThreads = Shape<N>::kThreads;
  T* us = reinterpret_cast<T*>(st);
  T* Bs = us + 3 * kT * kChannels;
  // u, dt, dy (m = 0, 1, 2) and Bc, Cc (m = 0, 1)
  auto src = [&](int m) {
    return static_cast<const T*>(m == 0 ? a.u : m == 1 ? a.dt : a.dy);
  };
  auto bsrc = [&](int m) {
    return static_cast<const T*>(m == 0 ? a.Bc : a.Cc);
  };
  const size_t bc0 = (static_cast<size_t>(c.b) * c.S + c.t0) * N;
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);    // elements per piece
    constexpr int RP = kChannels / E;    // pieces per row
    constexpr int kRows = 3 * kT * RP;
    constexpr int kBC = kT * N / E;      // pieces of each of Bc and Cc
    for (int i = tid; i < kRows + 2 * kBC; i += kThreads) {
      if (i < kRows) {
        const int m = i / (kT * RP), r = i % (kT * RP);
        const int t = r / RP, ch = (r % RP) * E;
        const bool ok = t < c.steps && c.d0 + ch < c.di;  // whole: E | di
        cp_async16(us + (m * kT + t) * kChannels + ch,
                   src(m) + (ok ? c.row(t) + ch : 0), ok ? 16 : 0);
      } else {
        // the chunk's kT x N values of Bc (Cc) are one contiguous range
        const int m = (i - kRows) / kBC, e0 = ((i - kRows) % kBC) * E;
        const int n = max(0, min(E, c.steps * N - e0));
        cp_async16(Bs + m * kT * N + e0, bsrc(m) + (n ? bc0 + e0 : 0),
                   n * static_cast<int>(sizeof(T)));
      }
    }
  } else {
    for (int i = tid; i < 3 * kT * kChannels; i += kThreads) {
      const int m = i / (kT * kChannels), r = i % (kT * kChannels);
      const int t = r / kChannels, ch = r % kChannels;
      const bool ok = t < c.steps && c.d0 + ch < c.di;
      us[i] = ok ? src(m)[c.row(t) + ch] : zero<T>();
    }
    for (int i = tid; i < 2 * kT * N; i += kThreads) {
      const int m = i / (kT * N), r = i % (kT * N);
      Bs[i] = r < c.steps * N ? bsrc(m)[bc0 + r] : zero<T>();
    }
  }
}

// a staged chunk to f32, two values a thread at a time: dt, x = dt * u
// (the product the reference rounds), u, dy, B, C
template <typename T, int N>
__device__ __forceinline__ void convert(const unsigned char* st, float* f,
                                        int tid) {
  constexpr int kThreads = Shape<N>::kThreads;
  constexpr int R = kT * kChannels;
  const T* us = reinterpret_cast<const T*>(st);
  const T* dts = us + R;
  const T* dys = dts + R;
  const T* Bs = dys + R;
  for (int o = 2 * tid; o < R; o += 2 * kThreads) {
    const float2 d = load2(dts + o), x = load2(us + o);
    *reinterpret_cast<float2*>(f + o) = d;
    *reinterpret_cast<float2*>(f + R + o) = make_float2(d.x * x.x,
                                                        d.y * x.y);
    *reinterpret_cast<float2*>(f + 2 * R + o) = x;
    *reinterpret_cast<float2*>(f + 3 * R + o) = load2(dys + o);
  }
  // Bc and Cc are adjacent in both layouts
  for (int o = 2 * tid; o < 2 * kT * N; o += 2 * kThreads)
    *reinterpret_cast<float2*>(f + 4 * R + o) = load2(Bs + o);
}

// V values a lane summed over its warp's channel groups (the lanes
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

// the segment of blockIdx.z: its first step, its end and its chunks
struct Segment {
  int t0, end, nc;
  __device__ explicit Segment(const Args& a) {
    t0 = blockIdx.z * a.L;
    end = min(a.S, t0 + a.L);
    nc = (end - t0 + kT - 1) / kT;
  }
  // chunk c of the segment, of batch row b
  __device__ Tile tile(const Args& a, int b, int c) const {
    return Tile{b, t0 + c * kT, min(kT, end - t0 - c * kT), a.S, a.di,
                static_cast<int>(blockIdx.x) * kChannels};
  }
};

// a thread's place in its block: its lane's KC adjacent channels (from c0
// in the block, d0 in the tensor) and states g * K ..
template <int N>
struct Lane {
  using C = Shape<N>;
  int tid, warp, lane, g, c0, d0;
  __device__ Lane() {
    tid = threadIdx.x;
    warp = tid / 32;
    lane = tid % 32;
    g = lane % C::G;
    c0 = warp * C::CW + (lane / C::G) * C::KC;
    d0 = blockIdx.x * kChannels + c0;
  }
};

// pass 1: the segment from zeros -- local checkpoints and the summaries
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(Shape<N>::kThreads)
seg_fwd_kernel(Args a) {
  using C = Shape<N>;
  using M = Smem<T, N>;
  constexpr int K = C::K, KC = C::KC, R = kT * kChannels;
  extern __shared__ __align__(16) unsigned char smem[];
  const Lane<N> ln;
  const int b = blockIdx.y;
  const Segment sg(a);
  const int nC = (a.S + kT - 1) / kT;
  float* f = reinterpret_cast<float*>(smem + M::kF32);
  const float* dtf = f;
  const float* xf = f + R;
  const float* gyf = f + 3 * R;
  const float* Bf = f + 4 * R;
  const float* Cf = Bf + kT * N;

  bool on[KC];
  float a2[KC][K], h[KC][K], q[KC][K], gs[KC][K], cum[KC];
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    on[e] = ln.d0 + e < a.di;
    cum[e] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a2[e][k] = on[e] ? a.A[static_cast<size_t>(ln.d0 + e) * N + ln.g * K +
                             k] * kLog2e : 0.f;
      h[e][k] = gs[e][k] = 0.f;
      q[e][k] = 1.f;
    }
  }
  auto ring = [&](int i) { return smem + (i % kStages) * M::kStage; };
  stage<T, N, VEC>(ring(0), a, sg.tile(a, b, 0), ln.tid);
  cp_async_commit();
  if (sg.nc > 1) stage<T, N, VEC>(ring(1), a, sg.tile(a, b, 1), ln.tid);
  cp_async_commit();
  for (int i = 0; i < sg.nc; ++i) {
    if (i + 2 < sg.nc)
      stage<T, N, VEC>(ring(i + 2), a, sg.tile(a, b, i + 2), ln.tid);
    cp_async_commit();
    cp_async_wait_all_but_two_newest();
    __syncthreads();   // chunk i staged; chunk i - 1's f32 read
    convert<T, N>(ring(i), f, ln.tid);
    __syncthreads();
    if (i > 0) {       // the first chunk's local state is zero
      const size_t c = static_cast<size_t>(b) * nC + sg.t0 / kT + i;
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        if (!on[e]) continue;
        store_v<K>(a.ckpt + (c * a.di + ln.d0 + e) * N + ln.g * K, h[e]);
        if (ln.g == 0) a.cumdt[c * a.di + ln.d0 + e] = cum[e];
      }
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      float dtv[KC], xv[KC], gy[KC], bv[K], cv[K];
      load_v<KC>(dtf + t * kChannels + ln.c0, dtv);
      load_v<KC>(xf + t * kChannels + ln.c0, xv);
      load_v<KC>(gyf + t * kChannels + ln.c0, gy);
      load_v<K>(Bf + t * N + ln.g * K, bv);
      load_v<K>(Cf + t * N + ln.g * K, cv);
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        cum[e] += dtv[e];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float av = decay(dtv[e], a2[e][k]);
          h[e][k] = fmaf(av, h[e][k], xv[e] * bv[k]);
          q[e][k] *= av;
          gs[e][k] = fmaf(q[e][k], gy[e] * cv[k], gs[e][k]);
        }
      }
    }
  }
  const size_t o = (static_cast<size_t>(b) * a.nseg + blockIdx.z) * a.di;
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    if (!on[e]) continue;
    const size_t oe = o + ln.d0 + e;
    store_v<K>(a.hend + oe * N + ln.g * K, h[e]);
    store_v<K>(a.gsum + oe * N + ln.g * K, gs[e]);
    if (ln.g == 0) a.dtsum[oe] = cum[e];
  }
}

// pass 2: the summaries folded into the segment's true start state and
// carry, then its chunks in reverse
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(Shape<N>::kThreads,
                                  512 / Shape<N>::kThreads)
seg_bwd_kernel(Args a) {
  using C = Shape<N>;
  using M = Smem<T, N>;
  using SP = SpLayout<N>;
  constexpr int K = C::K, G = C::G, KC = C::KC, CW = C::CW, W = C::W;
  constexpr int V = C::V, kDup = C::CG / V;   // lanes holding each sum
  constexpr int R = kT * kChannels, kThreads = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const Lane<N> ln;
  const int b = blockIdx.y, blk = blockIdx.x, blk0 = blk * kChannels;
  const Segment sg(a);
  const int nC = (a.S + kT - 1) / kT;
  float* f = reinterpret_cast<float*>(smem + M::kF32);
  const float* dtf = f;
  const float* xf = f + R;
  const float* uf = f + 2 * R;
  const float* gyf = f + 3 * R;
  const float* Bf = f + 4 * R;
  const float* Cf = Bf + kT * N;
  float* sp = reinterpret_cast<float*>(smem + M::kSp);
  float* red = reinterpret_cast<float*>(smem + M::kRed);  // [W][kT][2N]
  T* du = static_cast<T*>(a.du);
  T* ddt = static_cast<T*>(a.ddt);

  bool on[KC];
  float A2[KC][K], Af[KC][K], hs[KC][K], ag[KC][K], dA[KC][K];
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    on[e] = ln.d0 + e < a.di;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Af[e][k] = on[e] ? a.A[static_cast<size_t>(ln.d0 + e) * N + ln.g * K +
                             k] : 0.f;
      A2[e][k] = Af[e][k] * kLog2e;
      hs[e][k] = ag[e][k] = dA[e][k] = 0.f;
    }
  }
  // the true start state and carry from the other segments' summaries
  const size_t row = static_cast<size_t>(b) * a.nseg;
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    if (!on[e]) continue;
    for (int j = 0; j < static_cast<int>(blockIdx.z); ++j) {
      const size_t o = (row + j) * a.di + ln.d0 + e;
      const float sd = a.dtsum[o];
      float he[K];
      load_v<K>(a.hend + o * N + ln.g * K, he);
#pragma unroll
      for (int k = 0; k < K; ++k)
        hs[e][k] = fmaf(decay(sd, A2[e][k]), hs[e][k], he[k]);
    }
    for (int j = a.nseg - 1; j > static_cast<int>(blockIdx.z); --j) {
      const size_t o = (row + j) * a.di + ln.d0 + e;
      const float sd = a.dtsum[o];
      float ge[K];
      load_v<K>(a.gsum + o * N + ln.g * K, ge);
#pragma unroll
      for (int k = 0; k < K; ++k)
        ag[e][k] = fmaf(decay(sd, A2[e][k]), ag[e][k], ge[k]);
    }
  }

  // the chunk pass's channel: the thread's column of the block's tile
  const int pc = ln.tid % kChannels;
  const int pw = pc / CW, pg = (pc % CW) / KC, pe = pc % KC;
  const float Dd = blk0 + pc < a.di ? a.D[blk0 + pc] : 0.f;
  float dDs = 0.f;
  const int last = sg.nc - 1;
  auto tile = [&](int i) {     // the i-th chunk walked: the last first
    return sg.tile(a, b, last - i);
  };
  auto ring = [&](int i) { return smem + (i % kStages) * M::kStage; };
  // the local checkpoint of the i-th chunk walked, loaded one chunk ahead
  float ck[KC][K], cd[KC];
  auto load_ckpt = [&](int i) {
    const int c = last - i;
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      cd[e] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) ck[e][k] = 0.f;
      if (c > 0 && on[e]) {
        const size_t o = (static_cast<size_t>(b) * nC + sg.t0 / kT + c) *
                         a.di + ln.d0 + e;
        load_v<K>(a.ckpt + o * N + ln.g * K, ck[e]);
        cd[e] = a.cumdt[o];
      }
    }
  };
  load_ckpt(0);
  stage<T, N, VEC>(ring(0), a, tile(0), ln.tid);
  cp_async_commit();
  if (sg.nc > 1) stage<T, N, VEC>(ring(1), a, tile(1), ln.tid);
  cp_async_commit();
  for (int i = 0; i < sg.nc; ++i) {
    const Tile tl = tile(i);
    if (i + 2 < sg.nc) stage<T, N, VEC>(ring(i + 2), a, tile(i + 2), ln.tid);
    cp_async_commit();
    cp_async_wait_all_but_two_newest();
    __syncthreads();   // chunk i staged; chunk i - 1's f32, sp and red read
    convert<T, N>(ring(i), f, ln.tid);
    __syncthreads();

    // the chunk's states h_{-1} .. h_{kT-1} and decays, recomputed
    float H[kT + 1][KC][K], Dc[kT][KC][K];
#pragma unroll
    for (int e = 0; e < KC; ++e)
#pragma unroll
      for (int k = 0; k < K; ++k)
        H[0][e][k] = fmaf(decay(cd[e], A2[e][k]), hs[e][k], ck[e][k]);
    if (i + 1 < sg.nc) load_ckpt(i + 1);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      float dtv[KC], xv[KC], bv[K];
      load_v<KC>(dtf + t * kChannels + ln.c0, dtv);
      load_v<KC>(xf + t * kChannels + ln.c0, xv);
      load_v<K>(Bf + t * N + ln.g * K, bv);
#pragma unroll
      for (int e = 0; e < KC; ++e)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          Dc[t][e][k] = decay(dtv[e], A2[e][k]);
          H[t + 1][e][k] = fmaf(Dc[t][e][k], H[t][e][k], xv[e] * bv[k]);
        }
    }
    // the walk back: g_t = dy_t C_t + (a_{t+1} g_{t+1}), the carry ag
#pragma unroll
    for (int t = kT - 1; t >= 0; --t) {
      float dtv[KC], xv[KC], gy[KC], bv[K], cv[K];
      load_v<KC>(dtf + t * kChannels + ln.c0, dtv);
      load_v<KC>(xf + t * kChannels + ln.c0, xv);
      load_v<KC>(gyf + t * kChannels + ln.c0, gy);
      load_v<K>(Bf + t * N + ln.g * K, bv);
      load_v<K>(Cf + t * N + ln.g * K, cv);
      float vals[V], s[2 * KC];
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float gn = fmaf(gy[e], cv[k], ag[e][k]);
          // dBc and dCc, summed over the lane's channels
          vals[k] = e ? fmaf(gn, xv[e], vals[k]) : gn * xv[e];
          vals[K + k] = e ? fmaf(gy[e], H[t + 1][e][k], vals[K + k])
                          : gy[e] * H[t + 1][e][k];
          s1 = fmaf(gn, bv[k], s1);
          ag[e][k] = Dc[t][e][k] * gn;
          const float gha = ag[e][k] * H[t][e][k];   // g_t (a_t h_{t-1})
          s2 = fmaf(gha, Af[e][k], s2);
          dA[e][k] = fmaf(gha, dtv[e], dA[e][k]);
        }
        s[2 * e] = s1;
        s[2 * e + 1] = s2;
      }
      float* spt = sp + SP::at(ln.warp, t, ln.lane / G, ln.g);
      if constexpr (KC == 2)
        *reinterpret_cast<float4*>(spt) = make_float4(s[0], s[1], s[2], s[3]);
      else
        *reinterpret_cast<float2*>(spt) = make_float2(s[0], s[1]);
      const float sum = reduce_channels<V, G>(vals, ln.lane);
      const int cg = ln.lane / G;
      if (cg % kDup == 0) {
        const int v = cg / kDup;
        const int j = v < K ? ln.g * K + v : N + ln.g * K + v - K;
        red[(ln.warp * kT + t) * 2 * N + j] = sum;
      }
    }
    __syncthreads();   // every warp's sums of the chunk in sp and red
    // du and ddt: each channel's sums over its G lanes
    for (int p = ln.tid; p < R; p += kThreads) {
      const int t = p / kChannels;
      const float* s = sp + SP::at(pw, t, pg, 0) + 2 * pe;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(s + j * SP::kEntry);
        s1 += v.x;
        s2 += v.y;
      }
      const float gy = gyf[p], uv = uf[p];
      dDs = fmaf(gy, uv, dDs);
      if (t < tl.steps && blk0 + pc < a.di) {
        const size_t o = tl.row(t) + pc;
        store(du + o, fmaf(gy, Dd, s1 * dtf[p]));
        store(ddt + o, fmaf(s1, uv, s2));
      }
    }
    // the block's partials of dBc and dCc: the warps' sums added
    float* part = a.part + ((static_cast<size_t>(blk) * a.B + b) * a.S +
                            tl.t0) * 2 * N;
    for (int e = ln.tid; e < tl.steps * 2 * N; e += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) sum += red[w * kT * 2 * N + e];
      part[e] = sum;
    }
  }
  const size_t o = (static_cast<size_t>(b) * a.nseg + blockIdx.z) * a.di;
#pragma unroll
  for (int e = 0; e < KC; ++e)
    if (on[e]) store_v<K>(a.dA_part + (o + ln.d0 + e) * N + ln.g * K, dA[e]);
  // dD: the threads of one column summed in shared memory
  __syncthreads();
  sp[ln.tid] = dDs;
  __syncthreads();
  if (ln.tid < kChannels && blk0 + ln.tid < a.di) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) sum += sp[w * kChannels + ln.tid];
    a.dD_part[o + blk0 + ln.tid] = sum;
  }
}

// dBc and dCc: the partials summed over the blocks; dA and dD over the
// (batch row, segment) partials
template <typename T, int N>
__global__ void __launch_bounds__(kFinishThreads) finish_kernel(Args a,
                                                                int nblk) {
  constexpr int V = 2 * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kFinishThreads +
                   threadIdx.x;
  const size_t n1 = static_cast<size_t>(a.B) * a.S * V;
  const size_t n2 = static_cast<size_t>(a.di) * N;
  const int rows = a.B * a.nseg;
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
    for (int r = 0; r < rows; ++r) sum += a.dA_part[r * n2 + k];
    a.dA[k] = sum;
  } else if (i < n1 + n2 + a.di) {
    const size_t k = i - n1 - n2;
    float sum = 0.f;
    for (int r = 0; r < rows; ++r)
      sum += a.dD_part[static_cast<size_t>(r) * a.di + k];
    a.dD[k] = sum;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int N, bool VEC>
int launch_passes(const Args& a, cudaStream_t s) {
  using C = Shape<N>;
  using M = Smem<T, N>;
  const int nblk = (a.di + kChannels - 1) / kChannels;
  const dim3 grid(nblk, a.B, a.nseg);
  seg_fwd_kernel<T, N, VEC><<<grid, C::kThreads, M::kFwd, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_bwd_kernel<T, N, VEC><<<grid, C::kThreads, M::kBwd, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(a.B) * a.S * 2 * N +
                       static_cast<size_t>(a.di) * (N + 1);
  const unsigned fgrid =
      static_cast<unsigned>((total + kFinishThreads - 1) / kFinishThreads);
  finish_kernel<T, N><<<fgrid, kFinishThreads, 0, s>>>(a, nblk);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte staging where the shapes and pointers allow it
template <typename T, int N>
int launch(const Args& a, cudaStream_t s) {
  static_assert(Smem<T, N>::kBwd <= 48 * 1024 &&
                    Smem<T, N>::kFwd <= 48 * 1024,
                "no opt-in shared memory");
  const bool vec = (static_cast<long long>(a.di) * sizeof(T)) % 16 == 0 &&
                   (static_cast<long long>(a.S) * N * sizeof(T)) % 16 == 0 &&
                   aligned16(a.u) && aligned16(a.dt) && aligned16(a.dy) &&
                   aligned16(a.Bc) && aligned16(a.Cc);
  return vec ? launch_passes<T, N, true>(a, s)
             : launch_passes<T, N, false>(a, s);
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
    void* dA, void* dBc, void* dCc, void* dD, void* ckpt, void* cumdt,
    void* hend, void* gsum, void* dtsum, void* part, void* dA_part,
    void* dD_part, int B, int S, int di, int N, int chunk, int seg_len,
    int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  if (chunk != kT || seg_len <= 0 || seg_len % kT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (S + seg_len - 1) / seg_len;
  const Args a{u, dt, static_cast<const float*>(A), Bc, Cc,
               static_cast<const float*>(D), dy, du, ddt,
               static_cast<float*>(dA), dBc, dCc, static_cast<float*>(dD),
               static_cast<float*>(ckpt), static_cast<float*>(cumdt),
               static_cast<float*>(hend), static_cast<float*>(gsum),
               static_cast<float*>(dtsum), static_cast<float*>(part),
               static_cast<float*>(dA_part), static_cast<float*>(dD_part), B,
               S, di, seg_len, nseg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_n<__nv_bfloat16>(a, N, s)
                 : launch_n<float>(a, N, s);
}

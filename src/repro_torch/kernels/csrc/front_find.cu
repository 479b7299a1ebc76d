// Fused find of the device partition pass for NVIDIA Hopper (sm_90a),
// loaded through ctypes: one launch per committed move, the apply folded in.
//
// What it replaces (the JAX package's Pallas TPU kernels in the roles the
// device pass gives them, with the XLA program around them):
//   * src/repro/kernels/gain.py::_pallas_dlam_call (``front_dlam``), the
//     lambda delta of every candidate row in the find program
//     (src/repro/kernels/front_pass.py::_make_find), together with that
//     program's row gather, segment sum and winner selection;
//   * src/repro/kernels/gain.py::_pallas_call (``min_cover_lambdas``) in its
//     apply role: the lambdas of a committed move's edges, which the JAX find
//     program folds in ahead of its scan.
//
// What one launch computes, on the pass's device buffers: ``uncov`` (E + 1,
// M) int32 with M = 2^P columns in popcount order (column c is the subset
// ``colsub[c]``, column 0 the empty one), ``lam`` (E + 1,), ``masks`` (n + 1,)
// and the read-only ``mu``, ``pc`` (popcounts, 127 at column 0), ``fits``
// (n + 1, P) bytes, the incidence CSR ``xinc``/``inc_edges``, the visit order
// ``perm`` and the block bounds ``bounds`` (block b holds the positions
// [bounds[b], bounds[b + 1])).  ``work`` holds the queued mutations (Q
// triples v, old, new), the NA active blocks in ascending order and the NA + 1
// prefix counts of their positions.
//   1. Apply.  For each queued mutation with old != new, add contrib[new] -
//      contrib[old] to the uncov rows of v's incident edges, where
//      contrib[m][c] = (m != 0) & ((m & colsub[c]) == 0) is the row a pin of
//      mask m adds; recompute those edges' lambdas as the masked min
//      lam = min over c of (uncov[e][c] == 0 ? pc[c] : 127); set masks[v] to
//      the mutation's new mask.  The adds commute, so the queue comes out as if
//      applied one mutation at a time.
//   2. Scan.  For each position p >= start_pos of the active blocks, node
//      v = perm[p] with mask m, each incident edge e and each processor q:
//      base = uncov[e] - contrib[m], the candidate c_q = 1 << q (FM) or
//      m ^ (1 << q) (replication: an add where q is unset, a drop where it is
//      set), lam_q = masked min of base + contrib[c_q], and
//      d[q] += mu[e] * (relu(lam_q - 1) - relu(lam[e] - 1)).
//   3. Select, as src/repro_torch/kernels/front_find.py::front_find_ref: FM
//      takes the first q minimising d over fits[v][q] & q != primary(m) and
//      has an event when that d <= -1; replication takes the add of the same
//      rule over fits & unset & popcount(m) < maxrep (suppressed at start_pos
//      when resume_p >= 0) and else the first droppable q (set, popcount > 1,
//      d <= 0, q >= resume_p where the add was suppressed).
//   4. Return the event at the smallest position as (pos, kind, q) in
//      ``out``; pos = n when there is none.  Blocks come in visit order, so
//      this is the first event of a block-by-block scan.
//
// Bound on the card: memory.  The scan must read the uncov row of every
// (node, edge) pair it prices up to the first event, M * 4 bytes each, plus
// the block's index arrays; the work per loaded element is 4-5 integer
// operations per candidate, well under the 32-bit rate for P <= 12.  At the
// path's sizes the bytes are a few hundred kilobytes, so the launch latency
// and the grid barriers set the time.
//
// Design:
//   * One cooperative persistent launch (cudaLaunchCooperativeKernel, two
//     256-thread CTAs per SM at most) with grid-wide barriers: apply, barrier,
//     scan, barrier, then CTA 0 writes the triple.  A queue of more than one
//     mutation adds its uncov differences with atomics (edges may repeat
//     across mutations), then recomputes the lambdas after one more barrier;
//     a single mutation's edges are distinct, so one warp per edge adds and
//     prices its row with no atomics.
//   * Node tickets.  A warp takes the next position of the active blocks from
//     a global atomic ticket, so positions are handed out in ascending visit
//     order across the whole grid.  An event posts the packed 64-bit key
//     (pos << 32 | kind << 16 | q) with atomicMin; a warp stops as soon as its
//     ticket's position is not below the best key, because every later ticket
//     is further on.  Every position below the final key was priced, so the
//     result is exactly the first event.  A warp inside a node also checks
//     the key every 8 edges and drops the node once an earlier position has
//     posted (it can no longer win): otherwise a dense node (hundreds of
//     edges, walked by one warp) that a find's first wave of tickets reached
//     would hold the launch long after the event was found.
//   * No materialised candidate rows.  The warp reads each incident edge's
//     uncov row once (16-byte loads for M >= 128, the next chunk prefetched
//     into registers while the current one is priced), forms base once and
//     takes the masked min for all P candidates from it; contrib is computed
//     from the column's subset (``colsub`` and ``pc`` packed into one
//     shared-memory word per column), so no contrib table is read.  The
//     lanes' partial minima per candidate are combined by shuffles at the end
//     of each edge, and the integer sums d[q] live in registers.  Rows wider
//     than 256 columns (P > 8) are walked in chunks of 8 columns per lane,
//     carrying a partial min per candidate.
//   * Every launch resets the ticket and the key itself before the first
//     barrier; launches go on the caller's stream and never synchronise; the
//     launcher returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kNoCover = 127;
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kAbortEdges = 8;   // edges between a node's checks of the key
constexpr int kBig = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoEvent = ~0ull;

struct FindArgs {
  int* uncov;
  int* lam;
  int* masks;
  const int* mu;
  const int* colsub;
  const int* pc;
  const unsigned char* fits;
  const int* xinc;
  const int* inc_edges;
  const int* perm;
  const int* bounds;
  const int* work;               // [Q x (v, old, new) | NA blocks | NA + 1]
  unsigned long long* scratch;   // [best key, ticket]
  int* out;                      // (pos, kind, q)
  int n, Q, NA, start_pos, resume_p, maxrep;
};

// Columns of a row per lane and per chunk for P processors.
template <int P>
struct Cols {
  static constexpr int M = 1 << P;
  static constexpr int CPL = M >= kWarp ? M / kWarp : 1;
  static constexpr int CH = CPL < 8 ? CPL : 8;
  static constexpr int NCH = CPL / CH;
  static constexpr bool VEC = CH >= 4;   // 16-byte loads
};

__device__ __forceinline__ int contrib(int m, int sub) {
  return static_cast<int>(m != 0) & static_cast<int>((m & sub) == 0);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ int desc_pc(int d) { return d >> 16; }
__device__ __forceinline__ int desc_sub(int d) { return d & 0xffff; }

// ------------------------------------------------------------------- apply
// Add contrib[nw] - contrib[old] to edge e's row.  ``single``: the edge is
// touched by this warp alone, so the row is updated in place and its lambda
// recomputed at once; otherwise the differences go in with atomics and the
// lambda follows after a grid barrier (relam).
template <int M>
__device__ void add_diff(const FindArgs& a, const int* s_desc, int e, int old,
                         int nw, bool single, int lane) {
  int* row = a.uncov + static_cast<size_t>(e) * M;
  int m = kNoCover;
  for (int c = lane; c < M; c += kWarp) {
    const int d = s_desc[c];
    const int diff = contrib(nw, desc_sub(d)) - contrib(old, desc_sub(d));
    if (single) {
      const int u = row[c] + diff;
      row[c] = u;
      m = min(m, u == 0 ? desc_pc(d) : kNoCover);
    } else if (diff != 0) {
      atomicAdd(row + c, diff);
    }
  }
  if (single) {
    m = warp_min(m);
    if (lane == 0) a.lam[e] = m;
  }
}

template <int M>
__device__ void relam(const FindArgs& a, const int* s_desc, int e, int lane) {
  const int* row = a.uncov + static_cast<size_t>(e) * M;
  int m = kNoCover;
  for (int c = lane; c < M; c += kWarp) {
    m = min(m, row[c] == 0 ? desc_pc(s_desc[c]) : kNoCover);
  }
  m = warp_min(m);
  if (lane == 0) a.lam[e] = m;
}

// Every (mutation, incident edge) pair of the queue, spread over the grid's
// warps; mutations with old == new touch no row.
template <int M, bool ADD>
__device__ void for_queue_edges(const FindArgs& a, const int* s_desc, int gw,
                                int tw, int lane) {
  for (int i = 0; i < a.Q; ++i) {
    const int v = a.work[3 * i], old = a.work[3 * i + 1];
    const int nw = a.work[3 * i + 2];
    if (old == nw) continue;
    const int lo = a.xinc[v], deg = a.xinc[v + 1] - lo;
    for (int j = gw; j < deg; j += tw) {
      const int e = a.inc_edges[lo + j];
      if (ADD) {
        add_diff<M>(a, s_desc, e, old, nw, a.Q == 1, lane);
      } else {
        relam<M>(a, s_desc, e, lane);
      }
    }
  }
}

// -------------------------------------------------------------------- scan
template <int P>
__device__ __forceinline__ void load_chunk(const int* row, int j, int lane,
                                           int (&u)[Cols<P>::CH]) {
  using C = Cols<P>;
  if constexpr (C::VEC) {
#pragma unroll
    for (int k = 0; k < C::CH / 4; ++k) {
      const int4 x = *reinterpret_cast<const int4*>(
          row + j * (kWarp * C::CH) + k * 128 + lane * 4);
      u[4 * k] = x.x;
      u[4 * k + 1] = x.y;
      u[4 * k + 2] = x.z;
      u[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < C::CH; ++t) {
      const int col = t * kWarp + lane;
      u[t] = col < C::M ? row[col] : 1;
    }
  }
}

// The packed (subset, popcount) words of the same columns; a lane past the
// last column (M < 32) gets popcount 127, which never wins a min.
template <int P>
__device__ __forceinline__ void load_desc(const int* s_desc, int j, int lane,
                                          int (&d)[Cols<P>::CH]) {
  using C = Cols<P>;
  if constexpr (C::VEC) {
#pragma unroll
    for (int k = 0; k < C::CH / 4; ++k) {
      const int4 x = *reinterpret_cast<const int4*>(
          s_desc + j * (kWarp * C::CH) + k * 128 + lane * 4);
      d[4 * k] = x.x;
      d[4 * k + 1] = x.y;
      d[4 * k + 2] = x.z;
      d[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < C::CH; ++t) {
      const int col = t * kWarp + lane;
      d[t] = col < C::M ? s_desc[col] : (kNoCover << 16);
    }
  }
}

template <int P, bool REP>
__device__ __forceinline__ void price_chunk(const int (&u)[Cols<P>::CH],
                                            const int (&d)[Cols<P>::CH],
                                            int m_old, int (&part)[P]) {
#pragma unroll
  for (int t = 0; t < Cols<P>::CH; ++t) {
    const int sub = desc_sub(d[t]);
    const int pcv = desc_pc(d[t]);
    const int base = u[t] - contrib(m_old, sub);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int cq = REP ? (m_old ^ (1 << q)) : (1 << q);
      const int z = base + contrib(cq, sub);
      part[q] = min(part[q], z == 0 ? pcv : kNoCover);
    }
  }
}

// Price node perm[pos] for all P candidates and post its event, if any.
template <int P, bool REP>
__device__ void eval_node(const FindArgs& a, const int* s_desc, int pos,
                          int lane) {
  using C = Cols<P>;
  const int v = a.perm[pos];
  const int m_old = a.masks[v];
  const int lo = a.xinc[v];
  const int steps = (a.xinc[v + 1] - lo) * C::NCH;
  int acc[P], part[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    acc[q] = 0;
    part[q] = kNoCover;
  }
  int d[C::CH], u[C::CH], nx[C::CH] = {};
  if constexpr (C::NCH == 1) load_desc<P>(s_desc, 0, lane, d);
  int e = steps > 0 ? a.inc_edges[lo] : 0;
  int e_next = e;
  if (steps > 0) {
    load_chunk<P>(a.uncov + static_cast<size_t>(e) * C::M, 0, lane, u);
  }
  int mu = 0, lam_old = 0;
  for (int s = 0; s < steps; ++s) {
    const int j = s % C::NCH;
    if (j == 0) {
      // every kAbortEdges edges: give up once an earlier position has an
      // event (this node can no longer win; a dense node would otherwise
      // hold the whole launch)
      if (s > 0 && (s / C::NCH) % kAbortEdges == 0) {
        int stop = 0;
        if (lane == 0) {
          const unsigned long long best =
              *reinterpret_cast<volatile unsigned long long*>(a.scratch);
          stop = (best >> 32) < static_cast<unsigned long long>(pos);
        }
        if (__shfl_sync(kFull, stop, 0)) return;
      }
      mu = a.mu[e];
      lam_old = max(a.lam[e] - 1, 0);
    }
    if (s + 1 < steps) {   // prefetch the next chunk, of this edge or the next
      const int j1 = (s + 1) % C::NCH;
      if (j1 == 0) e_next = a.inc_edges[lo + (s + 1) / C::NCH];
      load_chunk<P>(a.uncov + static_cast<size_t>(e_next) * C::M, j1, lane,
                    nx);
    }
    if constexpr (C::NCH > 1) load_desc<P>(s_desc, j, lane, d);
    price_chunk<P, REP>(u, d, m_old, part);
    if (j == C::NCH - 1) {   // the edge's row is done
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int lam = warp_min(part[q]);
        acc[q] += mu * (max(lam - 1, 0) - lam_old);
        part[q] = kNoCover;
      }
      e = e_next;
    }
#pragma unroll
    for (int t = 0; t < C::CH; ++t) u[t] = nx[t];
  }
  if (lane != 0) return;
  const unsigned char* f = a.fits + static_cast<size_t>(v) * P;
  int kind = -1, qsel = 0;
  int bestq = 0, bestd = kBig;
  if (!REP) {
    const int prim = m_old ? 31 - __clz(m_old) : 0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int dq = (f[q] && q != prim) ? acc[q] : kBig;
      if (dq < bestd) {
        bestd = dq;
        bestq = q;
      }
    }
    if (bestd <= -1) {
      kind = 0;
      qsel = bestq;
    }
  } else {
    const int kk = __popc(m_old);
    const bool add_sup = a.resume_p >= 0 && pos == a.start_pos;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const bool unset = ((m_old >> q) & 1) == 0;
      const int dq = (f[q] && unset && kk < a.maxrep) ? acc[q] : kBig;
      if (dq < bestd) {
        bestd = dq;
        bestq = q;
      }
    }
    if (bestd <= -1 && !add_sup) {
      kind = 0;
      qsel = bestq;
    } else if (kk > 1) {
      const int minp = add_sup ? a.resume_p : 0;
#pragma unroll
      for (int q = P - 1; q >= 0; --q) {   // the lowest droppable q wins
        if (((m_old >> q) & 1) && acc[q] <= 0 && q >= minp) {
          kind = 1;
          qsel = q;
        }
      }
    }
  }
  if (kind >= 0) {
    const unsigned long long key =
        (static_cast<unsigned long long>(pos) << 32) |
        (static_cast<unsigned long long>(kind) << 16) |
        static_cast<unsigned long long>(qsel);
    atomicMin(a.scratch, key);
  }
}

template <int P, bool REP>
__global__ void __launch_bounds__(kThreads)
front_find_kernel(FindArgs a) {
  constexpr int M = 1 << P;
  __shared__ __align__(16) int s_desc[M];
  cg::grid_group grid = cg::this_grid();
  for (int c = threadIdx.x; c < M; c += blockDim.x) {
    s_desc[c] = a.colsub[c] | (a.pc[c] << 16);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scratch[0] = kNoEvent;
    a.scratch[1] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int tw = gridDim.x * blockDim.x / kWarp;

  // 1. apply the queue; each node's mask takes its last mutation's value
  for_queue_edges<M, true>(a, s_desc, gw, tw, lane);
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  if (gt < a.Q) {
    const int v = a.work[3 * gt];
    bool last = true;
    for (int i = gt + 1; i < a.Q; ++i) last &= a.work[3 * i] != v;
    if (last) a.masks[v] = a.work[3 * gt + 2];
  }
  grid.sync();
  if (a.Q > 1) {
    for_queue_edges<M, false>(a, s_desc, gw, tw, lane);
    grid.sync();
  }

  // 2-3. scan: node tickets in visit order until the best key is passed
  const int* blocks = a.work + 3 * a.Q;
  const int* cum = blocks + a.NA;
  const int total = a.NA > 0 ? cum[a.NA] : 0;
  for (;;) {
    int pos = -1;
    if (lane == 0) {
      const int t = static_cast<int>(atomicAdd(a.scratch + 1, 1ull));
      if (t < total) {
        int lo = 0, hi = a.NA - 1;   // the last active block with cum <= t
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (cum[mid] <= t) lo = mid; else hi = mid - 1;
        }
        pos = a.bounds[blocks[lo]] + (t - cum[lo]);
        const unsigned long long best =
            *reinterpret_cast<volatile unsigned long long*>(a.scratch);
        if ((best >> 32) <= static_cast<unsigned long long>(pos)) pos = -1;
      }
    }
    pos = __shfl_sync(kFull, pos, 0);
    if (pos < 0) break;
    if (pos < a.start_pos) continue;
    eval_node<P, REP>(a, s_desc, pos, lane);
  }
  grid.sync();

  // 4. the triple
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long key =
        *reinterpret_cast<volatile unsigned long long*>(a.scratch);
    const bool none = key == kNoEvent;
    a.out[0] = none ? a.n : static_cast<int>(key >> 32);
    a.out[1] = none ? 0 : static_cast<int>((key >> 16) & 0xffff);
    a.out[2] = none ? 0 : static_cast<int>(key & 0xffff);
  }
}

__global__ void empty_kernel() {}

// CTAs of a cooperative launch of ``kernel``: all co-resident, at most
// kBlocksPerSm per SM; 0 when it cannot run one per SM.
int coop_grid(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess) {
    return 0;
  }
  return sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
}

template <int P, bool REP>
int find_grid() {
  static int grid = 0;   // per instance, fixed for the process's device
  if (grid == 0)
    grid = coop_grid(reinterpret_cast<const void*>(&front_find_kernel<P, REP>));
  return grid;
}

template <int P, bool REP>
int launch(FindArgs a, cudaStream_t stream) {
  const int grid = find_grid<P, REP>();
  if (grid == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&front_find_kernel<P, REP>), dim3(grid),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ``f(std::integral_constant<int, P>{})`` for P in 1..12, else ``bad``
template <typename F>
int dispatch(int P, F&& f, int bad) {
  switch (P) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    default: return bad;
  }
}

}  // namespace

extern "C" int repro_front_find(void* uncov, void* lam, void* masks,
                                const void* mu, const void* colsub,
                                const void* pc, const void* fits,
                                const void* xinc, const void* inc_edges,
                                const void* perm, const void* bounds,
                                const void* work, void* scratch, void* out,
                                int n, int P, int rep, int Q, int NA,
                                int start_pos, int resume_p, int maxrep,
                                void* stream) {
  FindArgs a;
  a.uncov = static_cast<int*>(uncov);
  a.lam = static_cast<int*>(lam);
  a.masks = static_cast<int*>(masks);
  a.mu = static_cast<const int*>(mu);
  a.colsub = static_cast<const int*>(colsub);
  a.pc = static_cast<const int*>(pc);
  a.fits = static_cast<const unsigned char*>(fits);
  a.xinc = static_cast<const int*>(xinc);
  a.inc_edges = static_cast<const int*>(inc_edges);
  a.perm = static_cast<const int*>(perm);
  a.bounds = static_cast<const int*>(bounds);
  a.work = static_cast<const int*>(work);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.out = static_cast<int*>(out);
  a.n = n;
  a.Q = Q;
  a.NA = NA;
  a.start_pos = start_pos;
  a.resume_p = resume_p;
  a.maxrep = maxrep;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (rep) {
    return dispatch(
        P, [&](auto p) { return launch<decltype(p)::value, true>(a, s); },
        bad);
  }
  return dispatch(
      P, [&](auto p) { return launch<decltype(p)::value, false>(a, s); }, bad);
}

// The cooperative grid of the find for (P, rep), in CTAs of 256 threads;
// 0 if it cannot run.
extern "C" int repro_front_find_grid(int P, int rep) {
  if (rep)
    return dispatch(
        P, [](auto p) { return find_grid<decltype(p)::value, true>(); }, 0);
  return dispatch(
      P, [](auto p) { return find_grid<decltype(p)::value, false>(); }, 0);
}

// An empty kernel on ``grid`` CTAs of ``block`` threads, launched
// cooperatively if asked: the launch-latency floor beside a kernel's time
// (the find's, the scan's decode step's).
extern "C" int repro_empty_launch(int grid, int block, int cooperative,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cooperative) {
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&empty_kernel), dim3(grid), dim3(block),
        nullptr, 0, s));
  }
  empty_kernel<<<grid, block, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}

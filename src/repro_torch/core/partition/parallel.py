"""Process-parallel shared-memory execution layer.

One box, many cores: the multilevel V-cycle's three heavy phases --
matching, contraction bookkeeping, refinement -- are data-parallel over
node ranges, but Python processes cannot share a `Hypergraph` without
either pickling the pin arrays into every worker (copies the instance W
times) or going through a file.  This module provides the third option:

* ``ShmRegistry`` -- owns ``multiprocessing.shared_memory`` segments.
  ``share(a)`` copies an array into a fresh segment once and returns the
  segment-backed view plus a picklable ``ArrayRef``; ``alloc`` creates
  zeroed segment-backed arrays for code that wants to *stream* data
  straight into shared memory (``datagen.spmv.large_row_net``).  All
  segments are unlinked on ``close()`` -- also after worker crashes, the
  registry never relies on worker-side cleanup.

* ``ParallelContext`` -- worker-pool lifecycle (``fork`` preferred,
  ``spawn`` fallback -- both tested), per-``Hypergraph`` export cache (the
  six CSR arrays + omega + mu are shared once per level), and
  ``adopt_state``: re-back a live ``PartitionState``'s ``uncov`` /
  ``edge_lambda`` / ``masks`` with shared segments so the engine's
  in-place updates are immediately visible to the next worker dispatch
  with zero copies.

* ``parallel_match_pref`` -- shards the heavy-pin scoring pass over node
  ranges.  Per-(v, u) score sums accumulate in the same ascending-edge
  order inside a shard as in the full pass, so the concatenated ``pref``
  -- and therefore the matching ``cmap`` -- is *bit-identical* to serial
  for every worker count (pinned by ``tests/test_torch_parallel.py``).

* ``parallel_refine`` -- splits an FM / replication pass into contiguous
  node shards (degree-balanced, ``plan_shards``).  Each worker extracts
  its shard's incident-edge sub-hypergraph (every edge touching the
  shard, with full pin sets, so move deltas are globally exact against
  the snapshot), runs the ordinary frontier-priced pass restricted to its
  nodes, and sends back only the changed masks.  The parent then replays
  proposals through ``PartitionState.apply`` and keeps a move only if it
  still improves (or is cost-neutral and drops a replica) and respects
  capacity -- stale proposals are undone.  A serial boundary pass over
  nodes of cross-shard edges mops up what sharding hid.  Final cost is
  therefore never worse than the projected cost; divergence from the
  serial trajectory is allowed.

Workers never touch the torch backend (``frontier="numpy"`` end to end)
and create no tensor, so the pool is safe under ``fork`` even when the
parent has CUDA state: a forked child must not use CUDA, and never does.
Worker-side attaches suppress resource-tracker registration (bpo-38119:
Python <= 3.12 registers attach-only segments too, and the process tree
shares one tracker, so a worker's registration would let the tracker
unlink the creator's segment when the pool retires).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import secrets
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..hypergraph import Hypergraph
from .engine import PartitionState

PARALLEL_MIN_NODES = 4096   # below this, sharding overhead beats the work
_SEG_PREFIX = "repro_torch"

_CSR_KEYS = ("xpins", "pins", "xinc", "inc_edges", "xadj", "adj_nodes")


def shm_available() -> bool:
    """True when POSIX shared memory actually works here (CI guard)."""
    try:
        from multiprocessing import shared_memory
        seg = shared_memory.SharedMemory(create=True, size=8)
        seg.close()
        seg.unlink()
        return True
    except Exception:
        return False


@dataclasses.dataclass(frozen=True)
class ArrayRef:
    """Picklable handle to a shared-memory array (``name is None`` encodes
    a zero-byte array, which POSIX shm cannot represent)."""

    name: str | None
    shape: tuple
    dtype: str


class ShmRegistry:
    """Owner of shared-memory segments; unlinks everything on ``close``."""

    def __init__(self):
        self._segs = {}          # name -> SharedMemory (created here)
        self._by_id = {}         # id(array) -> (array, ArrayRef)
        self.created = []        # every name ever created (tests/cleanup)

    def _new_segment(self, nbytes: int):
        from multiprocessing import shared_memory
        name = f"{_SEG_PREFIX}_{secrets.token_hex(6)}"
        seg = shared_memory.SharedMemory(create=True, size=nbytes, name=name)
        self._segs[seg.name] = seg
        self.created.append(seg.name)
        return seg

    def alloc(self, shape, dtype) -> np.ndarray:
        """Zeroed segment-backed array (for streaming writers)."""
        shape = tuple(int(s) for s in np.atleast_1d(shape))
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if nbytes == 0:
            a = np.zeros(shape, dtype=dtype)
            self._by_id[id(a)] = (a, ArrayRef(None, shape, dtype.str))
            return a
        seg = self._new_segment(nbytes)
        a = np.ndarray(shape, dtype=dtype, buffer=seg.buf)
        a[:] = 0
        self._by_id[id(a)] = (a, ArrayRef(seg.name, shape, dtype.str))
        return a

    def share(self, a: np.ndarray) -> tuple[np.ndarray, ArrayRef]:
        """Copy ``a`` into a fresh segment; returns ``(view, ref)``.

        If ``a`` already came out of this registry (``alloc``/``share``),
        it is returned as-is -- zero-copy round trips for arrays that were
        streamed into shared memory at build time.
        """
        got = self._by_id.get(id(a))
        if got is not None and got[0] is a:
            return got
        a = np.ascontiguousarray(a)
        if a.nbytes == 0:
            ref = ArrayRef(None, a.shape, a.dtype.str)
            self._by_id[id(a)] = (a, ref)
            return a, ref
        seg = self._new_segment(a.nbytes)
        out = np.ndarray(a.shape, dtype=a.dtype, buffer=seg.buf)
        out[:] = a
        ref = ArrayRef(seg.name, a.shape, a.dtype.str)
        self._by_id[id(out)] = (out, ref)
        return out, ref

    def close(self) -> None:
        """Unlink every segment created here (idempotent, crash-safe)."""
        self._by_id.clear()
        segs, self._segs = self._segs, {}
        for seg in segs.values():
            try:
                seg.close()
            except Exception:
                pass
            try:
                seg.unlink()
            except Exception:
                pass  # already gone (e.g. unlinked by a dying tracker)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ------------------------------------------------------------- worker side

_ATTACHED: dict[str, tuple] = {}     # per-process: name -> (seg, array)
_HG_CACHE: dict[str, Hypergraph] = {}  # per-process: xpins name -> hg


def attach_array(ref: ArrayRef) -> np.ndarray:
    """Map a shared segment read-write; cached per process.

    Attach-only ``SharedMemory`` registers itself with the resource
    tracker (bpo-38119); the process tree shares one tracker, so that
    re-registration is a no-op -- but an *unregister* here would erase the
    creator's entry.  Registration is therefore suppressed for the attach
    call instead, leaving the parent's bookkeeping untouched.
    """
    if ref.name is None:
        return np.zeros(ref.shape, dtype=np.dtype(ref.dtype))
    got = _ATTACHED.get(ref.name)
    if got is None:
        from multiprocessing import resource_tracker, shared_memory
        orig_register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            seg = shared_memory.SharedMemory(name=ref.name)
        finally:
            resource_tracker.register = orig_register
        a = np.ndarray(ref.shape, dtype=np.dtype(ref.dtype), buffer=seg.buf)
        got = (seg, a)
        _ATTACHED[ref.name] = got
    return got[1]


def _attach_hg(hgd: dict) -> Hypergraph:
    """Rebuild a ``Hypergraph`` from shared CSR refs; cached per process
    (keyed by the xpins segment, one entry per level)."""
    key = hgd["xpins"].name or f"empty-{hgd['n']}"
    hg = _HG_CACHE.get(key)
    if hg is not None:
        return hg
    arrs = {k: attach_array(hgd[k]) for k in _CSR_KEYS}
    hg = Hypergraph.from_csr(hgd["n"], arrs["xpins"], arrs["pins"],
                             omega=attach_array(hgd["omega"]),
                             mu=attach_array(hgd["mu"]), name=hgd["name"])
    # seed the full lazy-CSR cache: the incidence/adjacency halves were
    # built once in the parent, workers must never rebuild them
    hg._csr = tuple(arrs[k] for k in _CSR_KEYS)
    _HG_CACHE[key] = hg
    return hg


def _pref_task(arg):
    """Worker: heavy-pin scoring for one node range (bit-identity contract
    documented on ``multilevel._match_pref``)."""
    hgd, max_edge_size, lo, hi = arg
    from .multilevel import _match_pref
    hg = _attach_hg(hgd)
    return _match_pref(hg, max_edge_size, lo, hi)


def _sched_pair_task(arg):
    """Worker: same-level pair generation for one owner-node range
    (bit-identity contract documented on
    ``schedule.multilevel._pair_parts``)."""
    refs, max_fanout, lo, hi = arg
    from ..schedule.multilevel import _pair_parts
    xch, ch_arr, xpar, par_arr, mu, level = (attach_array(r) for r in refs)
    return _pair_parts(xch, ch_arr, xpar, par_arr, mu, level,
                       max_fanout, lo, hi)


def _refine_task(arg):
    """Worker: refine one node shard against a state snapshot.

    Extracts the shard's incident-edge sub-hypergraph (full pin sets, so
    every delta a worker prices is globally exact w.r.t. the snapshot),
    runs the ordinary pass restricted to ``nodes`` in ``[lo, hi)``, and
    returns ``(changed_nodes, new_masks)`` proposals.
    """
    (hgd, mref, uref, lref, loads, P, eps, kind, passes, seed,
     max_replicas, lo, hi) = arg
    from .heuristic import fm_refine, replicate_local_search
    hg = _attach_hg(hgd)
    masks_live = attach_array(mref)
    uncov_live = attach_array(uref)
    lam_live = attach_array(lref)
    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    xinc, inc = hg.xinc, hg.inc_edges
    E_s = np.unique(inc[xinc[lo]:xinc[hi]])
    if len(E_s) == 0:
        return empty
    # shard sub-hypergraph: only E_s rows, full node space / pin sets
    lens = np.diff(hg.xpins)[E_s]
    xp_s = np.zeros(len(E_s) + 1, dtype=np.int64)
    np.cumsum(lens, out=xp_s[1:])
    offs = np.arange(int(xp_s[-1]), dtype=np.int64) - np.repeat(xp_s[:-1],
                                                                lens)
    pins_s = hg.pins[np.repeat(hg.xpins[E_s], lens) + offs]
    shard = Hypergraph.from_csr(hg.n, xp_s, pins_s, omega=hg.omega,
                                mu=np.asarray(hg.mu)[E_s],
                                name=f"{hg.name}[{lo}:{hi}]")
    masks = masks_live.copy()          # private snapshot; parent is blocked
    st = PartitionState.from_arrays(shard, P, masks, uncov_live[E_s],
                                    lam_live[E_s], loads=np.asarray(loads))
    nodes = np.arange(lo, hi, dtype=np.int64)
    if kind == "fm":
        fm_refine(shard, masks, P, eps, np.random.default_rng(seed),
                  passes=passes, state=st, frontier="numpy", nodes=nodes)
    else:
        replicate_local_search(shard, masks, P, eps,
                               max_replicas=max_replicas, max_passes=passes,
                               seed=seed, frontier="numpy", state=st,
                               nodes=nodes)
    changed = np.flatnonzero(st.masks != masks_live)
    return changed, st.masks[changed].copy()


def _crash_task(arg):
    """Worker that dies mid-task (shm-cleanup regression tests only)."""
    import os
    os._exit(17)


# ------------------------------------------------------------- parent side

class ParallelContext:
    """Pool + registry lifecycle for one partitioning run.

    The pool starts lazily on first use; ``failed`` flips sticky-true on
    the first worker-layer error, after which every call site falls back
    to its serial path (never abort the partition over a pool problem).
    """

    def __init__(self, workers: int, start_method: str | None = None,
                 min_nodes: int | None = None):
        self.workers = max(int(workers), 1)
        self.min_nodes = (PARALLEL_MIN_NODES if min_nodes is None
                          else int(min_nodes))
        if start_method is None:
            start_method = ("fork" if "fork" in mp.get_all_start_methods()
                            else "spawn")
        self.start_method = start_method
        self.reg = ShmRegistry()
        self.failed = False
        self._pool = None
        # per-context caches (strong refs pin object ids): segments die
        # with this context, so the cache must never outlive it either --
        # an attribute on the hg/state would go stale across contexts
        self._hg_exports: dict[int, tuple] = {}
        self._state_refs: dict[int, tuple] = {}

    # -- pool ------------------------------------------------------------
    def _get_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=mp.get_context(self.start_method))
        return self._pool

    def run(self, fn, tasks: list) -> list:
        """Map ``fn`` over ``tasks`` on the pool (raises on worker death;
        callers catch, set ``failed`` and go serial)."""
        return list(self._get_pool().map(fn, tasks))

    # -- shared exports --------------------------------------------------
    def export_hg(self, hg: Hypergraph) -> dict:
        """Share a hypergraph's six CSR arrays + omega + mu (once per
        context)."""
        got = self._hg_exports.get(id(hg))
        if got is not None:
            return got[1]
        csr = hg._build_csr()
        d = {"n": hg.n, "name": hg.name}
        for key, a in zip(_CSR_KEYS, csr):
            _, d[key] = self.reg.share(a)
        _, d["omega"] = self.reg.share(
            np.asarray(hg.omega, dtype=np.float64))
        _, d["mu"] = self.reg.share(np.asarray(hg.mu, dtype=np.float64))
        self._hg_exports[id(hg)] = (hg, d)
        return d

    def adopt_state(self, st: PartitionState) -> tuple:
        """Re-back ``st.masks`` / ``st.uncov`` / ``st.edge_lambda`` with
        shared segments (once per state).  The engine mutates these arrays
        in place, so after adoption every committed move is visible to
        workers with no further copies."""
        got = self._state_refs.get(id(st))
        if got is not None:
            return got[1]
        st.masks, mref = self.reg.share(st.masks)
        st.uncov, uref = self.reg.share(st.uncov)
        st.edge_lambda, lref = self.reg.share(st.edge_lambda)
        refs = (mref, uref, lref)
        self._state_refs[id(st)] = (st, refs)
        return refs

    def close(self) -> None:
        if self._pool is not None:
            pool, self._pool = self._pool, None
            try:
                pool.shutdown(wait=True, cancel_futures=True)
            except Exception:
                pass
        # detach adopted states: their arrays live inside segments about
        # to be unmapped -- hand each state private copies so it stays
        # usable after the context is gone
        for st, _ in self._state_refs.values():
            st.masks = st.masks.copy()
            st.uncov = st.uncov.copy()
            st.edge_lambda = st.edge_lambda.copy()
        self._hg_exports.clear()
        self._state_refs.clear()
        self.reg.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def plan_shards(hg: Hypergraph, W: int) -> np.ndarray:
    """Contiguous node-range bounds (len W+1), balanced by incidence
    degree (+1 per node so isolated nodes still spread)."""
    n = hg.n
    W = max(1, min(int(W), n))
    work = np.diff(hg.xinc).astype(np.int64) + 1
    cum = np.cumsum(work)
    targets = cum[-1] / W * np.arange(1, W)
    cuts = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.concatenate(([0], np.minimum(cuts, n), [n]))
    return np.maximum.accumulate(bounds)


def boundary_nodes(hg: Hypergraph, bounds: np.ndarray) -> np.ndarray:
    """Nodes incident to an edge whose pins span more than one shard --
    the set the serial reconciliation pass re-sweeps."""
    xpins, pins = hg.xpins, hg.pins
    m = len(xpins) - 1
    if m == 0 or len(pins) == 0:
        return np.zeros(0, dtype=np.int64)
    shard = np.searchsorted(bounds[1:-1], pins, side="right")
    lens = np.diff(xpins)
    ne = lens > 0
    starts = xpins[:-1][ne]
    mn = np.minimum.reduceat(shard, starts)
    mx = np.maximum.reduceat(shard, starts)
    cross = np.zeros(m, dtype=bool)
    cross[ne] = mn != mx
    return np.unique(pins[np.repeat(cross, lens)])


def parallel_match_pref(hg: Hypergraph, ctx: ParallelContext,
                        max_edge_size: int) -> np.ndarray:
    """Sharded heavy-pin scoring; concatenation is bit-identical to the
    serial ``_match_pref`` (see its docstring for the why)."""
    from .multilevel import _match_pref
    try:
        bounds = plan_shards(hg, ctx.workers)
        hgd = ctx.export_hg(hg)
        tasks = [(hgd, int(max_edge_size), int(bounds[w]),
                  int(bounds[w + 1]))
                 for w in range(len(bounds) - 1)
                 if bounds[w + 1] > bounds[w]]
        parts = ctx.run(_pref_task, tasks)
        return np.concatenate(parts)
    except Exception:
        ctx.failed = True
        return _match_pref(hg, max_edge_size)


def parallel_pair_parts(dag, xch: np.ndarray, level: np.ndarray,
                        ctx: ParallelContext, max_fanout: int) -> list:
    """Sharded same-level pair generation for the scheduling V-cycle's
    coarsening (``schedule.multilevel.same_level_matching``).

    Shares the DAG's flat group arrays once per call (coarsening builds a
    fresh ``Dag`` and level array every round, so there is nothing to
    cache across calls) and maps ``_pair_parts`` over contiguous
    owner-node ranges.  Returns the per-shard 6-tuples in shard order;
    the caller concatenates child blocks then parent blocks, which equals
    the serial arrays byte-for-byte (see ``_pair_parts``).  Raises on
    pool trouble -- the call site flips ``ctx.failed`` and goes serial.
    """
    n = int(dag.n)
    refs = []
    for a in (xch, dag.edge_dst, dag.xpar, dag.par_arr,
              np.asarray(dag.mu, dtype=np.float64),
              np.asarray(level, dtype=np.int64)):
        _, ref = ctx.reg.share(a)
        refs.append(ref)
    refs = tuple(refs)
    # balance shards by quadratic group work (pairs scale with len^2)
    lens_ch = np.diff(xch)
    lens_pa = np.diff(dag.xpar)
    work = np.ones(n, dtype=np.int64)
    for lens in (lens_ch, lens_pa):
        ok = (lens >= 2) & (lens <= max_fanout)
        work[ok] += (lens[ok] * lens[ok]).astype(np.int64)
    cum = np.cumsum(work)
    W = max(1, min(ctx.workers, n))
    targets = cum[-1] / W * np.arange(1, W)
    cuts = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.maximum.accumulate(
        np.concatenate(([0], np.minimum(cuts, n), [n])))
    tasks = [(refs, int(max_fanout), int(bounds[w]), int(bounds[w + 1]))
             for w in range(len(bounds) - 1) if bounds[w + 1] > bounds[w]]
    return ctx.run(_sched_pair_task, tasks)


def parallel_refine(hg: Hypergraph, st: PartitionState, P: int, eps: float,
                    ctx: ParallelContext, kind: str, passes: int,
                    seed: int, max_replicas: int | None = None) -> dict:
    """One sharded refinement stop; mutates ``st`` in place.

    Shard -> propose -> reconcile -> boundary pass (module docstring has
    the full story).  Cost-not-worse by construction: reconciliation
    replays every proposal through ``st.apply`` and keeps it only when it
    still improves (or is cost-neutral and strictly drops replicas) under
    capacity; the boundary pass applies only improving moves too.
    Returns a stats dict (workers / proposed / accepted / boundary).
    """
    from .cost import capacity
    from .heuristic import fm_refine, replicate_local_search
    stats = {"n": hg.n, "kind": kind, "workers": 0, "proposed": 0,
             "accepted": 0, "boundary": 0, "serial_fallback": False}
    cost0 = float(st.cost)
    cap = capacity(hg, P, eps) + 1e-9
    results = None
    bounds = None
    if not ctx.failed and ctx.workers > 1:
        try:
            bounds = plan_shards(hg, ctx.workers)
            hgd = ctx.export_hg(hg)
            mref, uref, lref = ctx.adopt_state(st)
            loads = np.asarray(st.loads, dtype=np.float64).copy()
            tasks = []
            for w in range(len(bounds) - 1):
                lo, hi = int(bounds[w]), int(bounds[w + 1])
                if hi > lo:
                    tasks.append((hgd, mref, uref, lref, loads, P, eps,
                                  kind, passes, seed + 7919 * w,
                                  max_replicas, lo, hi))
            results = ctx.run(_refine_task, tasks)
            stats["workers"] = len(tasks)
        except Exception:
            ctx.failed = True
            results = None
    if results is None:
        # pool unavailable/broken: the ordinary serial pass on ``st``
        stats["serial_fallback"] = True
        if kind == "fm":
            fm_refine(hg, st.masks, P, eps, np.random.default_rng(seed),
                      passes=passes, state=st, frontier="numpy")
        else:
            replicate_local_search(hg, st.masks, P, eps,
                                   max_replicas=max_replicas,
                                   max_passes=passes, seed=seed,
                                   frontier="numpy", state=st)
        return stats
    # reconcile: replay proposals on the live state, keep only what still
    # helps (workers priced against a snapshot; earlier acceptances may
    # have gone stale) -- deterministic order: shard-major, node-ascending
    proposed = accepted = 0
    for changed, new_masks in results:
        for v, m_new in zip(changed.tolist(), new_masks.tolist()):
            proposed += 1
            m_old = int(st.masks[v])
            if m_new == m_old:
                continue
            delta = st.apply(v, int(m_new))
            better = delta < -1e-12 or (
                delta <= 1e-12
                and int(st.popcnt[m_new]) < int(st.popcnt[m_old]))
            if better and bool(np.all(st.loads <= cap)):
                st.commit()
                accepted += 1
            else:
                st.undo()
    # serial boundary pass: nodes whose edges cross shards are the only
    # places the sharded passes could not price full moves
    bnodes = boundary_nodes(hg, bounds)
    if len(bnodes):
        if kind == "fm":
            fm_refine(hg, st.masks, P, eps, np.random.default_rng(seed),
                      passes=passes, state=st, frontier="numpy",
                      nodes=bnodes)
        else:
            replicate_local_search(hg, st.masks, P, eps,
                                   max_replicas=max_replicas,
                                   max_passes=passes, seed=seed,
                                   frontier="numpy", state=st, nodes=bnodes)
    stats.update(proposed=proposed, accepted=accepted,
                 boundary=int(len(bnodes)))
    assert st.cost <= cost0 + 1e-6, \
        f"parallel refine worsened cost: {cost0} -> {st.cost}"
    return stats

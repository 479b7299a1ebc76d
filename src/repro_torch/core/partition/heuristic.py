"""Heuristic partitioner + replication local search for paper-scale instances.

The paper solves instances of 80-500 nodes with a commercial ILP solver and a
5-hour budget; offline, we complement the exact branch-and-bound
(`exact.py`, viable to n ~ 25-40) with:

  * a multi-restart greedy + FM-style refinement baseline (no replication);
  * a replication local search that starts from the non-replicating solution
    and keeps adding (or dropping) replicas while the connectivity cost
    decreases and the balance constraint allows it.  ``max_replicas=2``
    gives the ILP/D search space, ``None`` the ILP/R one.

All move evaluation runs on the incremental-gain ``PartitionState`` engine
(O(degree) per candidate instead of full set-cover recomputation; see
``engine.py``), which is what lets the local search reach hundreds-to-
thousands of nodes.  On top of it sits the frontier-pricing layer
(``core.frontier``): a ``GainCache`` holds every node's candidate deltas,
priced in batched vectorized fronts and invalidated through the
pin-adjacency, so refinement passes are *output-sensitive* -- only nodes
whose gain actually changed are repriced, and they are repriced together
instead of one engine call per node.  Decisions are identical to the
per-node rescan (kept as ``frontier="off"``).  With the torch backend on
a large integer-weight instance, whole FM and replication sweeps run in
the device-resident pass (``kernels.front_pass``) instead, with the same
decisions.  ``reference.py`` holds the full-recompute search for P
beyond the engine's tables.

Tie-breaking rule (shared by every move selection below, and pinned by
``tests/test_frontier.py``): candidate masks are generated in **ascending
processor order** and the first minimum wins (``int(np.argmin(...))``
returns the lowest index), i.e. ties go to the lowest processor id.  Any
batched backend must reproduce this, which is why the frontier candidate
builders emit masks in ascending-q order and the front reduction is
bit-equal to the scalar engine deltas.

This mirrors the paper's observation (§8) that replication comes "for free":
the per-partition capacity is unchanged, replicas only consume slack.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque

import numpy as np
import torch

from ..hypergraph import Hypergraph
from .cost import capacity, edge_cost, min_cover, partition_cost  # noqa: F401
from ..frontier import partition_front
from .engine import _MAX_P, PartitionState


@dataclasses.dataclass
class HeuristicResult:
    masks: np.ndarray
    cost: float


def greedy_initial(hg: Hypergraph, P: int, eps: float, rng: np.random.Generator) -> np.ndarray:
    """BFS-grow partitions over the pin-adjacency, balanced by weight.

    Stage entry point: the flat heuristic seeds every restart with it, the
    multilevel V-cycle (``multilevel.py``) only ever runs it at the
    coarsest level.
    """
    cap_target = float(hg.omega.sum()) / P  # aim for perfect balance
    xadj, adj = hg.xadj, hg.adj_nodes
    visited = np.zeros(hg.n, dtype=bool)
    part = np.zeros(hg.n, dtype=np.int64)
    order = rng.permutation(hg.n)
    cur_p, cur_w = 0, 0.0

    # in_queue dedupes the multiset pin-adjacency: only a node's *first*
    # queue occurrence is ever visited, so dropping later duplicates keeps
    # the BFS order (and hence the partition) bit-identical while cutting
    # queue traffic from O(sum deg^2) to O(n)
    queue: deque[int] = deque()
    in_queue = np.zeros(hg.n, dtype=bool)
    qi = 0
    while True:
        if not queue:
            while qi < hg.n and visited[order[qi]]:
                qi += 1
            if qi == hg.n:
                break
            queue.append(order[qi])
            in_queue[order[qi]] = True
        v = queue.popleft()
        if visited[v]:
            continue
        visited[v] = True
        if cur_w + hg.omega[v] > cap_target and cur_p < P - 1:
            cur_p += 1
            cur_w = 0.0
        part[v] = cur_p
        cur_w += hg.omega[v]
        nbr = adj[xadj[v]:xadj[v + 1]]
        fresh = nbr[~(visited[nbr] | in_queue[nbr])]
        if len(fresh):
            first = np.sort(np.unique(fresh, return_index=True)[1])
            fresh = fresh[first]
            in_queue[fresh] = True
            queue.extend(fresh.tolist())
    return (1 << part).astype(np.int64)


def fm_refine(hg: Hypergraph, masks: np.ndarray, P: int, eps: float,
              rng: np.random.Generator, passes: int = 6,
              state: PartitionState | None = None,
              frontier: str | None = None,
              nodes: np.ndarray | None = None,
              device: str | torch.device = "cuda") -> np.ndarray:
    """Move-based refinement (single-assignment masks), engine-backed.

    Stage entry point, independently callable with externally supplied
    masks or a live ``PartitionState`` (the multilevel V-cycle hands it
    the state built from projected masks at every level).

    Default path: a frontier ``GainCache`` prices the whole node front in
    one batched call per pass and thereafter only nodes adjacent to an
    applied move (output-sensitive FM).  ``frontier="off"`` keeps the
    per-node rescan; both take identical decisions (ties to the lowest
    processor id, see the module docstring).

    ``nodes`` (optional sorted id array) restricts the sweep to those
    movers.  With ``nodes=None`` the RNG consumption is one
    ``permutation(hg.n)`` per pass.

    ``device`` is where the torch backend runs (the device-resident pass
    and the per-front kernel); with the torch backend and no CUDA device,
    the default ``"cuda"`` raises instead of running on the CPU.
    """
    partition_front.check_device(frontier, device)
    cap = capacity(hg, P, eps) + 1e-9
    st = state if state is not None else PartitionState(hg, P, masks=masks)
    if nodes is not None:
        nodes = np.asarray(nodes, dtype=np.int64)
    if frontier != "off" and nodes is None:
        # torch backend, large instance: run whole passes device-resident
        # (one host sync per committed move; decisions bit-identical --
        # see kernels.front_pass).  Falls through to the numpy front path
        # whenever the device pass cannot hold the instance exactly.
        dev = partition_front.device_pass(st, cap, backend=frontier,
                                          device=device)
        if dev is not None:
            try:
                dev.run_fm(rng, passes)
            finally:
                dev.detach()
            masks[:] = st.masks
            return masks
    if frontier == "off":
        for _ in range(passes):
            improved = False
            for v in (rng.permutation(hg.n) if nodes is None
                      else nodes[rng.permutation(len(nodes))]):
                v = int(v)
                p = int(st.masks[v]).bit_length() - 1
                targets = [q for q in range(P)
                           if q != p and st.fits(v, q, cap)]
                if not targets:
                    continue
                deltas = st.delta_masks(v, np.array([1 << q for q in targets]))
                best = int(np.argmin(deltas))
                if deltas[best] < -1e-12:
                    st.apply(v, 1 << targets[best])
                    st.commit()
                    improved = True
            if not improved:
                break
        masks[:] = st.masks
        return masks
    from ..frontier import (GainCache, fm_move_candidates,
                            lookahead_window, refresh_boundary_window)
    cache = GainCache(st, fm_move_candidates, backend=frontier, device=device)
    W = lookahead_window(st)
    # on high-degree instances a window
    # refresh prices mostly nodes that get re-dirtied before their visit;
    # lazy singleton refreshes in cache.get keep every visit O(deg * K)
    # with no thrash.  Purely a batching choice: values stay exact either
    # way, so decisions cannot change.
    use_windows = len(st.pins) <= 128 * max(hg.n, 1)
    xinc, inc_edges = st.xinc, st.inc_edges
    elam = st.edge_lambda  # updated in place by apply/undo
    # boundary filter (exact at visit time, mirrors the per-node rescan):
    # if every incident edge has lambda <= 1, each one is covered by a
    # single processor every pin of it shares -- re-masking v can only
    # raise its lambda, so no candidate is strictly improving and the node
    # skips pricing entirely (decision-identical; interior nodes are the
    # vast majority of a refined partition).  Boundary status can only
    # change when a pin sharing an edge is re-masked -- the same event
    # that dirties the gain cache -- so it is memoized per node and
    # re-derived only after an adjacent move (``bnd_fresh``).
    bnd = np.zeros(hg.n, dtype=bool)
    bnd_fresh = np.zeros(hg.n, dtype=bool)
    xadj, adj_nodes = hg.xadj, hg.adj_nodes
    for _ in range(passes):
        improved = False
        perm = (rng.permutation(hg.n) if nodes is None
                else nodes[rng.permutation(len(nodes))])
        for i, v in enumerate(perm):
            if not bnd_fresh[v]:
                inc = inc_edges[xinc[v]:xinc[v + 1]]
                bnd[v] = inc.size > 0 and int(elam[inc].max()) > 1
                bnd_fresh[v] = True
            if not bnd[v]:
                continue
            if use_windows and cache.is_dirty(v):
                # lookahead: reprice the boundary part of the window in
                # one go (shared rule, see frontier.refresh_boundary_window)
                refresh_boundary_window(cache, perm, i, W)
            cands, deltas = cache.get(v)
            # capacity filter at decision time (loads move on every apply;
            # cost deltas do not depend on them) -- ascending q order
            sel = [j for j in range(len(cands))
                   if st.fits(v, int(cands[j]).bit_length() - 1, cap)]
            if not sel:
                continue
            sub = deltas[sel]
            best = int(np.argmin(sub))  # first minimum: lowest processor id
            if sub[best] < -1e-12:
                st.apply(v, int(cands[sel[best]]))
                st.commit()
                cache.invalidate_move(v)
                bnd_fresh[adj_nodes[xadj[v]:xadj[v + 1]]] = False
                bnd_fresh[v] = False
                improved = True
        if not improved:
            break
    masks[:] = st.masks
    return masks


def partition_heuristic(hg: Hypergraph, P: int, eps: float,
                        restarts: int = 4, seed: int = 0,
                        frontier: str | None = None,
                        device: str | torch.device = "cuda") -> HeuristicResult:
    """Non-replicating baseline: greedy initial + FM refinement, best of restarts.

    ``frontier`` selects the gain-pricing path: ``None`` (the frontier
    layer's default backend), ``"torch"`` / ``"numpy"`` explicitly, or
    ``"off"`` for the pre-frontier per-node rescan -- all decision-
    identical.  ``device`` as in ``fm_refine``.
    """
    partition_front.check_device(frontier, device)
    if P > _MAX_P:  # beyond the engine's 2^P tables: scalar reference path
        from .reference import partition_heuristic_reference
        masks, cost = partition_heuristic_reference(hg, P, eps,
                                                    restarts=restarts,
                                                    seed=seed)
        return HeuristicResult(masks=masks, cost=cost)
    rng = np.random.default_rng(seed)
    best_masks, best_cost = None, np.inf
    for _ in range(restarts):
        masks = greedy_initial(hg, P, eps, rng)
        st = PartitionState(hg, P, masks=masks)
        fm_refine(hg, masks, P, eps, rng, state=st, frontier=frontier,
                  device=device)
        if st.cost < best_cost:
            best_cost, best_masks = st.cost, st.masks.copy()
    return HeuristicResult(masks=best_masks, cost=float(best_cost))


def replicate_local_search(
    hg: Hypergraph,
    masks: np.ndarray,
    P: int,
    eps: float,
    max_replicas: int | None = None,
    max_passes: int = 30,
    seed: int = 0,
    frontier: str | None = None,
    state: PartitionState | None = None,
    nodes: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> HeuristicResult:
    """Add/drop replicas while the (lambda_e - 1) cost decreases.

    Starts from any valid assignment (typically the non-replicating optimum
    or heuristic solution, as the paper suggests for warm-starting ILPs in
    §C.1.1).  Stage entry point: pass ``state`` to search on a live
    ``PartitionState`` instead of rebuilding one from ``masks`` (the
    multilevel V-cycle supplies the state built from projected masks; the
    search then refines it in place).  Add-replica candidates are priced
    through the frontier ``GainCache`` (batched, output-sensitive;
    ``frontier="off"`` keeps the per-node engine rescan -- identical
    decisions, ties to the lowest processor id); drops and the multi-pin
    edge-guided move stay on the engine's scalar delta / apply+undo path.

    ``nodes`` (optional sorted id array) restricts every mover -- the node
    sweep visits only those nodes and the edge-guided move may only
    replicate onto processors whose minority pins all lie inside the set
    (the process-parallel layer's shard/boundary discipline).  With
    ``nodes=None`` the RNG consumption is one ``permutation`` of the edges
    and one of the nodes per pass.  ``device`` as in ``fm_refine``.
    """
    partition_front.check_device(frontier, device)
    if P > _MAX_P:  # beyond the engine's 2^P tables: scalar reference path
        from .reference import replicate_local_search_reference
        out_masks, cost = replicate_local_search_reference(
            hg, masks, P, eps, max_replicas=max_replicas,
            max_passes=max_passes, seed=seed)
        return HeuristicResult(masks=out_masks, cost=cost)
    rng = np.random.default_rng(seed)
    st = (state if state is not None
          else PartitionState(hg, P, masks=np.asarray(masks, dtype=np.int64)))
    cap = capacity(hg, P, eps) + 1e-9
    xpins, pins = hg.xpins, hg.pins
    cache = None
    dev = None
    W = 64
    use_windows = len(st.pins) <= 128 * max(hg.n, 1)  # cf. fm_refine
    allowed = None
    if nodes is not None:
        nodes = np.asarray(nodes, dtype=np.int64)
        allowed = np.zeros(hg.n, dtype=bool)
        allowed[nodes] = True
    if frontier != "off" and nodes is None:
        # device-resident node sweep (cf. fm_refine): the edge-guided phase
        # stays on the host engine, whose apply/undo hook keeps the device
        # mirror synced; the add/drop sweep runs on device with one host
        # sync per committed move
        dev = partition_front.device_pass(st, cap, backend=frontier,
                                          device=device)
    if frontier != "off" and dev is None:
        from ..frontier import (GainCache, connected_add_candidates,
                                lookahead_window, refresh_boundary_window)
        cache = GainCache(st, connected_add_candidates, backend=frontier,
                          device=device)
        W = lookahead_window(st)
    # memoized boundary status, invalidated through the pin-adjacency on
    # every applied mutation (cf. fm_refine: exact at visit time)
    bnd = np.zeros(hg.n, dtype=bool)
    bnd_fresh = np.zeros(hg.n, dtype=bool)

    def _moved(v: int) -> None:
        if cache is not None:
            cache.invalidate_move(v)
        bnd_fresh[hg.adj_nodes[hg.xadj[v]:hg.xadj[v + 1]]] = False
        bnd_fresh[v] = False

    allp = np.arange(P, dtype=np.int64)

    def try_edge_move(ei: int) -> bool:
        """Edge-guided move: a hyperedge with lambda>=2 whose minority side
        has few pins can often be closed by replicating ALL minority pins
        at once (single-node moves cannot improve an 8-pin hyperedge).

        One vectorized (|e|, P) scan replaces the per-processor python
        listcomps; the winner rule is unchanged (fewest movers, ties to
        the lowest processor id)."""
        if st.lambda_of(ei) < 2:
            return False
        e = pins[xpins[ei]:xpins[ei + 1]]
        masks_e = st.masks[e]
        off = ((masks_e[:, None] >> allp[None, :]) & 1) == 0   # (|e|, P)
        cnt = off.sum(axis=0)
        w = hg.omega[e] @ off
        ok = (cnt > 0) & (np.asarray(st.loads) + w <= cap)
        if allowed is not None:
            # shard discipline: only processors whose minority pins are all
            # permitted movers are eligible (other pins stay untouched)
            ok &= ~(off & ~allowed[e][:, None]).any(axis=0)
        if max_replicas is not None:
            at_cap = st.popcnt[masks_e] >= max_replicas
            ok &= ~(off & at_cap[:, None]).any(axis=0)
        if not ok.any():
            return False
        cnt_ok = np.where(ok, cnt, len(e) + 1)
        p = int(np.argmin(cnt_ok))        # fewest movers, ties: lowest p
        movers = [int(v) for v in e[off[:, p]]]
        delta = 0.0
        for v in movers:
            delta += st.apply(v, int(st.masks[v]) | (1 << p))
        if delta < -1e-12:
            st.commit()
            for v in movers:
                _moved(v)
            return True
        st.undo(len(movers))
        return False

    def _node_sweep(perm: np.ndarray) -> bool:
        improved = False
        for i, v in enumerate(perm):
            m = int(st.masks[v])
            k = bin(m).count("1")
            # boundary filter for the add step (visit-time exact, mirrors
            # fm_refine): adding a replica can only lower an edge's lambda
            # if some incident edge has lambda >= 2, so interior nodes have
            # no strictly improving add candidate and skip the pricing
            if not bnd_fresh[v]:
                inc = st.inc_edges[st.xinc[v]:st.xinc[v + 1]]
                bnd[v] = inc.size > 0 and int(st.edge_lambda[inc].max()) > 1
                bnd_fresh[v] = True
            # --- try adding a replica ---
            if bnd[v] and (max_replicas is None or k < max_replicas):
                if cache is not None:
                    if use_windows and cache.is_dirty(v):
                        refresh_boundary_window(cache, perm, i, W)
                    cands, deltas = cache.get(v)
                    sel = [j for j in range(len(cands))
                           if st.fits(v, (int(cands[j]) ^ m).bit_length() - 1,
                                      cap)]
                else:
                    adds = [p for p in range(P)
                            if not (m >> p) & 1 and st.fits(v, p, cap)]
                    sel = []
                    if adds:
                        cands = np.array([m | (1 << p) for p in adds],
                                         dtype=np.int64)
                        deltas = st.delta_masks(v, cands)
                        sel = list(range(len(adds)))
                if sel:
                    sub = deltas[sel]
                    best = int(np.argmin(sub))  # ties: lowest processor id
                    if sub[best] < -1e-12:
                        st.apply(v, int(cands[sel[best]]))
                        st.commit()
                        _moved(v)
                        improved = True
                        continue
            # --- try dropping a replica (free the balance slack) ---
            if k > 1:
                for p in range(P):
                    m = int(st.masks[v])
                    if bin(m).count("1") <= 1:
                        break
                    if not (m >> p) & 1:
                        continue
                    if st.delta_drop_replica(v, p) <= 1e-12:
                        st.apply(v, m & ~(1 << p))
                        st.commit()
                        _moved(v)
                        improved = True
        return improved

    try:
        for _ in range(max_passes):
            improved = False
            for ei in rng.permutation(len(hg.edges)):
                if try_edge_move(int(ei)):
                    improved = True
            perm = (rng.permutation(hg.n) if nodes is None
                    else nodes[rng.permutation(len(nodes))])
            if dev is not None:
                # device node sweep: same permutation, same decisions
                if dev.rep_pass(perm, max_replicas):
                    improved = True
            elif _node_sweep(perm):
                improved = True
            if not improved:
                break
    finally:
        if dev is not None:
            dev.detach()
    return HeuristicResult(masks=st.masks.copy(), cost=float(st.cost))


def partition_with_replication(
    hg: Hypergraph,
    P: int,
    eps: float,
    mode: str = "rep",
    exact_node_limit: int = 24,
    time_limit: float | None = 20.0,
    seed: int = 0,
    frontier: str | None = None,
    multilevel: bool = False,
    device: str | torch.device = "cuda",
):
    """End-to-end entry: returns (non_repl_result, repl_result).

    Small instances are solved exactly (both with and without replication,
    i.e. the paper's base-ILP vs ILP/D or ILP/R comparison) regardless of
    ``multilevel``; larger ones use the heuristic + replication local
    search.  ``multilevel=True`` (the V-cycle) is not ported yet and
    raises on that heuristic path.  ``device`` as in ``fm_refine``.
    """
    from .exact import exact_partition

    partition_front.check_device(frontier, device)
    if hg.n <= exact_node_limit and P <= _MAX_P:
        base = exact_partition(hg, P, eps, mode="none", time_limit=time_limit)
        rep = exact_partition(hg, P, eps, mode=mode, time_limit=time_limit,
                              ub_masks=base.masks)
        return base, rep
    if multilevel:
        raise NotImplementedError(
            "multilevel=True: the V-cycle is not ported yet (ROADMAP.md, "
            "Queue 1: multilevel and parallel V-cycles)")
    base = partition_heuristic(hg, P, eps, seed=seed, frontier=frontier,
                               device=device)
    max_replicas = 2 if mode == "dup" else None
    # alternate replication local search with FM passes on the primary
    # copies (the paper's ILP optimizes base assignment and replicas
    # jointly; two-phase search alone gets stuck, cf. §C.1.1)
    best = replicate_local_search(hg, base.masks.copy(), P, eps,
                                  max_replicas=max_replicas, seed=seed,
                                  frontier=frontier, device=device)
    if P > _MAX_P:
        from .reference import fm_refine_reference as _refine
    else:
        _refine = functools.partial(fm_refine, frontier=frontier,
                                    device=device)
    for r in range(3):
        masks = best.masks.copy()
        # re-run FM treating each node's first replica as its home
        primary = np.array([1 << (int(m).bit_length() - 1) for m in masks])
        moved = _refine(hg, primary.copy(), P, eps,
                        np.random.default_rng(seed + r + 1))
        cand = replicate_local_search(hg, moved, P, eps,
                                      max_replicas=max_replicas,
                                      seed=seed + r + 1,
                                      frontier=frontier, device=device)
        if cand.cost < best.cost - 1e-12:
            best = cand
        else:
            break
    return base, best

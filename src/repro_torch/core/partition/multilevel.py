"""Multilevel V-cycle partitioning (METIS-style coarsening).

The flat greedy-BFS + FM stack tops out around n ~ 6000 (seconds per
instance): every restart walks the whole hypergraph and every refinement
pass prices every node.  The standard route to large instances is the
multilevel V-cycle -- coarsen until the hypergraph is small, partition the
coarse instance well, then project the solution back up level by level,
refining locally at each scale.  What is new here relative to stock
multilevel partitioners is that the *replication* local search (the
paper's cost model: ``sum mu_e * (lambda_e - 1)`` with set-cover lambdas)
runs inside the V-cycle too, with replication masks projecting as unions.

Pipeline (one V-cycle)::

    match   heavy-pin matching, vectorized over the CSR arrays
    contract  ``Hypergraph.contract``: cluster map + identical-net collapse
    recurse  until ``coarsest_n`` nodes, stagnation, or ``max_levels``
    solve    flat ``partition_heuristic`` (+ ``replicate_local_search``)
             at the coarsest level -- restarts are cheap there
    project  ``coarse_masks[cmap]``; ``PartitionState.from_projection``
             rebuilds the fine engine state reusing the coarse lambdas --
             projection is cost-exact (bit-identical state, see
             ``tests/test_torch_multilevel.py``), so the V-cycle changes
             wall-clock and reach, never correctness
    refine   frontier-priced FM (``GainCache`` fronts) and
             ``replicate_local_search`` at each refinement stop (every
             ``refine_every``-th level; skipped hops project through
             composed maps, which is still cost-exact).  With
             ``frontier="torch"`` the levels of at least
             ``DEVICE_MIN_NODES`` nodes run their passes device-resident
             (``kernels.front_pass``, one host read per committed move,
             decision-identical) and the coarser ones price their large
             fronts with the min-cover kernel -- the ``frontier`` and
             ``device`` arguments thread through unchanged, so the
             V-cycle needs no device-specific code.  Each stop attaches
             a fresh device pass to the projected state and releases it
             when the stop ends

Cost safety: the coarsest level is solved by the *same* flat heuristic,
projection preserves cost exactly, and every refinement stage only ever
applies strictly improving moves -- so the final cost can only be at or
below the coarsest solution's, and in practice at or below the flat
heuristic's wherever both run (pinned on the shipped spmv datasets by
``tests/test_torch_multilevel.py``, and on the card by
``chip_smoke.py``'s V-cycle phase).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..frontier import partition_front
from ..hypergraph import Hypergraph
from .engine import _MAX_P, PartitionState
from .heuristic import (HeuristicResult, fm_refine, partition_heuristic,
                        partition_with_replication, replicate_local_search)


@dataclasses.dataclass
class MultilevelOptions:
    """Knobs of the V-cycle driver (defaults tuned for spmv row-nets)."""

    coarsest_n: int = 384      # stop coarsening at this many nodes
    max_levels: int = 24       # hard cap on the level stack depth
    stagnation: float = 0.9    # stop when a level shrinks less than this
    max_edge_size: int = 24    # larger edges do not steer the matching
    cluster_cap_frac: float = 0.15  # max cluster weight, fraction of W/P
    fm_passes: int = 1         # FM passes per intermediate level
    final_fm_passes: int = 3   # FM passes at the finest level
    restarts: int = 2          # flat restarts at the coarsest level
    rep_passes: int = 2        # replication passes per intermediate level
    final_rep_passes: int = 12  # replication passes at the finest level
    alternations: int = 1      # primary-FM + replicate rounds at the end
    refine_every: int = 2      # refine every k-th level (finest always);
    #                            skipped levels project straight through
    #                            (composed cmaps -- still cost-exact)


# --------------------------------------------------------------- coarsening

def _match_pref(hg: Hypergraph, max_edge_size: int, lo: int = 0,
                hi: int | None = None) -> np.ndarray:
    """Best heavy-pin partner per node of ``[lo, hi)`` (-1 = none).

    The pair expansion for a node v draws only on v's incident small
    edges, and the (v, u) score sums accumulate in ascending-edge
    expansion order -- so computing a node range from the range's incident
    edge set (an ascending superset of each member's incident edges)
    reproduces the full-graph pass byte for byte.  That is the sharding
    contract of the process-parallel scorer: concatenating per-range
    results over any partition of [0, n) equals the serial ``pref``.
    """
    n = hg.n
    hi = n if hi is None else hi
    xpins, pins = hg.xpins, hg.pins
    lens = np.diff(xpins)
    if lo == 0 and hi == n:
        sel = np.flatnonzero((lens >= 2) & (lens <= max_edge_size))
    else:
        xinc, inc = hg.xinc, hg.inc_edges
        cand = np.unique(inc[xinc[lo]:xinc[hi]])
        cl = lens[cand]
        sel = cand[(cl >= 2) & (cl <= max_edge_size)]
    pref = np.full(hi - lo, -1, dtype=np.int64)
    if len(sel):
        L = lens[sel]
        L2 = L * L
        edge_rep = np.repeat(sel, L2)
        offs = np.arange(int(L2.sum()), dtype=np.int64)
        offs -= np.repeat(np.cumsum(L2) - L2, L2)
        Lr = np.repeat(L, L2)
        base = xpins[edge_rep]
        v = pins[base + offs // Lr]
        u = pins[base + offs % Lr]
        w = np.repeat(hg.mu[sel] / (L - 1), L2)
        keep = v != u
        if lo > 0 or hi < n:
            keep &= (v >= lo) & (v < hi)
        v, u, w = v[keep], u[keep], w[keep]
        if len(v):
            key = v * n + u
            order = np.argsort(key, kind="stable")
            key, w = key[order], w[order]
            first = np.ones(len(key), dtype=bool)
            first[1:] = key[1:] != key[:-1]
            starts = np.flatnonzero(first)
            score = np.add.reduceat(w, starts)
            vd, ud = key[starts] // n, key[starts] % n
            # per node: strongest partner first, ties to the smallest id
            order2 = np.lexsort((ud, -score, vd))
            vd2 = vd[order2]
            lead = np.ones(len(vd2), dtype=bool)
            lead[1:] = vd2[1:] != vd2[:-1]
            pref[vd2[lead] - lo] = ud[order2][lead]
    return pref


def heavy_pin_matching(hg: Hypergraph, max_weight: float,
                       rng: np.random.Generator,
                       max_edge_size: int = 24,
                       ctx=None) -> tuple[np.ndarray, int]:
    """Cluster map from heavy-pin matching, scored over the CSR arrays.

    Connectivity score between two nodes is ``sum mu_e / (|e| - 1)`` over
    shared hyperedges (the classic heavy-edge rating); edges larger than
    ``max_edge_size`` are ignored for scoring (they are nearly uncut-able
    and would blow the pair expansion up quadratically).  Every node's best
    partner (max score, ties to the smallest id) is computed in one
    vectorized pass; a greedy sweep in random order then pairs mutually
    free nodes whose combined weight stays under ``max_weight``.  Unmatched
    nodes become singleton clusters.  Returns ``(cmap, nc)``.

    ``ctx`` (a ``parallel.ParallelContext``) shards the scoring pass --
    the O(sum |e|^2) pair expansion, the expensive half -- over node
    ranges across the worker pool; the O(n) greedy sweep stays serial on
    the same ``rng``, so the resulting ``cmap`` is bit-identical to the
    serial path for every worker count.
    """
    n = hg.n
    if (ctx is not None and not ctx.failed and ctx.workers > 1
            and n >= ctx.min_nodes):
        from .parallel import parallel_match_pref
        pref = parallel_match_pref(hg, ctx, max_edge_size)
    else:
        pref = _match_pref(hg, max_edge_size)
    omega = hg.omega
    match = np.full(n, -1, dtype=np.int64)
    for v in rng.permutation(n):
        u = pref[v]
        if match[v] >= 0 or u < 0 or match[u] >= 0:
            continue
        if omega[v] + omega[u] > max_weight:
            continue
        match[v] = u
        match[u] = v
    # cluster ids in order of each cluster's smallest member (deterministic,
    # locality-preserving for the coarse BFS)
    partner = np.where(match >= 0, match, np.arange(n, dtype=np.int64))
    rep = np.minimum(np.arange(n, dtype=np.int64), partner)
    reps = np.unique(rep)
    cmap = np.searchsorted(reps, rep)
    return cmap, len(reps)


def build_levels(hg: Hypergraph, P: int, eps: float, opts: MultilevelOptions,
                 rng: np.random.Generator, ctx=None):
    """Coarsen until small/stagnant: ``(levels, cmaps, edge_maps)``.

    ``levels[0]`` is the input; ``cmaps[i]``/``edge_maps[i]`` map
    ``levels[i]`` onto ``levels[i + 1]``.  ``ctx`` shards the matching
    scorer across a worker pool (bit-identical cmaps, see
    ``heavy_pin_matching``).
    """
    levels, cmaps, edge_maps = [hg], [], []
    # cluster weight cap: granular enough that the coarsest greedy's
    # per-partition overshoot (at most one node weight) stays inside the
    # eps balance slack -- half the slack, and never above the knob
    max_w = min(opts.cluster_cap_frac, 0.5 * eps) * float(hg.omega.sum()) / P
    while levels[-1].n > opts.coarsest_n and len(levels) < opts.max_levels:
        cur = levels[-1]
        cmap, nc = heavy_pin_matching(cur, max_w, rng,
                                      max_edge_size=opts.max_edge_size,
                                      ctx=ctx)
        if nc >= opts.stagnation * cur.n:
            break
        coarse, emap = cur.contract(cmap, nc)
        levels.append(coarse)
        cmaps.append(cmap)
        edge_maps.append(emap)
    return levels, cmaps, edge_maps


def project_masks(cmap: np.ndarray, coarse_masks: np.ndarray) -> np.ndarray:
    """Prolongate coarse masks to the fine level (unions for replication:
    each cluster member inherits the cluster's whole processor set)."""
    return np.asarray(coarse_masks, dtype=np.int64)[np.asarray(cmap,
                                                               dtype=np.int64)]


# ------------------------------------------------------------------ V-cycle

def _project_state(fine: Hypergraph, P: int, st: PartitionState,
                   cmap: np.ndarray, edge_map: np.ndarray) -> PartitionState:
    return PartitionState.from_projection(fine, P, st, cmap, edge_map)


def _refinement_schedule(n_levels: int, refine_every: int):
    """Level indices to refine at (every ``refine_every``-th, finest (0)
    always included); projection hops between consecutive stops use
    composed maps (``_compose_maps``).

    Composition is exact: ``masks[cmap_a][cmap_b] == masks[cmap_a[cmap_b]]``
    and a fine edge survives the double contraction iff both hops keep it,
    so skipped levels cost nothing and change nothing about projection
    semantics -- only where refinement runs.
    """
    stops = sorted({0} | set(range(0, n_levels - 1, max(refine_every, 1))))
    return stops


def _compose_maps(cmaps, edge_maps, lo: int, hi: int):
    """Maps from level ``lo`` straight onto level ``hi`` (lo < hi)."""
    cmap = cmaps[lo]
    emap = edge_maps[lo]
    for li in range(lo + 1, hi):
        cmap = cmaps[li][cmap]
        keep = emap >= 0
        nxt = np.full_like(emap, -1)
        nxt[keep] = edge_maps[li][emap[keep]]
        emap = nxt
    return cmap, emap


def _make_ctx(workers: int | None):
    """A ``ParallelContext`` for ``workers > 1`` (None when unavailable)."""
    if not workers or workers <= 1:
        return None
    from .parallel import ParallelContext, shm_available
    if not shm_available():
        return None
    return ParallelContext(workers)


def _fm_stop(fine: Hypergraph, st: PartitionState, P: int, eps: float,
             rng: np.random.Generator, passes: int, frontier: str | None,
             ctx, seed: int, device: str | torch.device) -> None:
    """One FM refinement stop: sharded workers + reconciliation when a
    ``ParallelContext`` is live and the level is big enough (the workers
    run the numpy frontier), the serial frontier-priced pass on
    ``device`` otherwise.  Mutates ``st`` in place."""
    if ctx is not None and not ctx.failed and fine.n >= ctx.min_nodes:
        from .parallel import parallel_refine
        parallel_refine(fine, st, P, eps, ctx, "fm", passes, seed=seed)
    else:
        fm_refine(fine, st.masks, P, eps, rng, passes=passes, state=st,
                  frontier=frontier, device=device)


def _rep_stop(fine: Hypergraph, st: PartitionState, P: int, eps: float,
              passes: int, max_replicas: int | None, frontier: str | None,
              ctx, seed: int, device: str | torch.device) -> HeuristicResult:
    """One replication refinement stop (cf. ``_fm_stop``)."""
    if ctx is not None and not ctx.failed and fine.n >= ctx.min_nodes:
        from .parallel import parallel_refine
        parallel_refine(fine, st, P, eps, ctx, "rep", passes, seed=seed,
                        max_replicas=max_replicas)
        return HeuristicResult(masks=st.masks.copy(), cost=float(st.cost))
    return replicate_local_search(fine, st.masks, P, eps,
                                  max_replicas=max_replicas,
                                  max_passes=passes, seed=seed,
                                  frontier=frontier, state=st, device=device)


def multilevel_partition(hg: Hypergraph, P: int, eps: float,
                         opts: MultilevelOptions | None = None,
                         seed: int = 0, frontier: str | None = None,
                         stats: list | None = None,
                         workers: int | None = None,
                         device: str | torch.device = "cuda"
                         ) -> HeuristicResult:
    """Non-replicating V-cycle: coarsest flat solve + per-level FM.

    Falls through to the flat heuristic when the instance is already at or
    below ``coarsest_n`` (or P exceeds the engine tables) -- on such
    instances the two paths are the same algorithm.  ``stats`` (optional
    list) receives one dict per level with projected/refined costs, which
    is how the refinement-never-increases property is tested.  ``device``
    is where the torch frontier runs (as in ``heuristic.fm_refine``).
    """
    partition_front.check_device(frontier, device)
    opts = opts or MultilevelOptions()
    if P > _MAX_P or hg.n <= opts.coarsest_n:
        # at-or-below the coarsest size the V-cycle *is* the flat
        # heuristic -- call it with its own defaults so the two paths are
        # literally identical there
        return partition_heuristic(hg, P, eps, seed=seed, frontier=frontier,
                                   device=device)
    rng = np.random.default_rng(seed)
    ctx = _make_ctx(workers)
    try:
        levels, cmaps, edge_maps = build_levels(hg, P, eps, opts, rng,
                                                ctx=ctx)
        if not cmaps:
            # matching stagnated immediately (e.g. every edge above
            # max_edge_size, or a weight cap below any pair): no coarse
            # level exists, so the V-cycle degenerates to the flat heuristic
            return partition_heuristic(hg, P, eps, seed=seed,
                                       frontier=frontier, device=device)
        res = partition_heuristic(levels[-1], P, eps,
                                  restarts=opts.restarts,
                                  seed=seed, frontier=frontier,
                                  device=device)
        st = PartitionState(levels[-1], P, masks=res.masks)
        if stats is not None:
            stats.append({"level": len(levels) - 1, "n": levels[-1].n,
                          "edges": len(levels[-1].edges),
                          "cost_projected": float(st.cost),
                          "cost_refined": float(st.cost)})
        prev = len(levels) - 1
        for li in sorted(_refinement_schedule(len(levels),
                                              opts.refine_every),
                         reverse=True):
            cmap, emap = _compose_maps(cmaps, edge_maps, li, prev)
            st = _project_state(levels[li], P, st, cmap, emap)
            prev = li
            projected = float(st.cost)
            _fm_stop(levels[li], st, P, eps, rng,
                     opts.final_fm_passes if li == 0 else opts.fm_passes,
                     frontier, ctx, seed + 101 * li, device)
            if stats is not None:
                stats.append({"level": li, "n": levels[li].n,
                              "edges": len(levels[li].edges),
                              "cost_projected": projected,
                              "cost_refined": float(st.cost)})
        return HeuristicResult(masks=st.masks.copy(), cost=float(st.cost))
    finally:
        if ctx is not None:
            ctx.close()


def partition_with_replication_multilevel(
    hg: Hypergraph,
    P: int,
    eps: float,
    mode: str = "rep",
    opts: MultilevelOptions | None = None,
    seed: int = 0,
    frontier: str | None = None,
    stats: list | None = None,
    workers: int | None = None,
    device: str | torch.device = "cuda",
):
    """Multilevel analogue of ``partition_with_replication``.

    Returns ``(base, rep)`` like the flat entry point.  Two mask streams
    ride the same level stack down:

      * **base** -- single-assignment, refined by FM at each refinement
        stop (the paper's non-replicating comparator);
      * **rep** -- replicated, seeded at the coarsest level from the base
        solution, projected as unions and refined by
        ``replicate_local_search`` at each stop.  If the projected stream
        has not already beaten the base at the finest level, a second
        replication search runs from the refined base masks and the
        cheaper wins -- a replication search never increases cost, so
        ``rep.cost <= base.cost`` by construction either way.

    The finest level finishes with the flat driver's alternation
    (primary-extract + FM + replicate, ``opts.alternations`` rounds).

    This driver is heuristic-only: the exact small-instance solve (the
    paper's base-ILP comparison) lives in ``partition_with_replication``,
    which dispatches to it *before* routing here; sizes at or below
    ``coarsest_n`` fall through to the flat heuristic driver.  ``device``
    as in ``multilevel_partition``.
    """
    partition_front.check_device(frontier, device)
    opts = opts or MultilevelOptions()
    if P > _MAX_P or hg.n <= opts.coarsest_n:
        return partition_with_replication(hg, P, eps, mode=mode,
                                          exact_node_limit=0, seed=seed,
                                          frontier=frontier, device=device)
    max_replicas = 2 if mode == "dup" else None
    rng = np.random.default_rng(seed)
    ctx = _make_ctx(workers)
    try:
        levels, cmaps, edge_maps = build_levels(hg, P, eps, opts, rng,
                                                ctx=ctx)
        if not cmaps:  # immediate stagnation: no coarse level (cf. above)
            return partition_with_replication(hg, P, eps, mode=mode,
                                              exact_node_limit=0, seed=seed,
                                              frontier=frontier,
                                              device=device)
        base_res = partition_heuristic(levels[-1], P, eps,
                                       restarts=opts.restarts, seed=seed,
                                       frontier=frontier, device=device)
        base_st = PartitionState(levels[-1], P, masks=base_res.masks)
        rep_res = replicate_local_search(levels[-1], base_res.masks.copy(),
                                         P, eps, max_replicas=max_replicas,
                                         seed=seed, frontier=frontier,
                                         device=device)
        rep_st = PartitionState(levels[-1], P, masks=rep_res.masks)
        prev = len(levels) - 1
        for li in sorted(_refinement_schedule(len(levels),
                                              opts.refine_every),
                         reverse=True):
            fine = levels[li]
            finest = li == 0
            cmap, emap = _compose_maps(cmaps, edge_maps, li, prev)
            base_st = _project_state(fine, P, base_st, cmap, emap)
            _fm_stop(fine, base_st, P, eps, rng,
                     opts.final_fm_passes if finest else opts.fm_passes,
                     frontier, ctx, seed + 101 * li, device)
            rep_st = _project_state(fine, P, rep_st, cmap, emap)
            prev = li
            projected = float(rep_st.cost)
            passes = opts.final_rep_passes if finest else opts.rep_passes
            rep = _rep_stop(fine, rep_st, P, eps, passes, max_replicas,
                            frontier, ctx, seed, device)
            if finest and rep.cost > base_st.cost - 1e-12:
                # alternation seed at the finest level: replicate from the
                # refined base masks -- only needed when the projected
                # stream did not already beat the base (guarantees
                # rep <= base)
                alt_st = PartitionState(fine, P,
                                        masks=base_st.masks.copy())
                alt = _rep_stop(fine, alt_st, P, eps, passes, max_replicas,
                                frontier, ctx, seed + li + 1, device)
                if alt.cost < rep.cost - 1e-12:
                    rep = alt
            if stats is not None:
                stats.append({"level": li, "n": fine.n,
                              "edges": len(fine.edges),
                              "cost_projected": projected,
                              "cost_refined": float(rep.cost),
                              "base_cost": float(base_st.cost)})
        base = HeuristicResult(masks=base_st.masks.copy(),
                               cost=float(base_st.cost))
        best = rep
        # flat-driver alternation at the finest level: re-run FM on the
        # primary copies, replicate again, keep while it improves (cf.
        # heuristic.py)
        for r in range(opts.alternations):
            masks = best.masks.copy()
            primary = np.array([1 << (int(m).bit_length() - 1)
                                for m in masks])
            alt_rng = np.random.default_rng(seed + r + 1)
            fm_st = PartitionState(hg, P, masks=primary.copy())
            _fm_stop(hg, fm_st, P, eps, alt_rng, opts.final_fm_passes,
                     frontier, ctx, seed + r + 1, device)
            rls_st = PartitionState(hg, P, masks=fm_st.masks.copy())
            cand = _rep_stop(hg, rls_st, P, eps, opts.final_rep_passes,
                             max_replicas, frontier, ctx, seed + r + 1,
                             device)
            if cand.cost < best.cost - 1e-12:
                best = cand
            else:
                break
        return base, best
    finally:
        if ctx is not None:
            ctx.close()

"""Multilevel DAG scheduling (acyclic V-cycle).

The flat replication stack tops out around n ~ 6000: every heuristic pass
walks all nodes/comms of the full DAG, and the baseline list scheduler
builds one superstep per topological level (depth ~ n/width for the solver
DAGs), so wall-clock grows superlinearly with n.  The paper's headline
scheduling claim -- "a sophisticated heuristic that is also applicable to
much larger workloads" (up to 175k-node DAGs) -- lives exactly in the
regime this module opens: coarse-grained scheduling via **acyclic
clustering**, the approach of Papp et al.'s multi-processor scheduling
line of work.

Pipeline (one V-cycle)::

    coarsen   acyclicity-safe clustering, alternating two vectorized
              rules over the DAG's flat edge arrays:
                * same-level heavy-edge matching -- pair nodes at the
                  same topological level that share a parent (score
                  ``mu[parent]``: co-locating them deduplicates the
                  parent's delivery) or a child (score the mean of their
                  own ``mu``); any path strictly increases the level, so
                  clusters of same-level nodes can never close a cycle;
                * funnel clustering -- attach each in-degree-1 node to
                  its unique parent's cluster (clusters grow as
                  unique-parent trees: every external in-edge enters at
                  the root, so a contracted cycle would imply a fine
                  cycle through the root);
              both under a cluster work cap (a fraction of W/P) so the
              coarse compute phases stay balanceable.
    contract  ``Dag.contract``: vectorized cross-edge collapse, boundary
              ``mu`` sums, eager acyclicity validation.
    solve     flat ``best_replicated_schedule`` (baseline list scheduling
              + hill climbing + ``advanced_heuristic``) at the coarsest
              level, where restarts are cheap.
    project   ``Schedule.from_projection``: coarse ``(processor,
              superstep)`` assignments and replica sets expand to cluster
              members, comms re-derived canonically -- bit-identical to a
              from-scratch build of the expanded schedule.
    refine    per refinement stop (every ``refine_every``-th level;
              skipped hops project through composed cluster maps): comm
              rebalancing and node moves priced through the frontier
              layer, then bounded rounds of the advanced heuristic's
              winner-commit SM/BR/SR fronts.

Cost safety: refinement only ever applies strictly improving moves, and at
or below ``coarsest_n`` the driver *is* the flat heuristic (exact-equality
fallthrough).  The ``flat_guard_n`` hedge -- run the flat path too and keep
the cheaper schedule -- is retired by default (``flat_guard_n = 0``):
with the superstep-split front in per-level refinement the pure V-cycle
matches or beats flat on every benched instance (split widens the basin
the projection lands in; the psdd circuits that used to need the hedge no
longer do), measured by the JAX package's scheduling benchmark
(``split_scale``).  Setting ``flat_guard_n``
back to a positive n restores the old cost-not-worse-than-flat hedge at
the old price of one full flat run.

Scale: coarsening's same-level scoring pass shards over node ranges
through ``partition.parallel.ParallelContext`` (``workers=`` on
``multilevel_schedule``); per-shard pair blocks concatenate to the serial
arrays byte-for-byte, so the matching -- and the whole V-cycle -- is
bit-identical for every worker count.  With the vectorized
``Schedule.from_projection`` rebuilds this takes the cycle to n = 10^6
DAGs end to end (the same benchmark's ``split_scale``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..frontier import partition_front
from ..hypergraph import Dag
from .bsp import BspInstance, Schedule
from .list_sched import (comp_rebalance_pass, dag_levels, node_move_pass,
                         rebalance_comms)
from .replication import (AdvancedOptions, advanced_heuristic,
                          best_replicated_schedule, replica_prune_pass)


@dataclasses.dataclass
class MultilevelScheduleOptions:
    """Knobs of the scheduling V-cycle (defaults tuned for sptrsv/psdd)."""

    coarsest_n: int = 1536     # stop coarsening at this many nodes
    max_levels: int = 32       # hard cap on the level stack depth
    stagnation: float = 0.9    # stop when a round shrinks less than this
    cluster_cap_frac: float = 0.01  # max cluster work, fraction of W/P
    max_fanout: int = 16       # larger child/parent groups don't score pairs
    refine_every: int = 2      # refine every k-th level (finest always)
    hc_rounds: int = 3         # rebalance+retime+node-move rounds per stop
    level_rounds: int = 1      # advanced-heuristic rounds per mid level
    final_rounds: int = 4      # advanced-heuristic rounds at the finest
    flat_guard_n: int = 0      # up to here ALSO run the flat path, keep the
    #                            cheaper schedule.  0 (default since the
    #                            split front landed) disables the
    #                            hedge -- the pure V-cycle stands on its own
    superstep_splits: bool = True  # superstep-split front in per-level
    #                            refinement (the move that retired the guard)


# --------------------------------------------------------------- coarsening

def _pair_parts(xch: np.ndarray, ch_arr: np.ndarray, xpar: np.ndarray,
                par_arr: np.ndarray, mu: np.ndarray, level: np.ndarray,
                max_fanout: int, lo: int, hi: int) -> tuple:
    """Pair-candidate blocks for group-owner nodes in ``[lo, hi)``.

    One vectorized pass over the flat CSR group arrays: all ordered pairs
    within each owner's child group (weighted by the owner's ``mu``) and
    within each owner's parent group (weighted by the pair's mean ``mu``),
    kept only when distinct and on the same level.  Returns the six
    arrays ``(cv, cu, cw, pv, pu, pw)`` -- child-group then parent-group
    ``(v, u, weight)`` blocks.

    Bit-identity contract (what lets ``parallel_pair_parts`` shard this):
    restricting ``[lo, hi)`` restricts *owners* only, and owners are
    visited in ascending id order, so concatenating shard blocks in shard
    order -- all child blocks first, then all parent blocks, exactly the
    serial append order -- reproduces the full ``(0, n)`` arrays
    byte-for-byte.  Takes raw arrays (not a ``Dag``) so pool workers can
    call it on shared-memory attaches.
    """
    out = []
    for xg, arr, per_group_mu in ((xch, ch_arr, True),
                                  (xpar, par_arr, False)):
        lens = np.diff(xg)
        sel = np.flatnonzero((lens >= 2) & (lens <= max_fanout))
        sel = sel[(sel >= lo) & (sel < hi)]
        if not len(sel):
            z = np.zeros(0, dtype=np.int64)
            out += [z, z, np.zeros(0)]
            continue
        L = lens[sel]
        L2 = L * L
        rep = np.repeat(sel, L2)
        offs = np.arange(int(L2.sum()), dtype=np.int64)
        offs -= np.repeat(np.cumsum(L2) - L2, L2)
        Lr = np.repeat(L, L2)
        base = xg[rep]
        a = arr[base + offs // Lr]
        b = arr[base + offs % Lr]
        w = (np.repeat(mu[sel], L2) if per_group_mu
             else 0.5 * (mu[a] + mu[b]))
        keep = (a != b) & (level[a] == level[b])
        out += [a[keep], b[keep], w[keep]]
    return tuple(out)


def same_level_matching(dag: Dag, level: np.ndarray, max_weight: float,
                        rng: np.random.Generator, max_fanout: int = 16,
                        ctx=None) -> tuple[np.ndarray, int]:
    """Cluster map from heavy-edge matching of same-topological-level nodes.

    Pair candidates are generated in one vectorized pass over the edge
    arrays (``_pair_parts``): all ordered pairs within each node's child
    group (scored by the shared parent's ``mu`` -- a merged pair needs the
    parent's value delivered once, not twice) and within each node's
    parent group (scored by the mean of the pair's own ``mu`` -- a merged
    pair keeps the shared consumer local to both), restricted to pairs on
    the *same* level.  Groups larger than ``max_fanout`` are skipped (hub
    nodes would expand quadratically and their pairs are weak signals
    anyway).  Every node's best partner (max score, ties to the smallest
    id) feeds a greedy sweep in random order pairing mutually free nodes
    under ``max_weight``.

    ``ctx`` (a ``partition.parallel.ParallelContext``) shards the pair
    generation over node ranges; the per-shard blocks concatenate to the
    serial arrays byte-for-byte (see ``_pair_parts``), so the returned
    ``cmap`` is bit-identical for every worker count.  The greedy sweep
    itself stays serial (it is a sequential dependence chain).

    Acyclicity: any directed path strictly increases the topological
    level, so there is never a path between two same-level nodes, and a
    cycle through the contracted graph would have to visit some cluster's
    level twice -- impossible when every edge strictly increases it.
    Returns ``(cmap, nc)``; stagnation (no pairs) returns the identity.
    """
    n = dag.n
    src, dst = dag.edge_src, dag.edge_dst
    xch = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=xch[1:])
    mu = np.asarray(dag.mu, dtype=np.float64)
    blocks = None
    if (ctx is not None and not ctx.failed and ctx.workers > 1
            and n >= ctx.min_nodes):
        from ..partition.parallel import parallel_pair_parts
        try:
            blocks = parallel_pair_parts(dag, xch, level, ctx, max_fanout)
        except Exception:
            ctx.failed = True
            blocks = None
    if blocks is None:
        blocks = [_pair_parts(xch, dst, dag.xpar, dag.par_arr, mu, level,
                              max_fanout, 0, n)]
    # serial append order: every child block, then every parent block
    v = np.concatenate([b[0] for b in blocks] + [b[3] for b in blocks])
    u = np.concatenate([b[1] for b in blocks] + [b[4] for b in blocks])
    w = np.concatenate([b[2] for b in blocks] + [b[5] for b in blocks])
    pref = np.full(n, -1, dtype=np.int64)
    if len(v):
        key = v * n + u
        order = np.argsort(key, kind="stable")
        key, w = key[order], w[order]
        first = np.ones(len(key), dtype=bool)
        first[1:] = key[1:] != key[:-1]
        starts = np.flatnonzero(first)
        score = np.add.reduceat(w, starts)
        vd, ud = key[starts] // n, key[starts] % n
        order2 = np.lexsort((ud, -score, vd))
        vd2 = vd[order2]
        lead = np.ones(len(vd2), dtype=bool)
        lead[1:] = vd2[1:] != vd2[:-1]
        pref[vd2[lead]] = ud[order2][lead]
    omega = dag.omega
    match = np.full(n, -1, dtype=np.int64)
    for v in rng.permutation(n):
        u = pref[v]
        if match[v] >= 0 or u < 0 or match[u] >= 0:
            continue
        if omega[v] + omega[u] > max_weight:
            continue
        match[v] = u
        match[u] = v
    partner = np.where(match >= 0, match, np.arange(n, dtype=np.int64))
    rep_id = np.minimum(np.arange(n, dtype=np.int64), partner)
    reps = np.unique(rep_id)
    return np.searchsorted(reps, rep_id), len(reps)


def funnel_clustering(dag: Dag, max_weight: float) -> tuple[np.ndarray, int]:
    """Cluster map attaching in-degree-1 nodes to their unique parent.

    Clusters grow as *unique-parent trees*: every attached member's only
    in-edge comes from inside its cluster, so all external in-edges enter
    at the root -- a cycle in the contracted graph would expand to a fine
    path from a tree member back to its own root, i.e. a fine cycle.
    Batch contraction is therefore acyclicity-safe.  Nodes attach in
    topological order (a parent's root is final before its children are
    visited), deterministically, under the ``max_weight`` work cap.

    This is the depth-reducing rule (chains collapse into supernodes,
    mirroring the elimination-tree structure of the sptrsv DAGs); the
    same-level matching above is the width-reducing one.
    """
    n = dag.n
    indeg = np.diff(dag.xpar)
    par0 = np.full(n, -1, dtype=np.int64)
    only = indeg == 1
    par0[only] = dag.par_arr[dag.xpar[:-1][only]]
    root = np.arange(n, dtype=np.int64)
    cw = dag.omega.astype(np.float64).copy()
    omega = dag.omega
    for v in dag.topo_order():
        u = par0[v]
        if u < 0:
            continue
        r = root[u]
        if cw[r] + omega[v] <= max_weight:
            root[v] = r
            cw[r] += omega[v]
    reps = np.unique(root)
    return np.searchsorted(reps, root), len(reps)


def build_levels(dag: Dag, P: int, opts: MultilevelScheduleOptions,
                 rng: np.random.Generator,
                 ctx=None) -> tuple[list[Dag], list[np.ndarray]]:
    """Coarsen until small/stagnant: ``(levels, cmaps)``.

    ``levels[0]`` is the input; ``cmaps[i]`` maps ``levels[i]`` onto
    ``levels[i + 1]``.  Rounds alternate funnel (depth) and same-level
    matching (width); when the preferred rule stagnates the other gets a
    try before the stack is declared final.  ``ctx`` shards the matching
    rule's scoring pass over node ranges (bit-identical result for every
    worker count; serial when ``None``).
    """
    levels, cmaps = [dag], []
    max_w = opts.cluster_cap_frac * float(dag.omega.sum()) / P
    kind = "funnel"
    while levels[-1].n > opts.coarsest_n and len(levels) < opts.max_levels:
        cur = levels[-1]
        cmap = nc = None
        for k in (kind, "level" if kind == "funnel" else "funnel"):
            if k == "funnel":
                cand, nck = funnel_clustering(cur, max_w)
            else:
                lvl = np.asarray(dag_levels(cur), dtype=np.int64)
                cand, nck = same_level_matching(cur, lvl, max_w, rng,
                                                max_fanout=opts.max_fanout,
                                                ctx=ctx)
            if nck < opts.stagnation * cur.n:
                cmap, nc, kind = cand, nck, k
                break
        if cmap is None:
            break
        levels.append(cur.contract(cmap, nc))
        cmaps.append(cmap)
        kind = "level" if kind == "funnel" else "funnel"
    return levels, cmaps


def _compose_cmaps(cmaps: list[np.ndarray], lo: int, hi: int) -> np.ndarray:
    """Cluster map from level ``lo`` straight onto level ``hi`` (lo < hi).

    Composition is exact: expanding through the composed map equals
    expanding level by level (each member inherits its transitive
    cluster's assignments either way), so skipped refinement stops change
    only where refinement runs, never what projection produces.
    """
    cmap = cmaps[lo]
    for li in range(lo + 1, hi):
        cmap = cmaps[li][cmap]
    return cmap


# ------------------------------------------------------------------ V-cycle

def _refinement_schedule(n_levels: int, refine_every: int) -> list[int]:
    """Level indices to refine at (every ``refine_every``-th; finest (0)
    always included)."""
    return sorted({0} | set(range(0, n_levels - 1, max(refine_every, 1))))


def _refine_level(sched: Schedule, finest: bool,
                  opts: MultilevelScheduleOptions, seed: int,
                  adv_opts: AdvancedOptions | None = None,
                  backend: str | None = None,
                  device: str | torch.device = "cuda") -> Schedule:
    """Refine one projected level in place (never increases the cost).

    Replica pruning first (the projection expands cluster-grain replicas
    to every member; unused ones are pure work), then hill-climbing moves
    (comm rebalancing and compute re-timing through the batched window
    fronts, node moves through ``price_node_moves``), then bounded rounds
    of the advanced replication heuristic (winner-commit SM/BR/SR fronts)
    -- the same machinery the flat stack runs, scoped to the level.  The
    window pricers run on ``backend``/``device``.
    """
    sched.prune_useless_comms()
    sched.compact()
    replica_prune_pass(sched)
    sched.prune_useless_comms()
    for r in range(opts.hc_rounds):
        improved = rebalance_comms(sched, max_passes=1, backend=backend,
                                   device=device)
        improved |= comp_rebalance_pass(sched, max_passes=2,
                                        backend=backend, device=device)
        improved |= node_move_pass(sched, seed=seed + r, backend=backend,
                                   device=device)
        improved |= replica_prune_pass(sched, max_passes=1)
        if not improved:
            break
    rounds = opts.final_rounds if finest else opts.level_rounds
    if rounds > 0:
        # caller's AdvancedOptions (pass selection, use_fronts) carry
        # through to refinement; the round budget and split toggle are
        # per-level knobs of the V-cycle
        advanced_heuristic(sched, dataclasses.replace(
            adv_opts or AdvancedOptions(), max_rounds=rounds,
            superstep_splitting=opts.superstep_splits))
    else:
        sched.prune_useless_comms()
        sched.compact()
    return sched


def multilevel_schedule(inst: BspInstance,
                        opts: MultilevelScheduleOptions | None = None,
                        adv_opts: AdvancedOptions | None = None,
                        seed: int = 0, baseline: Schedule | None = None,
                        stats: list | None = None,
                        workers: int | None = None,
                        backend: str | None = None,
                        device: str | torch.device = "cuda") -> Schedule:
    """Replication-aware multilevel scheduling V-cycle.

    Coarsens the DAG acyclically, solves the coarsest instance with the
    flat ``best_replicated_schedule`` (which runs ``advanced_heuristic``
    from both the baseline and the parallel seed), then projects and
    refines level by level.  Reachable via
    ``best_replicated_schedule(..., multilevel=True)``.

    At or below ``coarsest_n`` (or on immediate coarsening stagnation)
    the driver *is* the flat path -- exact-equality fallthrough, pinned
    by tests.  When ``flat_guard_n`` is set positive, up to that size the
    flat path also runs as a hedge and the cheaper schedule wins (see
    module docstring -- the hedge is off by default).
    ``workers > 1`` shards coarsening's matching-score pass over a
    shared-memory process pool (bit-identical result; silently serial
    where shm is unavailable).  ``stats`` (optional list) receives one
    row per refinement stop with projected/refined costs, which is how
    the refinement-never-increases property is tested, plus a
    ``flat_guard`` row when the hedge ran.  ``backend``/``device`` select
    the window pricers of every hill-climbing and refinement pass (as in
    ``list_sched.hill_climb``); coarsening and its workers stay on the
    host.
    """
    partition_front.check_device(backend, device)
    opts = opts or MultilevelScheduleOptions()
    dag = inst.dag
    if dag.n <= opts.coarsest_n:
        return best_replicated_schedule(inst, baseline=baseline,
                                        opts=adv_opts, seed=seed,
                                        backend=backend, device=device)
    rng = np.random.default_rng(seed)
    ctx = None
    if workers is not None and workers > 1:
        from ..partition.parallel import (PARALLEL_MIN_NODES,
                                          ParallelContext, shm_available)
        if dag.n >= PARALLEL_MIN_NODES and shm_available():
            ctx = ParallelContext(workers)
    try:
        levels, cmaps = build_levels(dag, inst.P, opts, rng, ctx=ctx)
    finally:
        if ctx is not None:
            ctx.close()
    if not cmaps:  # immediate stagnation: no coarse level exists
        return best_replicated_schedule(inst, baseline=baseline,
                                        opts=adv_opts, seed=seed,
                                        backend=backend, device=device)
    coarse_inst = BspInstance(levels[-1], inst.P, inst.g, inst.L)
    # coarse solve: advanced heuristic from the PARALLEL seed only.  The
    # flat best-of would often pick the sequential schedule here -- coarse
    # mu is a boundary *sum*, so coarse comm systematically overprices the
    # fine comm the canonical re-derivation actually pays -- and a
    # single-superstep coarse solution is a basin no refinement move can
    # leave (every move needs a later superstep to deliver into).
    from .list_sched import bspg_schedule, hill_climb

    par = hill_climb(bspg_schedule(coarse_inst, seed=seed), seed=seed,
                     backend=backend, device=device)
    sched = advanced_heuristic(par, adv_opts)
    if stats is not None:
        stats.append({"level": len(levels) - 1, "n": levels[-1].n,
                      "S": sched.S,
                      "cost_projected": float(sched.current_cost()),
                      "cost_refined": float(sched.current_cost())})
    prev = len(levels) - 1
    for li in sorted(_refinement_schedule(len(levels), opts.refine_every),
                     reverse=True):
        cmap = _compose_cmaps(cmaps, li, prev)
        li_inst = inst if li == 0 else BspInstance(levels[li], inst.P,
                                                   inst.g, inst.L)
        sched = Schedule.from_projection(li_inst, sched, cmap)
        prev = li
        projected = float(sched.current_cost())
        _refine_level(sched, li == 0, opts, seed + li, adv_opts=adv_opts,
                      backend=backend, device=device)
        if stats is not None:
            stats.append({"level": li, "n": levels[li].n, "S": sched.S,
                          "cost_projected": projected,
                          "cost_refined": float(sched.current_cost())})
    if 0 < dag.n <= opts.flat_guard_n:
        # hedge while the flat path is tractable: the V-cycle's reach claim
        # lives beyond this size; below it, basin differences occasionally
        # favor the flat search (e.g. replication-hungry psdd circuits), so
        # run it too and keep the cheaper schedule.  Guarantees
        # cost-not-worse wherever both paths run, at the disclosed price of
        # one flat run.
        flat = best_replicated_schedule(inst, baseline=baseline,
                                        opts=adv_opts, seed=seed,
                                        backend=backend, device=device)
        if stats is not None:
            stats.append({"flat_guard": True, "n": dag.n,
                          "flat_cost": float(flat.current_cost()),
                          "vcycle_cost": float(sched.current_cost())})
        if flat.current_cost() < sched.current_cost():
            return flat
    return sched

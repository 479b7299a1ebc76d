"""Replication heuristics for BSP schedules (paper §6.2), engine-backed.

``basic_heuristic``     -- §6.2.2: replace single communication steps by a
                           replication whenever that decreases the total cost.
``advanced_heuristic``  -- §6.2.3: iterates three larger moves until fixpoint:
    * batch replication (BR): remove at least one comm from every processor
      saturating the h-relation of a superstep, simultaneously;
    * superstep merging (SM): merge consecutive supersteps, replicating
      (recursively) the values that could not otherwise arrive in time;
    * superstep replication (SR): replicate a whole compute phase V_{p1,s}
      on another processor p2.

All moves are evaluated against the exact BSP cost; only strictly improving
moves are kept.  Between rounds the schedule is cleaned (useless comms
pruned, empty supersteps compacted), mirroring the paper's §C.2.1 remark.

The pricing mechanics run on the incremental-delta engine (``engine.py``):
the basic move is priced by a pure ``delta_replicate_for_comm`` (no
mutation at all), and the compound BR/SM trials mutate inside a
``begin()``/``commit()``/``rollback()`` transaction instead of working on a
throwaway ``Schedule.copy()``.  The SR pass goes further through the
frontier layer (``core.frontier.schedule_front``): each superstep's whole
``(s, p1, p2)`` candidate front is enumerated from one flat pass over the
compute phase and priced *purely* (failed candidates never touch the undo
log); only the winning candidate commits through a transaction.  Decisions
are tie-broken deterministically (sorted comm/compute iteration,
``(superstep, processor)`` source keys, lexicographic SR winner) so the
search trajectory is identical to the preserved full-recompute oracle in
``reference.py`` -- same final costs, O(touched-supersteps) work per trial
instead of O(n + S*P + comms).
"""
from __future__ import annotations

import dataclasses

import torch

from .bsp import EPS, INF, Schedule


# ----------------------------------------------------------- basic heuristic

def _replication_window(sched: Schedule, v: int, dst: int) -> tuple[int, int]:
    """Valid supersteps to replicate v on dst, ignoring its current comm.

    earliest: all parents present; latest: first use of v on dst.
    """
    e = sched.earliest_replication(v, dst)
    if e == INF:  # some parent never becomes available on dst
        return 1, 0
    first = sched.first_use_on(v, dst)
    hi = int(first) if first is not INF else sched.S - 1
    return int(e), min(hi, sched.S - 1)


def _best_replication_sstep(sched: Schedule, v: int, dst: int) -> tuple[int, float] | None:
    """Cheapest superstep (by compute-cost increase) to replicate v on dst."""
    lo, hi = _replication_window(sched, v, dst)
    if lo > hi:
        return None
    w = sched.inst.dag.omega[v]
    best_t, best_inc = None, INF
    for t in range(lo, hi + 1):
        cur_max = sched.work_max(t)
        inc = max(0.0, sched.work[t][dst] + w - cur_max)
        if inc < best_inc - EPS:
            best_inc, best_t = inc, t
        if inc <= EPS:
            break  # cannot do better than free
    return (best_t, best_inc) if best_t is not None else None


def try_replicate_for_comm(sched: Schedule, v: int, dst: int) -> bool:
    """Basic move: drop comm (v -> dst), replicate v on dst instead."""
    if dst in sched.assign[v]:
        return False
    cand = _best_replication_sstep(sched, v, dst)
    if cand is None:
        return False
    t, _ = cand
    if sched.delta_replicate_for_comm(v, dst, t) < -EPS:
        sched.remove_comm(v, dst)
        sched.add_comp(v, dst, t)
        return True
    return False


def basic_heuristic(sched: Schedule, max_passes: int = 50) -> Schedule:
    for _ in range(max_passes):
        improved = False
        for (v, dst) in sorted(sched.comms.keys()):
            if (v, dst) not in sched.comms:
                continue
            if try_replicate_for_comm(sched, v, dst):
                improved = True
        if not improved:
            break
    sched.prune_useless_comms()
    sched.compact()
    return sched


def replica_prune_pass(sched: Schedule, max_passes: int = 4) -> bool:
    """Inverse of the basic move: drop compute replicas, re-feeding their
    consumers by a comm from another replica when needed.

    The multilevel projection expands a replicated coarse cluster to a
    replica of *every* member, many of which serve no fine-level use --
    and no existing move ever removes a replica, so projected schedules
    would stay stuck with the inherited replication grain.  Per replica
    (node computed on more than one processor, sorted iteration):

      * no use on that processor: remove it outright (work only drops;
        validity cannot depend on an unused presence);
      * otherwise price [drop compute, add one comm from the earliest
        other replica arriving before the first use] through
        ``_delta_cells`` and apply when strictly improving.

    Repeats until a pass changes nothing (a removal can unlock its
    neighbors').  Never touches the last remaining assignment.
    """
    improved_any = False
    dag = sched.inst.dag
    for _ in range(max_passes):
        improved = False
        for v in range(dag.n):
            if len(sched.assign[v]) < 2:
                continue
            for p in sorted(sched.assign[v]):
                if len(sched.assign[v]) < 2:
                    break
                if (v, p) in sched.comms:
                    continue  # compute + incoming comm: out of scope
                if sched.src_index.get((v, p)):
                    # replica sources onward comms: dropping it would turn
                    # them into relays (source present only by receive),
                    # which the whole stack assumes never exist
                    continue
                s = sched.assign[v][p]
                uses = sched.uses_on(v, p)
                if not uses:
                    sched.remove_comp(v, p)
                    improved = improved_any = True
                    continue
                tf = min(uses) - 1
                others = [(ss, pp) for pp, ss in sched.assign[v].items()
                          if pp != p]
                s_src, src = min(others)
                if s_src > tf or tf < 0:
                    continue  # no replica early enough to feed the uses
                mu, om = dag.mu[v], dag.omega[v]
                d = sched._delta_cells([("work", s, p, -om),
                                        ("sent", tf, src, mu),
                                        ("recv", tf, p, mu)])
                if d < -EPS:
                    sched.remove_comp(v, p)
                    sched.add_comm(v, src, p, tf)
                    improved = improved_any = True
        if not improved:
            break
    return improved_any


# -------------------------------------------------------- batch replication

def batch_replication_pass(sched: Schedule) -> bool:
    """BR: per superstep, simultaneously remove one comm from every
    saturated send/recv side, replicating the carried values."""
    improved_any = False
    # bucket comms by superstep once: this pass only removes comms (at the
    # superstep being worked) and adds compute, so a bucket filtered
    # against the live dict is exactly the inline per-iteration sort
    by_t: dict[int, list] = {}
    for (v, dst), (src, t) in sched.comms.items():
        by_t.setdefault(t, []).append((v, dst, src))
    for s in range(sched.S):
        bucket = sorted(by_t.get(s, []))
        while True:
            h = sched.h_of(s)
            if h <= EPS:
                break
            comms_at_s = [e for e in bucket
                          if (e[0], e[1]) in sched.comms]
            if not comms_at_s:
                break
            sat = [("sent", p) for p in range(sched.inst.P)
                   if sched.sent[s][p] >= h - EPS] + \
                  [("recv", p) for p in range(sched.inst.P)
                   if sched.recv[s][p] >= h - EPS]
            before = sched.current_cost()
            sched.begin()
            chosen: dict[tuple[int, int], int] = {}  # (v, dst) -> src
            feasible = True
            for side, p in sat:
                # already covered by a chosen comm?
                covered = any((side == "sent" and src == p) or
                              (side == "recv" and dst == p)
                              for (v, dst), src in chosen.items())
                if covered:
                    continue
                # cheapest replication among comms on this side
                best = None
                for (v, dst, src) in comms_at_s:
                    if (v, dst) in chosen or (v, dst) not in sched.comms:
                        continue
                    if (side == "sent" and src != p) or (side == "recv" and dst != p):
                        continue
                    if dst in sched.assign[v]:
                        continue
                    cand = _best_replication_sstep(sched, v, dst)
                    if cand is None:
                        continue
                    if best is None or cand[1] < best[2]:
                        best = (v, dst, cand[1], cand[0], src)
                if best is None:
                    feasible = False
                    break
                v, dst, _, t, src = best
                sched.remove_comm(v, dst)
                sched.add_comp(v, dst, t)
                chosen[(v, dst)] = src
            if feasible and chosen and sched.current_cost() < before - EPS:
                sched.commit()
                improved_any = True
                continue  # try to shave the new maximum too
            sched.rollback()
            break
    return improved_any


# --------------------------------------------------------- superstep merging

def try_merge_with_replication(sched: Schedule, s: int) -> bool:
    """Attempt to merge superstep s+1 into s (SM), in place under a
    transaction.  Commits (and compacts) on improvement, rolls back
    otherwise; returns whether the merge was kept.

    First-improvement comparator path (``use_fronts=False``), post-prune
    accept; the mutation sequence itself lives in
    ``frontier.apply_sm_mutations``, shared with the winner-rule path and
    the oracle.
    """
    from ..frontier import apply_sm_mutations

    if s + 1 >= sched.S:
        return False
    before = sched.current_cost()
    sched.begin()
    if not apply_sm_mutations(sched, s):
        sched.rollback()
        return False
    sched.prune_useless_comms()
    if sched.current_cost() < before - EPS:
        sched.commit()
        sched.compact()
        return True
    sched.rollback()
    return False


def superstep_merge_pass(sched: Schedule,
                         use_fronts: bool = True) -> tuple[Schedule, bool]:
    """SM sweep over adjacent superstep pairs.

    Default path: price every candidate merge *purely*
    (``frontier.price_superstep_merge`` -- failed or losing candidates
    never touch the undo log) and commit **the winner** -- minimal
    pre-prune delta, ties to the smallest s -- through the transaction
    machinery, repeating until no candidate improves.  The oracle
    (``reference.superstep_merge_pass``) applies the same winner rule, so
    trajectories stay identical (bit-identical on integer weights).

    ``use_fronts=False`` keeps the pre-frontier first-improvement
    transactional sweep with its post-prune accept test (benchmark
    comparator; may visit a different local optimum).
    """
    improved = False
    if not use_fronts:
        s = 0
        while s < sched.S - 1:
            if try_merge_with_replication(sched, s):
                improved = True
                # stay at the same index: maybe merge further
            else:
                s += 1
        return sched, improved
    from ..frontier import (commit_superstep_merge, price_superstep_merge,
                            sm_front)
    while sched.S > 1:
        # one comm sort per round, bucketed by superstep, shared by every
        # candidate pricing (identical iteration to the inline sort)
        by_t: dict[int, list] = {}
        for kv in sorted(sched.comms.items()):
            by_t.setdefault(kv[1][1], []).append(kv)
        best = None
        for s in sm_front(sched):
            priced = price_superstep_merge(
                sched, s, comms_at=(by_t.get(s, []), by_t.get(s + 1, [])))
            if priced is not None and priced < -EPS:
                if best is None or priced < best[0]:
                    best = (priced, s)
        if best is None:
            break
        commit_superstep_merge(sched, best[1])
        improved = True
    return sched, improved


# -------------------------------------------------------- superstep splitting

def superstep_split_pass(sched: Schedule) -> tuple[Schedule, bool]:
    """Superstep-split sweep (the inverse of SM): per superstep, enumerate
    level-cut bipartitions of the compute phase (``frontier.split_front``),
    price every candidate *purely* (``price_superstep_split`` -- losers
    never touch the undo log) and commit **the winner** -- minimal
    pre-prune delta, ties to the smallest ``(s, cut)`` by ascending
    enumeration with a strict comparison -- through the transaction
    machinery, repeating until no candidate improves.  The oracle
    (``reference.superstep_split_pass``) applies the same winner rule, so
    trajectories stay bit-identical on integer weights.

    Escapes over-merged basins organically: where SM has collapsed an
    h-relation into one overloaded comm phase, the split re-derives the
    affected comms canonically across the two resulting phases, trading
    ``L`` against ``g * h`` -- the priced fixed point of merge + split is
    what retires the multilevel flat-path guard.
    """
    from ..frontier import (commit_superstep_split, price_superstep_split,
                            split_front)
    from .list_sched import dag_levels

    level = dag_levels(sched.inst.dag)
    improved = False
    while True:
        pre = sorted(sched.comms.items())
        best = None
        for s in range(sched.S):
            for _cut, late in split_front(sched, s, level):
                priced = price_superstep_split(sched, s, late, pre)
                if priced is not None and priced < -EPS:
                    if best is None or priced < best[0]:
                        best = (priced, s, late)
        if best is None:
            break
        commit_superstep_split(sched, best[1], best[2])
        improved = True
    return sched, improved


# ------------------------------------------------------ superstep replication

def try_superstep_replication(sched: Schedule, s: int, p1: int, p2: int) -> bool:
    """SR: replicate (the useful part of) V_{p1,s} onto p2, in place under
    a transaction.  Returns whether the replication was kept.

    First-improvement comparator path (``use_fronts=False``); the mutation
    sequence itself lives in ``frontier.apply_sr_mutations``, shared with
    the winner-rule path and the oracle.
    """
    from ..frontier import apply_sr_mutations

    nodes = [v for v in sorted(sched.comp[s][p1])
             if p2 not in sched.assign[v] and sched.has_use_on(v, p2)]
    if not nodes:
        return False
    before = sched.current_cost()
    sched.begin()
    if not apply_sr_mutations(sched, s, p1, p2, nodes):
        sched.rollback()
        return False
    sched.prune_useless_comms()
    if sched.current_cost() < before - EPS:
        sched.commit()
        return True
    sched.rollback()
    return False


def superstep_replication_pass(sched: Schedule,
                               use_fronts: bool = True) -> tuple[Schedule, bool]:
    """SR sweep over supersteps.

    Default path: per superstep, enumerate the whole ``(p1, p2)`` candidate
    front from one flat pass (``frontier.sr_front``), price every candidate
    purely (no transaction, no rollback; pruning after commit only helps),
    and commit **the winner** -- minimal priced delta, ties to the
    lexicographically smallest ``(p1, p2)`` -- through the transaction
    machinery, repeating the superstep until no candidate improves.  The
    oracle (``reference.superstep_replication_pass``) applies the same
    winner rule, so trajectories stay identical.

    ``use_fronts=False`` keeps the pre-frontier first-improvement
    transactional sweep (benchmark comparator; may visit a different local
    optimum than the winner rule).
    """
    improved = False
    P = sched.inst.P
    s = 0
    if not use_fronts:
        while s < sched.S:
            done = False
            for p1 in range(P):
                for p2 in range(P):
                    if p1 == p2:
                        continue
                    if try_superstep_replication(sched, s, p1, p2):
                        improved = done = True
                        break
                if done:
                    break
            if not done:
                s += 1
        return sched, improved
    from ..frontier import (commit_superstep_replication,
                            price_superstep_replication, sr_front)
    while s < sched.S:
        best = None
        for (p1, p2, nodes) in sr_front(sched, s):
            priced = price_superstep_replication(sched, s, p1, p2, nodes)
            if priced is not None and priced < -EPS:
                if best is None or priced < best[0]:
                    best = (priced, p1, p2, nodes)
        if best is None:
            s += 1
        else:
            commit_superstep_replication(sched, s, *best[1:])
            improved = True  # retry the same superstep with the new state
    return sched, improved


# ------------------------------------------------------------------- drivers

def best_replicated_schedule(inst, baseline: Schedule | None = None,
                             opts: "AdvancedOptions | None" = None,
                             seed: int = 0, multilevel: bool = False,
                             ml_opts=None, stats: list | None = None,
                             workers: int | None = None,
                             backend: str | None = None,
                             device: str | torch.device = "cuda"
                             ) -> Schedule:
    """Run the advanced heuristic from the best non-replicating schedule AND
    from the parallel list schedule.  The latter matters when the
    non-replicating optimum degenerates to few processors (e.g. the paper's
    Appendix A.1 bipartite example, where only a parallel seed gives the
    replication moves room to work); beyond-paper addition.

    ``multilevel=True`` routes through the acyclic-coarsening V-cycle
    (``multilevel.multilevel_schedule``) instead, which takes the same
    search to 100k-node DAGs; at or below its coarsest size that driver
    falls through to this flat path exactly.  ``ml_opts`` forwards a
    ``MultilevelScheduleOptions``; ``stats`` collects per-level cost rows;
    ``workers`` (> 1) shards the coarsening scoring passes over a
    process-parallel context (bit-identical results; serial where shared
    memory is unavailable).  ``backend``/``device`` select the hill
    climbers' window pricers (``list_sched.hill_climb``); the replication
    moves themselves price on the host.
    """
    from .list_sched import baseline_schedule, bspg_schedule, hill_climb

    if multilevel:
        from .multilevel import multilevel_schedule

        return multilevel_schedule(inst, opts=ml_opts, adv_opts=opts,
                                   seed=seed, baseline=baseline, stats=stats,
                                   workers=workers, backend=backend,
                                   device=device)
    if baseline is None:
        baseline = baseline_schedule(inst, seed=seed, backend=backend,
                                     device=device)
    cands = [advanced_heuristic(baseline.copy(), opts)]
    par = hill_climb(bspg_schedule(inst, seed=seed), seed=seed,
                     backend=backend, device=device)
    cands.append(advanced_heuristic(par, opts))
    return min(cands, key=lambda s: s.current_cost())


@dataclasses.dataclass
class AdvancedOptions:
    batch_replication: bool = True
    superstep_merging: bool = True
    superstep_replication: bool = True
    max_rounds: int = 8
    # False = pre-frontier first-improvement SR sweep (benchmark comparator)
    use_fronts: bool = True
    # winner-commit superstep splits right after the SM block (multilevel
    # refinement enables this so merge/split reach a priced fixed point);
    # appended last to keep positional construction stable
    superstep_splitting: bool = False


def advanced_heuristic(sched: Schedule, opts: AdvancedOptions | None = None) -> Schedule:
    opts = opts or AdvancedOptions()
    sched = basic_heuristic(sched)
    for _ in range(opts.max_rounds):
        improved = False
        # SM before BR: batch replication fills compute slack that merging
        # would otherwise exploit (ablations show SM is the bigger lever,
        # cf. paper Table 14)
        if opts.superstep_merging:
            sched, imp = superstep_merge_pass(sched,
                                              use_fronts=opts.use_fronts)
            improved |= imp
        # splits directly after merges: the two alternate to a priced
        # fixed point (every commit strictly improves, so this terminates)
        if opts.superstep_splitting:
            sched, imp = superstep_split_pass(sched)
            improved |= imp
        if opts.batch_replication:
            improved |= batch_replication_pass(sched)
        if opts.superstep_replication:
            sched, imp = superstep_replication_pass(
                sched, use_fronts=opts.use_fronts)
            improved |= imp
        # interleave the basic move as cleanup (cheap local improvements)
        before = sched.current_cost()
        sched = basic_heuristic(sched, max_passes=5)
        improved |= sched.current_cost() < before - EPS
        if not improved:
            break
    sched.prune_useless_comms()
    sched.compact()
    return sched

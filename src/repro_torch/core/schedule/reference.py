"""Seed full-recompute scheduling stack, preserved as the equivalence oracle.

This module is the pre-engine implementation: ``Schedule`` keeps numpy load
matrices and re-derives superstep costs through a dirty-set sweep, and every
compound trial move (superstep merging, superstep replication) prices itself
by ``copy()`` + mutate + compare + discard.  The engine-backed stack in
``bsp.py`` / ``replication.py`` / ``list_sched.py`` must produce *identical
final costs* on the same instances -- ``tests/test_torch_schedule.py``
holds the two paths together, and the only intended difference is
wall-clock.

To make that equivalence exact, the deliberate deviations from the seed
are deterministic tie-breaking (sorted iteration over comms/compute sets,
``(superstep, processor)`` keys for source selection) and -- since the
frontier-pricing refactor -- the SR pass's commit-the-winner rule: per
superstep the whole ``(p1, p2)`` front is priced by its *pre-prune* cost
delta and the best improving candidate commits (ties to the smallest
pair).  The engine drivers apply the same rules, so container iteration
order can never split the two search trajectories.  With integer-valued
weights (all shipped datasets) every cost comparison is exact, making the
trajectories bit-identical.

Use as a namespace: ``from repro_torch.core.schedule import reference as
ref`` and
drive ``ref.bspg_schedule`` / ``ref.hill_climb`` / ``ref.basic_heuristic`` /
``ref.advanced_heuristic`` on ``ref.Schedule`` objects.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from .bsp import EPS, INF, BspInstance  # noqa: F401  (re-exported)
# The SR mutation sequence is *decision* logic shared verbatim with the
# engine path -- one home keeps the two trajectories in lockstep (same
# decisions, independent mechanics).  What this oracle
# still checks independently is everything below the decisions: full-
# recompute numpy load rows and dirty-set costs vs the engine's top-2 /
# undo-log bookkeeping.  The SR sequence itself is cross-checked the
# other way, against the frontier's *pure* cell simulation, by the
# pricing-vs-replay property test of the JAX package's frontier tests.
from ..frontier.schedule_front import (apply_sm_mutations,
                                       apply_sr_mutations, split_front)
from .engine import apply_split_mutations


class Schedule:
    """Seed BSP schedule: numpy rows, dirty-set incremental total."""

    def __init__(self, inst: BspInstance, S: int):
        self.inst = inst
        P = inst.P
        self.S = S
        self.comp: list[list[set[int]]] = [[set() for _ in range(P)] for _ in range(S)]
        # (v, dst) -> (src, superstep)
        self.comms: dict[tuple[int, int], tuple[int, int]] = {}
        # (v, src) -> set of dsts, for O(deg) use queries
        self.src_index: dict[tuple[int, int], set[int]] = defaultdict(set)
        # v -> {p: superstep computed}  (at most one superstep per (v,p))
        self.assign: list[dict[int, int]] = [dict() for _ in range(inst.dag.n)]
        self.work = np.zeros((S, P))
        self.sent = np.zeros((S, P))
        self.recv = np.zeros((S, P))
        self._cost_arr = np.zeros(S)
        self._total = 0.0
        self._dirty: set[int] = set()

    # ------------------------------------------------------------- mutation
    def _grow(self, s: int) -> None:
        while s >= self.S:
            self.comp.append([set() for _ in range(self.inst.P)])
            self.work = np.vstack([self.work, np.zeros((1, self.inst.P))])
            self.sent = np.vstack([self.sent, np.zeros((1, self.inst.P))])
            self.recv = np.vstack([self.recv, np.zeros((1, self.inst.P))])
            self._cost_arr = np.append(self._cost_arr, 0.0)
            self.S += 1

    def add_comp(self, v: int, p: int, s: int) -> None:
        self._grow(s)
        assert p not in self.assign[v], f"node {v} already on proc {p}"
        self.comp[s][p].add(v)
        self.assign[v][p] = s
        self.work[s, p] += self.inst.dag.omega[v]
        self._dirty.add(s)

    def remove_comp(self, v: int, p: int) -> None:
        s = self.assign[v].pop(p)
        self.comp[s][p].discard(v)
        self.work[s, p] -= self.inst.dag.omega[v]
        self._dirty.add(s)

    def add_comm(self, v: int, src: int, dst: int, s: int) -> None:
        self._grow(s)
        assert (v, dst) not in self.comms
        self.comms[(v, dst)] = (src, s)
        self.src_index[(v, src)].add(dst)
        mu = self.inst.dag.mu[v]
        self.sent[s, src] += mu
        self.recv[s, dst] += mu
        self._dirty.add(s)

    def remove_comm(self, v: int, dst: int) -> None:
        src, s = self.comms.pop((v, dst))
        self.src_index[(v, src)].discard(dst)
        mu = self.inst.dag.mu[v]
        self.sent[s, src] -= mu
        self.recv[s, dst] -= mu
        self._dirty.add(s)

    def move_comm(self, v: int, dst: int, new_s: int) -> None:
        src, _ = self.comms[(v, dst)]
        self.remove_comm(v, dst)
        self.add_comm(v, src, dst, new_s)

    # ------------------------------------------------------------- presence
    def compute_sstep(self, v: int, p: int) -> float:
        return self.assign[v].get(p, INF)

    def recv_sstep(self, v: int, p: int) -> float:
        c = self.comms.get((v, p))
        return c[1] if c is not None else INF

    def present_at(self, v: int, p: int, s: int) -> bool:
        """Usable on p in superstep s (for compute or as a send source)."""
        return self.compute_sstep(v, p) <= s or self.recv_sstep(v, p) < s

    # ----------------------------------------------------------------- cost
    def superstep_cost(self, s: int) -> float:
        c = float(self.work[s].max())
        h = max(self.sent[s].max(), self.recv[s].max())
        if h > EPS:
            c += self.inst.L + self.inst.g * h
        return c

    def cost(self) -> float:
        return sum(self.superstep_cost(s) for s in range(self.S))

    def current_cost(self) -> float:
        """Incrementally maintained total cost (O(dirty supersteps))."""
        for s in self._dirty:
            c = self.superstep_cost(s)
            self._total += c - self._cost_arr[s]
            self._cost_arr[s] = c
        self._dirty.clear()
        return self._total

    # ------------------------------------------------------ use / windows
    def uses_on(self, v: int, p: int) -> list[int]:
        """Supersteps where v's value is consumed on p (compute or send)."""
        out = []
        for c in self.inst.dag.children[v]:
            s = self.assign[c].get(p)
            if s is not None:
                out.append(s)
        for dst in self.src_index.get((v, p), ()):
            out.append(self.comms[(v, dst)][1])
        return sorted(out)

    def first_use_on(self, v: int, p: int) -> float:
        u = self.uses_on(v, p)
        return u[0] if u else INF

    def earliest_replication(self, v: int, p: int) -> float:
        """First superstep where all parents of v are present on p."""
        e = 0
        for u in self.inst.dag.parents[v]:
            cs = self.compute_sstep(u, p)
            rs = self.recv_sstep(u, p)
            e = max(e, min(cs, rs + 1))
        return e

    # -------------------------------------------------------------- cleanup
    def prune_useless_comms(self) -> int:
        """Drop comms whose value is never used on the destination after
        arrival (can appear after replication rewrites)."""
        drop = []
        for (v, dst), (src, s) in self.comms.items():
            cs = self.compute_sstep(v, dst)
            needed = any(t > s and not cs <= t for t in self.uses_on(v, dst))
            if not needed:
                drop.append((v, dst))
        for key in drop:
            self.remove_comm(*key)
        return len(drop)

    def compact(self) -> None:
        """Remove empty supersteps (no compute and no comm anywhere)."""
        keep = [s for s in range(self.S)
                if self.work[s].any() or self.sent[s].any() or self.recv[s].any()
                or any(self.comp[s][p] for p in range(self.inst.P))]
        remap = {old: new for new, old in enumerate(keep)}
        self.comp = [self.comp[s] for s in keep]
        self.work = self.work[keep]
        self.sent = self.sent[keep]
        self.recv = self.recv[keep]
        self.S = len(keep)
        self._cost_arr = np.array([self.superstep_cost(s) for s in range(self.S)])
        self._total = float(self._cost_arr.sum())
        self._dirty = set()
        for v in range(self.inst.dag.n):
            self.assign[v] = {p: remap[s] for p, s in self.assign[v].items()}
        self.comms = {k: (src, remap[s]) for k, (src, s) in self.comms.items()}

    def copy(self) -> "Schedule":
        other = Schedule.__new__(Schedule)
        other.inst = self.inst
        other.S = self.S
        other.comp = [[set(ps) for ps in row] for row in self.comp]
        other.comms = dict(self.comms)
        other.src_index = defaultdict(set)
        for k, dsts in self.src_index.items():
            if dsts:
                other.src_index[k] = set(dsts)
        other.assign = [dict(a) for a in self.assign]
        other.work = self.work.copy()
        other.sent = self.sent.copy()
        other.recv = self.recv.copy()
        other._cost_arr = self._cost_arr.copy()
        other._total = self._total
        other._dirty = set(self._dirty)
        return other

    def stats(self) -> dict:
        return {
            "cost": self.cost(),
            "supersteps": self.S,
            "comms": len(self.comms),
            "replicas": sum(len(a) - 1 for a in self.assign if len(a) > 1),
        }


# ==========================================================================
# Replication heuristics (seed mechanics: mutate + compare + revert / copy)
# ==========================================================================

def _replication_window(sched: Schedule, v: int, dst: int) -> tuple[int, int]:
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
        cur_max = sched.work[t].max()
        inc = max(0.0, sched.work[t, dst] + w - cur_max)
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
    src, s_comm = sched.comms[(v, dst)]
    before = sched.current_cost()
    sched.remove_comm(v, dst)
    sched.add_comp(v, dst, t)
    after = sched.current_cost()
    if after < before - EPS:
        return True
    sched.remove_comp(v, dst)
    sched.add_comm(v, src, dst, s_comm)
    sched.current_cost()
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


def batch_replication_pass(sched: Schedule) -> bool:
    """BR: per superstep, simultaneously remove one comm from every
    saturated send/recv side, replicating the carried values."""
    improved_any = False
    for s in range(sched.S):
        while True:
            h = max(sched.sent[s].max(), sched.recv[s].max())
            if h <= EPS:
                break
            comms_at_s = sorted((v, dst, src)
                                for (v, dst), (src, t) in sched.comms.items()
                                if t == s)
            if not comms_at_s:
                break
            sat = [("sent", p) for p in range(sched.inst.P)
                   if sched.sent[s, p] >= h - EPS] + \
                  [("recv", p) for p in range(sched.inst.P)
                   if sched.recv[s, p] >= h - EPS]
            before = sched.current_cost()
            log: list = []
            chosen: set[tuple[int, int]] = set()
            feasible = True
            for side, p in sat:
                # already covered by a chosen comm?
                covered = any((side == "sent" and src == p) or
                              (side == "recv" and dst == p)
                              for (v, dst) in chosen
                              for (vv, dd, src) in comms_at_s
                              if (vv, dd) == (v, dst))
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
                s_comm = sched.comms[(v, dst)][1]
                sched.remove_comm(v, dst)
                sched.add_comp(v, dst, t)
                log.append((v, dst, src, s_comm))
                chosen.add((v, dst))
            after = sched.current_cost()
            if feasible and chosen and after < before - EPS:
                improved_any = True
                continue  # try to shave the new maximum too
            for (v, dst, src, s_comm) in reversed(log):
                sched.remove_comp(v, dst)
                sched.add_comm(v, src, dst, s_comm)
            sched.current_cost()
            break
    return improved_any


def try_merge_with_replication(sched: Schedule, s: int) -> float | None:
    """Price SM (merge superstep s+1 into s) on a copy.

    Returns the pre-prune cost delta (the quantity both search paths rank
    winners by; pruning after a commit only lowers it further), or None
    when the merge is infeasible.  The mutation sequence is the shared
    ``frontier.apply_sm_mutations``; the engine path prices the same
    sequence purely (``frontier.price_superstep_merge``).
    """
    if s + 1 >= sched.S:
        return None
    trial = sched.copy()
    if not apply_sm_mutations(trial, s):
        return None
    return trial.current_cost() - sched.current_cost()


def superstep_merge_pass(sched: Schedule) -> tuple[Schedule, bool]:
    """SM sweep, winner rule: price every adjacent-pair merge and commit
    the best improving candidate (ties to the smallest s), repeating until
    dry -- the oracle mirror of the engine path's frontier-based pass."""
    improved = False
    while sched.S > 1:
        best = None
        for s in range(sched.S - 1):
            priced = try_merge_with_replication(sched, s)
            if priced is not None and priced < -EPS:
                if best is None or priced < best[0]:
                    best = (priced, s)
        if best is None:
            break
        ok = apply_sm_mutations(sched, best[1])
        assert ok, "priced SM became infeasible"
        sched.prune_useless_comms()
        sched.current_cost()
        sched.compact()
        improved = True
    return sched, improved


def try_split(sched: Schedule, s: int, late) -> float | None:
    """Price a superstep split (``late`` pairs delay into a new superstep
    s+1) on a copy.

    Returns the pre-prune cost delta (the quantity both search paths rank
    winners by; pruning after a commit only lowers it further), or None
    when the candidate is infeasible.  The mutation sequence is the shared
    ``engine.apply_split_mutations``; the engine path prices the same
    sequence purely (``frontier.price_superstep_split``).
    """
    trial = sched.copy()
    if not apply_split_mutations(trial, s, late):
        return None
    return trial.current_cost() - sched.current_cost()


def superstep_split_pass(sched: Schedule) -> tuple[Schedule, bool]:
    """Superstep-split sweep, winner rule: price every level-cut
    bipartition of every superstep's compute phase and commit the best
    improving candidate (ties to the smallest ``(s, cut)`` by ascending
    enumeration with a strict comparison), repeating until dry -- the
    oracle mirror of the engine path's frontier-based pass."""
    level = dag_levels(sched.inst.dag)
    improved = False
    while True:
        best = None
        for s in range(sched.S):
            for _cut, late in split_front(sched, s, level):
                priced = try_split(sched, s, late)
                if priced is not None and priced < -EPS:
                    if best is None or priced < best[0]:
                        best = (priced, s, late)
        if best is None:
            break
        ok = apply_split_mutations(sched, best[1], best[2])
        assert ok, "priced split became infeasible"
        sched.prune_useless_comms()
        sched.current_cost()
        sched.compact()
        improved = True
    return sched, improved


def try_superstep_replication(sched: Schedule, s: int, p1: int, p2: int) -> float | None:
    """Price SR (replicate the useful part of V_{p1,s} onto p2) on a copy.

    Returns the pre-prune cost delta (the quantity both search paths rank
    winners by; pruning after a commit only lowers it further), or None
    when the candidate is empty or infeasible.
    """
    nodes = [v for v in sorted(sched.comp[s][p1])
             if p2 not in sched.assign[v] and sched.uses_on(v, p2)]
    if not nodes:
        return None
    trial = sched.copy()
    if not apply_sr_mutations(trial, s, p1, p2, nodes):
        return None
    return trial.current_cost() - sched.current_cost()


def superstep_replication_pass(sched: Schedule) -> tuple[Schedule, bool]:
    """SR sweep, winner rule: per superstep, price the whole (p1, p2) front
    and commit the best improving candidate (ties to the lexicographically
    smallest pair), repeating the superstep until dry -- the oracle mirror
    of the engine path's frontier-based pass."""
    improved = False
    P = sched.inst.P
    s = 0
    while s < sched.S:
        best = None
        for p1 in range(P):
            for p2 in range(P):
                if p1 == p2:
                    continue
                priced = try_superstep_replication(sched, s, p1, p2)
                if priced is not None and priced < -EPS:
                    if best is None or priced < best[0]:
                        best = (priced, p1, p2)
        if best is None:
            s += 1
            continue
        _, p1, p2 = best
        nodes = [v for v in sorted(sched.comp[s][p1])
                 if p2 not in sched.assign[v] and sched.uses_on(v, p2)]
        ok = apply_sr_mutations(sched, s, p1, p2, nodes)
        assert ok, "priced SR became infeasible"
        sched.prune_useless_comms()
        sched.current_cost()
        improved = True
    return sched, improved


@dataclasses.dataclass
class AdvancedOptions:
    batch_replication: bool = True
    superstep_merging: bool = True
    superstep_replication: bool = True
    max_rounds: int = 8
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
            sched, imp = superstep_merge_pass(sched)
            improved |= imp
        # splits directly after merges (same alternation as the engine path)
        if opts.superstep_splitting:
            sched, imp = superstep_split_pass(sched)
            improved |= imp
        if opts.batch_replication:
            improved |= batch_replication_pass(sched)
        if opts.superstep_replication:
            sched, imp = superstep_replication_pass(sched)
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


# ==========================================================================
# Non-replicating baseline (seed list scheduling + hill climbing)
# ==========================================================================

def dag_levels(dag) -> list[int]:
    level = [0] * dag.n
    for v in dag.topo_order():
        for c in dag.children[v]:
            level[c] = max(level[c], level[v] + 1)
    return level


def bspg_schedule(inst: BspInstance, seed: int = 0, slack: float = 0.15) -> Schedule:
    dag, P = inst.dag, inst.P
    rng = np.random.default_rng(seed)
    level = dag_levels(dag)
    n_levels = max(level) + 1 if dag.n else 1
    by_level: list[list[int]] = [[] for _ in range(n_levels)]
    for v in range(dag.n):
        by_level[level[v]].append(v)

    sched = Schedule(inst, n_levels)
    owner = np.full(dag.n, -1, dtype=np.int64)
    for s, nodes in enumerate(by_level):
        total_w = float(sum(dag.omega[v] for v in nodes))
        cap = (1.0 + slack) * total_w / P + float(dag.omega.max())
        load = np.zeros(P)
        # heavy nodes first; random tiebreak
        nodes = sorted(nodes, key=lambda v: (-dag.omega[v], rng.random()))
        for v in nodes:
            # affinity: communication we avoid by co-locating with parents
            aff = np.zeros(P)
            for u in dag.parents[v]:
                aff[owner[u]] += inst.g * dag.mu[u]
            score = aff - load * (total_w / P / max(cap, 1e-9))
            # prefer procs under the cap
            order = np.argsort(-score)
            chosen = next((p for p in order if load[p] + dag.omega[v] <= cap),
                          int(np.argmin(load)))
            sched.add_comp(v, int(chosen), s)
            owner[v] = chosen
            load[chosen] += dag.omega[v]

    derive_comms(sched)
    return sched


def derive_comms(sched: Schedule) -> None:
    """(Re)build the canonical comm set for the current assignment.

    Delegates to the shared (vectorized) ``engine.canonical_comm_plan``;
    the plan's sorted-(value, dst) row order is exactly the
    ``sorted(first_use.items())`` add order of the seed's scalar loop,
    which survives as ``engine._canonical_comm_plan_scalar`` and pins the
    vectorized output bit-for-bit.
    """
    from .engine import canonical_comm_plan
    for (v, dst) in list(sched.comms.keys()):
        sched.remove_comm(v, dst)
    for (v, src, p, t) in canonical_comm_plan(sched.inst.dag, sched.assign):
        sched.add_comm(v, src, p, t)


def _comm_window(sched: Schedule, v: int, dst: int) -> tuple[int, int]:
    src, _ = sched.comms[(v, dst)]
    lo = sched.assign[v][src]  # computed on src at lo -> can send from lo on
    first = sched.first_use_on(v, dst)
    hi = int(first) - 1 if first is not INF else sched.S - 1
    return lo, hi


def rebalance_comms(sched: Schedule, max_passes: int = 4) -> bool:
    """Move each comm within its window to the cheapest superstep."""
    improved_any = False
    for _ in range(max_passes):
        improved = False
        for (v, dst) in sorted(sched.comms.keys()):
            src, s = sched.comms[(v, dst)]
            lo, hi = _comm_window(sched, v, dst)
            if hi < lo:
                continue
            base = sched.current_cost()
            best_s, best_c = s, base
            for t in range(lo, hi + 1):
                if t == s:
                    continue
                sched.move_comm(v, dst, t)
                c = sched.current_cost()
                if c < best_c - EPS:
                    best_c, best_s = c, t
                sched.move_comm(v, dst, s)
                sched.current_cost()
            if best_s != s:
                sched.move_comm(v, dst, best_s)
                sched.current_cost()
                improved = improved_any = True
        if not improved:
            break
    return improved_any


def try_node_move(sched: Schedule, v: int, q: int) -> bool:
    """Move node v (single assignment) to processor q, same superstep."""
    assert len(sched.assign[v]) == 1
    (p, s), = sched.assign[v].items()
    if q == p:
        return False
    dag = sched.inst.dag
    # parents must be present on q at s
    for u in dag.parents[v]:
        if not sched.present_at(u, q, s):
            return False
    # v must not be used on p in superstep s itself (comm can't arrive in time)
    uses_p = [t for t in sched.uses_on(v, p)]
    if uses_p and min(uses_p) <= s:
        return False
    before = sched.current_cost()
    log: list = []  # (fn, args) inverse ops
    # retarget outgoing comms from p to q
    for dst in sorted(sched.src_index.get((v, p), ())):
        _, t = sched.comms[(v, dst)]
        sched.remove_comm(v, dst)
        log.append(("add_comm", (v, p, dst, t)))
        if dst != q:
            sched.add_comm(v, q, dst, t)
            log.append(("remove_comm", (v, dst)))
    # drop incoming comm to q (v becomes local there)
    if (v, q) in sched.comms:
        src0, t0 = sched.comms[(v, q)]
        sched.remove_comm(v, q)
        log.append(("add_comm", (v, src0, q, t0)))
    sched.remove_comp(v, p)
    log.append(("add_comp", (v, p, s)))
    sched.add_comp(v, q, s)
    log.append(("remove_comp", (v, q)))
    # consumers on p now need a comm
    if uses_p:
        t_first = min(uses_p)
        sched.add_comm(v, q, p, t_first - 1)
        log.append(("remove_comm", (v, p)))
    after = sched.current_cost()
    if after < before - EPS:
        return True
    for fn, args in reversed(log):
        getattr(sched, fn)(*args)
    sched.current_cost()
    return False


def node_move_pass(sched: Schedule, seed: int = 0) -> bool:
    rng = np.random.default_rng(seed)
    improved = False
    P = sched.inst.P
    for v in rng.permutation(sched.inst.dag.n):
        if len(sched.assign[v]) != 1:
            continue
        for q in range(P):
            if try_node_move(sched, int(v), q):
                improved = True
                break
    return improved


def try_merge_no_repl(sched: Schedule, s: int) -> bool:
    """Merge superstep s+1 into s if feasible without replication."""
    if s + 1 >= sched.S:
        return False
    P = sched.inst.P
    # comms at s whose value is used at s+1 must be movable to s-1
    moves = []
    for (v, dst), (src, t) in sorted(sched.comms.items()):
        if t != s:
            continue
        uses = [x for x in sched.uses_on(v, dst)
                if x > t and not sched.compute_sstep(v, dst) <= x]
        if uses and min(uses) == s + 1:
            if sched.assign[v][src] <= s - 1 and s - 1 >= 0:
                moves.append((v, dst))
            else:
                return False  # would need replication
    before = sched.current_cost()
    log: list = []
    for (v, dst) in moves:
        _, t = sched.comms[(v, dst)]
        sched.move_comm(v, dst, s - 1)
        log.append(("move_comm", (v, dst, t)))
    # shift compute s+1 -> s
    for p in range(P):
        for v in sorted(sched.comp[s + 1][p]):
            sched.remove_comp(v, p)
            sched.add_comp(v, p, s)
            log.append(("__move_comp_back", (v, p, s + 1)))
    # shift comms at s+1 -> s
    for (v, dst), (src, t) in sorted(sched.comms.items()):
        if t == s + 1:
            sched.move_comm(v, dst, s)
            log.append(("move_comm", (v, dst, s + 1)))
    after = sched.current_cost()
    if after < before - EPS:
        return True
    for fn, args in reversed(log):
        if fn == "__move_comp_back":
            v, p, old_s = args
            sched.remove_comp(v, p)
            sched.add_comp(v, p, old_s)
        else:
            getattr(sched, fn)(*args)
    sched.current_cost()
    return False


def merge_pass(sched: Schedule) -> bool:
    improved = False
    s = 0
    while s < sched.S - 1:
        if not try_merge_no_repl(sched, s):
            s += 1
        else:
            improved = True
    if improved:
        sched.compact()
    return improved


def hill_climb(sched: Schedule, rounds: int = 6, seed: int = 0) -> Schedule:
    for r in range(rounds):
        improved = False
        improved |= rebalance_comms(sched)
        improved |= node_move_pass(sched, seed=seed + r)
        improved |= merge_pass(sched)
        if not improved:
            break
    sched.compact()
    return sched


def sequential_schedule(inst: BspInstance) -> Schedule:
    """Everything on processor 0, one superstep, zero communication."""
    sched = Schedule(inst, 1)
    for v in inst.dag.topo_order():
        sched.add_comp(v, 0, 0)
    return sched


def baseline_schedule(inst: BspInstance, seed: int = 0, hc_rounds: int = 6,
                      restarts: int = 1) -> Schedule:
    """Strong non-replicating baseline: best of list-scheduling restarts
    (each followed by hill climbing) and the sequential schedule."""
    best = sequential_schedule(inst)
    for r in range(restarts):
        sched = bspg_schedule(inst, seed=seed + r)
        sched = hill_climb(sched, rounds=hc_rounds, seed=seed + r)
        if sched.current_cost() < best.current_cost() - EPS:
            best = sched
    return best

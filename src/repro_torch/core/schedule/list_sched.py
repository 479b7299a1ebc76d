"""Non-replicating baseline scheduler (the role of BSPg + hill climbing in
Papp et al. [44], which the paper uses as the starting point in §6.1).

``bspg_schedule``  -- wavefront list scheduling: nodes are placed level by
level (ASAP topological depth); within a level, nodes are assigned greedily
to the processor with the best (communication-affinity - load) score, under
a per-level balance cap.  Communications are derived canonically afterwards:
one comm per (value, consumer-processor), sourced at the computing processor
and placed at the latest valid superstep (first use - 1).

``hill_climb``     -- local search on the non-replicating schedule:
  * comm re-placement within its valid window (h-relation balancing),
  * node moves to a different processor in the same superstep,
  * superstep merging when feasible *without* replication.

All moves are priced through the incremental-delta engine: comm
re-placement uses the pure ``delta_move_comm``, node moves price their
whole target front at once through the frontier layer
(``core.frontier.price_node_moves`` -- bit-equal to per-target
``delta_node_move``, so the first-feasible-improving-q decision is
unchanged; ``use_fronts=False`` keeps the per-target loop), and the
no-replication merge runs inside a ``begin()``/``rollback()`` transaction.
Tie-breaking is deterministic (sorted iteration, ``(superstep, processor)``
keys), matching ``reference.py`` decision-for-decision.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hypergraph import Dag
from .bsp import EPS, INF, BspInstance, Schedule


def dag_levels(dag: Dag) -> list[int]:
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
    """(Re)build the canonical comm set for the current assignment (one
    comm per (value, proc), earliest-replica source, latest valid
    superstep -- the shared ``engine.canonical_comm_plan`` rule)."""
    from .engine import canonical_comm_plan

    for (v, dst) in list(sched.comms.keys()):
        sched.remove_comm(v, dst)
    for (v, src, p, t) in canonical_comm_plan(sched.inst.dag, sched.assign):
        sched.add_comm(v, src, p, t)


# --------------------------------------------------------------------------
# Hill climbing (non-replicating moves)
# --------------------------------------------------------------------------

def _comm_window(sched: Schedule, v: int, dst: int) -> tuple[int, int]:
    src, _ = sched.comms[(v, dst)]
    lo = sched.assign[v][src]  # computed on src at lo -> can send from lo on
    first = sched.first_use_on(v, dst)
    hi = int(first) - 1 if first is not INF else sched.S - 1
    return lo, hi


_COMM_FRONT_MIN_WINDOW = 12


def _best_window_move(sched, s: int, lo: int, hi: int, deltas,
                      scalar_delta) -> tuple[int, float]:
    """Shared argmin rule of the window-rebalancing sweeps: ascending t,
    skip the current superstep, accept only strict EPS improvements over
    the running best (ties to the earliest superstep).  ``deltas`` is the
    batched front (or None for the scalar path, pricing via
    ``scalar_delta(t)``) -- one home for the decision rule keeps the two
    paths identical by construction."""
    best_s, best_d = s, 0.0
    for t in range(lo, hi + 1):
        if t == s:
            continue
        d = deltas[t - lo] if deltas is not None else scalar_delta(t)
        if d < best_d - EPS:
            best_d, best_s = d, t
    return best_s, best_d


def rebalance_comms(sched: Schedule, max_passes: int = 4,
                    use_fronts: bool = True,
                    backend: str | None = None,
                    device: str | torch.device = "cuda") -> bool:
    """Move each comm within its window to the cheapest superstep.

    Long windows (at least ``_COMM_FRONT_MIN_WINDOW`` supersteps -- the
    common case after multilevel projection, where a value's producer and
    first use can sit a whole wavefront apart) price through the batched
    ``frontier.price_comm_moves`` front, bit-equal to per-superstep
    ``delta_move_comm``; short windows keep the scalar loop (numpy
    dispatch would dominate).  Decisions are identical on both paths.
    ``backend="torch"`` (the default backend; on integer-weight instances)
    routes long windows through the device-resident pricer on ``device``
    (``frontier.device_windows``) instead -- same deltas bit-for-bit,
    ``_best_window_move`` stays the single decision home.
    """
    from ..frontier import device_windows, price_comm_moves

    win = device_windows(sched, backend, device)
    improved_any = False
    for _ in range(max_passes):
        improved = False
        for (v, dst) in sorted(sched.comms.keys()):
            src, s = sched.comms[(v, dst)]
            lo, hi = _comm_window(sched, v, dst)
            if hi < lo:
                continue
            if use_fronts and hi - lo + 1 >= _COMM_FRONT_MIN_WINDOW:
                ts = np.arange(lo, hi + 1)
                deltas = (win.price_comm_moves(v, dst, ts)
                          if win is not None
                          else price_comm_moves(sched, v, dst, ts))
            else:
                deltas = None
            best_s, _ = _best_window_move(
                sched, s, lo, hi, deltas,
                lambda t: sched.delta_move_comm(v, dst, t))
            if best_s != s:
                sched.move_comm(v, dst, best_s)
                if win is not None:
                    win.mark_dirty()
                improved = improved_any = True
        if not improved:
            break
    return improved_any


def _comp_window(sched: Schedule, v: int, p: int) -> tuple[int, int]:
    """Feasible supersteps to compute v on p, keeping everything else
    fixed: earliest = all parents present (same-superstep local parents
    count), latest = first use of v on p (compute uses allow the same
    superstep, send uses require presence at the send)."""
    lo = sched.earliest_replication(v, p)
    if lo == INF:
        return 1, 0
    uses = sched.uses_on(v, p)
    hi = min(uses) if uses else sched.S - 1
    return int(lo), min(int(hi), sched.S - 1)


def comp_rebalance_pass(sched: Schedule, max_passes: int = 4,
                        use_fronts: bool = True,
                        backend: str | None = None,
                        device: str | torch.device = "cuda") -> bool:
    """Re-time each single-assigned node within its feasible superstep
    window on its own processor (work-max balancing across supersteps).

    The complement of ``rebalance_comms`` for the compute phase: the
    multilevel projection inherits the coarse superstep structure, which
    packs cluster chains into few supersteps -- same-superstep node moves
    cannot spread them (a chain member's parent is computed in the same
    superstep, so no other processor can host it), but sliding the chain
    tail into later slack and iterating unrolls it across supersteps.
    Windows price through the batched ``frontier.price_comp_moves`` when
    long, the scalar two-cell ``_delta_cells`` fold otherwise -- bit-equal,
    so both paths take identical decisions.  Only strictly improving
    re-timings are applied.

    Passes alternate traversal direction: reverse topological order first
    (a node is visited before its parents, so a chain pushed into later
    slack unrolls end-to-end within ONE pass -- each member's window has
    already been extended by its successor's move), then forward (pulling
    chains into earlier slack), and so on.  ``backend`` and ``device`` as
    in ``rebalance_comms``.
    """
    from ..frontier import device_windows, price_comp_moves

    win = device_windows(sched, backend, device)
    improved_any = False
    dag = sched.inst.dag
    topo = dag.topo_order()
    for pno in range(max_passes):
        improved = False
        for v in (reversed(topo) if pno % 2 == 0 else topo):
            if len(sched.assign[v]) != 1:
                continue
            (p, s), = sched.assign[v].items()
            if (v, p) in sched.comms:
                continue  # compute + incoming comm on one proc: out of scope
            lo, hi = _comp_window(sched, v, p)
            if hi <= lo and s == lo:
                continue
            om = dag.omega[v]
            if use_fronts and hi - lo + 1 >= _COMM_FRONT_MIN_WINDOW:
                ts = np.arange(lo, hi + 1)
                deltas = (win.price_comp_moves(v, p, ts) if win is not None
                          else price_comp_moves(sched, v, p, ts))
            else:
                deltas = None
            best_t, _ = _best_window_move(
                sched, s, lo, hi, deltas,
                lambda t: sched._delta_cells([("work", s, p, -om),
                                              ("work", t, p, om)]))
            if best_t != s:
                sched.remove_comp(v, p)
                sched.add_comp(v, p, best_t)
                if win is not None:
                    win.mark_dirty()
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
    uses_p = sched.uses_on(v, p)
    if uses_p and min(uses_p) <= s:
        return False
    if sched.delta_node_move(v, q) < -EPS:
        sched.apply_node_move(v, q)
        return True
    return False


def node_move_pass(sched: Schedule, seed: int = 0,
                   use_fronts: bool = True,
                   backend: str | None = None,
                   device: str | torch.device = "cuda") -> bool:
    """One pass of node moves: first feasible improving target wins.

    Default path prices every target processor in one frontier front
    (``price_node_moves``); ``use_fronts=False`` keeps the pre-frontier
    per-target ``try_node_move`` loop.  ``backend="torch"`` folds the
    move's per-superstep (P x P) delta matrices on ``device`` when many
    supersteps are touched (``frontier.device_windows``).  All paths take
    identical decisions.
    """
    rng = np.random.default_rng(seed)
    improved = False
    P = sched.inst.P
    if not use_fronts:
        for v in rng.permutation(sched.inst.dag.n):
            if len(sched.assign[v]) != 1:
                continue
            for q in range(P):
                if try_node_move(sched, int(v), q):
                    improved = True
                    break
        return improved
    from ..frontier import device_windows, node_move_targets, price_node_moves
    win = device_windows(sched, backend, device)
    for v in rng.permutation(sched.inst.dag.n):
        v = int(v)
        if len(sched.assign[v]) != 1:
            continue
        feas = node_move_targets(sched, v)
        nq = sum(feas)
        if nq == 0:
            continue
        if nq == 1:  # batching one candidate would just pay numpy dispatch
            q = feas.index(True)
            if sched.delta_node_move(v, q) < -EPS:
                sched.apply_node_move(v, q)
                if win is not None:
                    win.mark_dirty()
                improved = True
            continue
        deltas = (win.price_node_moves(v) if win is not None
                  else price_node_moves(sched, v))
        for q in range(P):
            if feas[q] and deltas[q] < -EPS:
                sched.apply_node_move(v, q)
                if win is not None:
                    win.mark_dirty()
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
    sched.begin()
    for (v, dst) in moves:
        sched.move_comm(v, dst, s - 1)
    # shift compute s+1 -> s
    for p in range(P):
        for v in sorted(sched.comp[s + 1][p]):
            sched.remove_comp(v, p)
            sched.add_comp(v, p, s)
    # shift comms at s+1 -> s
    for (v, dst), (src, t) in sorted(sched.comms.items()):
        if t == s + 1:
            sched.move_comm(v, dst, s)
    if sched.current_cost() < before - EPS:
        sched.commit()
        return True
    sched.rollback()
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


def hill_climb(sched: Schedule, rounds: int = 6, seed: int = 0,
               use_fronts: bool = True,
               backend: str | None = None,
               device: str | torch.device = "cuda") -> Schedule:
    """Rounds of comm re-placement, node moves and merges until none
    improves.  ``backend``/``device`` select the window pricers (as in
    ``rebalance_comms``); every backend takes the same decisions."""
    for r in range(rounds):
        improved = False
        improved |= rebalance_comms(sched, backend=backend, device=device)
        improved |= node_move_pass(sched, seed=seed + r,
                                   use_fronts=use_fronts, backend=backend,
                                   device=device)
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
                      restarts: int = 1, backend: str | None = None,
                      device: str | torch.device = "cuda") -> Schedule:
    """Strong non-replicating baseline: best of list-scheduling restarts
    (each followed by hill climbing on ``backend``/``device``) and the
    sequential schedule (often optimal for tiny DAGs with large g, cf.
    paper §C.2.2)."""
    best = sequential_schedule(inst)
    for r in range(restarts):
        sched = bspg_schedule(inst, seed=seed + r)
        sched = hill_climb(sched, rounds=hc_rounds, seed=seed + r,
                           backend=backend, device=device)
        if sched.current_cost() < best.current_cost() - EPS:
            best = sched
    return best

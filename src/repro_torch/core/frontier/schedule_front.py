"""Batched candidate-front pricing for the BSP schedule engine.

Three fronts from the scheduling stack's hot loops:

  * **Node moves** (``list_sched.hill_climb``): ``price_node_moves`` prices
    moving a single-assignment node to *every* processor at once.  The
    move's cell changes are accumulated into per-superstep (P x P) delta
    matrices (candidate q x processor) and evaluated against flat
    per-superstep load rows -- ascending superstep order, full-row maxima
    -- which reproduces ``ScheduleState.delta_node_move`` bit-for-bit for
    each q (``tests/test_torch_schedule_windows.py`` pins this).

  * **Superstep replication** (``replication.superstep_replication_pass``):
    ``sr_front`` enumerates every non-empty ``(p1, p2)`` candidate of a
    superstep from one flat use/assignment matrix over the superstep's
    compute phase, and ``price_superstep_replication`` prices a candidate
    *purely* -- simulating exactly the mutation sequence of the
    transactional trial (parent comms, dropped comms, replica compute) and
    folding the cells through ``ScheduleState._delta_cells`` -- so failed
    candidates never touch the undo log.  Pruning after a commit can only
    reduce the cost further, so a candidate priced improving is improving.

  * **Superstep merging** (``replication.superstep_merge_pass``):
    ``sm_front`` is simply every adjacent pair ``(s, s + 1)``;
    ``price_superstep_merge`` prices one merge *purely* by replaying the
    exact mutation sequence of ``apply_sm_mutations`` against a virtual
    overlay (``_MergeSim``) -- comm moves to s-1, recursive replication of
    values produced in the merged step, compute and comm shifts from s+1
    -- so failed or losing candidates never touch the undo log.  Like SR,
    the price is the *pre-prune* delta (pruning after a commit can only
    lower the cost further) and only the **winner** (min priced delta,
    ties to the smallest s) commits through a transaction; the
    ``reference.py`` oracle applies the same winner rule in lockstep, so
    trajectories stay bit-identical on integer weights.

All are pure; committing stays with the engine's transaction machinery.
"""
from __future__ import annotations

import numpy as np
import torch

from ..schedule.engine import EPS, INF, ScheduleState
from . import partition_front


def device_windows(sched: ScheduleState, backend: str | None = None,
                   device: str | torch.device = "cuda"):
    """Device-resident window pricer for the torch backend, or None.

    Builds a ``kernels.front_pass.DeviceScheduleWindows`` mirror of the
    schedule's per-superstep rows on ``device`` when the torch backend is
    selected (the explicit argument wins, else the frontier default
    backend) and the instance satisfies the integer contract -- integral
    weights and BSP parameters make the int32 window programs
    bit-identical to the float64 fronts here.  Anything else returns None
    and the caller keeps the numpy pricers.  The torch backend on
    ``device="cuda"`` raises without a CUDA device.
    """
    if backend is None:
        backend = partition_front.get_backend()
    if backend != "torch":
        return None
    partition_front.check_device(backend, device)
    from ...kernels.front_pass import (DeviceScheduleWindows,
                                       schedule_device_supported)
    if not schedule_device_supported(sched):
        return None
    return DeviceScheduleWindows(sched, device=device)


def price_node_moves(sched: ScheduleState, v: int) -> np.ndarray:
    """Deltas of the compound node move ``v -> q`` for every q at once.

    Requires ``len(sched.assign[v]) == 1``.  Entry q equals
    ``sched.delta_node_move(v, q)`` bit-for-bit for every ``q != p``
    (entry p, the current processor, is 0 -- not a move).  Feasibility is
    ``node_move_targets``'s concern, mirroring the hill climber.
    """
    P = sched.inst.P
    (p, s), = sched.assign[v].items()
    dag = sched.inst.dag
    mu, om = dag.mu[v], dag.omega[v]
    allq = np.arange(P)
    D: dict[tuple[str, int], np.ndarray] = {}

    def dd(kind: str, t: int) -> np.ndarray:
        key = (kind, t)
        if key not in D:
            D[key] = np.zeros((P, P))
        return D[key]

    # outgoing comms retarget src p -> q (the one to q itself is dropped);
    # fill order mirrors ScheduleState._node_move_cells so every (q, proc)
    # slot accumulates its contributions in the same sequence
    for dst in sorted(sched.src_index.get((v, p), ())):
        _, t = sched.comms[(v, dst)]
        ds = dd("sent", t)
        ds[:, p] -= mu
        dd("recv", t)[dst, dst] -= mu
        keep = allq != dst
        ds[allq[keep], allq[keep]] += mu
    # an incoming comm to q is dropped (v becomes local there)
    for q in range(P):
        c0 = sched.comms.get((v, q))
        if c0 is not None and c0[0] != p:
            src0, t0 = c0
            dd("sent", t0)[q, src0] -= mu
            dd("recv", t0)[q, q] -= mu
    dw = dd("work", s)
    dw[:, p] -= om
    dw[allq, allq] += om
    # consumers left on p get one comm q -> p before their first use
    uses_p = sched.uses_on(v, p)
    if uses_p:
        tf = min(uses_p) - 1
        dd("sent", tf)[allq, allq] += mu
        dd("recv", tf)[:, p] += mu

    L, g = sched.inst.L, sched.inst.g
    zeros = np.zeros((P, P))
    deltas = np.zeros(P)
    for t in sorted({t for (_, t) in D}):
        assert t < sched.S, "node move cannot touch beyond the horizon"
        w1 = (np.asarray(sched.work[t])
              + D.get(("work", t), zeros)).max(axis=1)
        s1 = (np.asarray(sched.sent[t])
              + D.get(("sent", t), zeros)).max(axis=1)
        r1 = (np.asarray(sched.recv[t])
              + D.get(("recv", t), zeros)).max(axis=1)
        h = np.maximum(s1, r1)
        deltas += np.where(h > EPS, w1 + L + g * h, w1) - sched._scost[t]
    deltas[p] = 0.0
    return deltas


def price_comm_moves(sched: ScheduleState, v: int, dst: int,
                     ts) -> np.ndarray:
    """Deltas of moving comm ``(v, dst)`` to every superstep in ``ts``.

    Entry i equals ``sched.delta_move_comm(v, dst, ts[i])`` bit-for-bit:
    the removal delta at the current superstep is computed once (scalar),
    the insertion delta is evaluated against gathered top-2 triples for
    the whole window in one vectorized pass -- same ``max`` structure and
    float association as ``_comm_step_delta``.  All ``ts`` must be
    existing supersteps; entries equal to the current superstep price 0.
    The comm-rebalancing sweep calls this for long windows (the hot loop
    of multilevel refinement, where windows span the whole wavefront
    depth) and keeps the scalar path for short ones.
    """
    src, s = sched.comms[(v, dst)]
    mu = sched.inst.dag.mu[v]
    ts = np.asarray(ts, dtype=np.int64)
    d0 = sched._comm_step_delta(s, src, dst, -mu)
    st, rt, wt = sched._stop, sched._rtop, sched._wtop
    srow, rrow = sched.sent, sched.recv
    # alt = the max the changed entry competes against (``_kind_max_if``):
    # the runner-up when the entry IS the argmax, the leader otherwise
    s_alt = np.fromiter((st[t][2] if st[t][1] == src else st[t][0]
                         for t in ts), dtype=np.float64, count=len(ts))
    s_new = np.fromiter((srow[t][src] for t in ts), dtype=np.float64,
                        count=len(ts)) + mu
    r_alt = np.fromiter((rt[t][2] if rt[t][1] == dst else rt[t][0]
                         for t in ts), dtype=np.float64, count=len(ts))
    r_new = np.fromiter((rrow[t][dst] for t in ts), dtype=np.float64,
                        count=len(ts)) + mu
    w1 = np.fromiter((wt[t][0] for t in ts), dtype=np.float64,
                     count=len(ts))
    scost = np.fromiter((sched._scost[t] for t in ts), dtype=np.float64,
                        count=len(ts))
    h = np.maximum(np.maximum(s_alt, s_new), np.maximum(r_alt, r_new))
    L, g = sched.inst.L, sched.inst.g
    step = np.where(h > EPS, w1 + L + g * h, w1)
    deltas = d0 + (step - scost)
    deltas[ts == s] = 0.0
    return deltas


def price_comp_moves(sched: ScheduleState, v: int, p: int,
                     ts) -> np.ndarray:
    """Deltas of re-timing compute ``(v, p)`` to every superstep in ``ts``.

    Entry i equals ``sched._delta_cells([("work", s, p, -omega),
    ("work", ts[i], p, +omega)])`` bit-for-bit (the same two-cell fold the
    scalar compute-rebalancing trial prices): the removal delta at the
    current superstep is scalar, the insertion deltas are evaluated
    against gathered work top-2 triples in one pass.  Entries equal to
    the current superstep price 0.  Feasibility (parents present, uses
    not orphaned) is the caller's concern -- see
    ``list_sched.comp_rebalance_pass``.
    """
    s = sched.assign[v][p]
    om = sched.inst.dag.omega[v]
    ts = np.asarray(ts, dtype=np.int64)
    w1_minus = sched._kind_max_if("work", s, p, -om)
    d_s = sched._step_cost(w1_minus, sched.h_of(s)) - sched._scost[s]
    wt, wrow = sched._wtop, sched.work
    w_alt = np.fromiter((wt[t][2] if wt[t][1] == p else wt[t][0]
                         for t in ts), dtype=np.float64, count=len(ts))
    w_new = np.fromiter((wrow[t][p] for t in ts), dtype=np.float64,
                        count=len(ts)) + om
    w1 = np.maximum(w_alt, w_new)
    h = np.fromiter((max(sched._stop[t][0], sched._rtop[t][0])
                     for t in ts), dtype=np.float64, count=len(ts))
    scost = np.fromiter((sched._scost[t] for t in ts), dtype=np.float64,
                        count=len(ts))
    L, g = sched.inst.L, sched.inst.g
    step = np.where(h > EPS, w1 + L + g * h, w1)
    deltas = d_s + (step - scost)
    deltas[ts == s] = 0.0
    return deltas


def node_move_targets(sched: ScheduleState, v: int) -> list[bool]:
    """Feasible targets of the hill climber's node move, as P bools.

    Mirrors ``list_sched.try_node_move``'s guards: q must differ from the
    current processor, every parent must be present on q at v's superstep,
    and v must not be consumed on its current processor in that superstep
    (the replacement comm could not arrive in time).  Plain-python with
    early exits -- this runs once per node per pass, usually to say "no"
    (numpy dispatch here would dominate the whole pass).
    """
    P = sched.inst.P
    (p, s), = sched.assign[v].items()
    uses_p = sched.uses_on(v, p)
    if uses_p and min(uses_p) <= s:
        return [False] * P
    feas = [True] * P
    feas[p] = False
    alive = P - 1
    comms = sched.comms
    for u in sched.inst.dag.parents[v]:
        assign_u = sched.assign[u]
        for q in range(P):
            if not feas[q]:
                continue
            ss = assign_u.get(q)
            if ss is not None and ss <= s:
                continue
            c = comms.get((u, q))
            if c is None or c[1] >= s:
                feas[q] = False
                alive -= 1
        if not alive:
            break
    return feas


# --------------------------------------------------------------------------
# Superstep-replication front
# --------------------------------------------------------------------------

def sr_front(sched: ScheduleState, s: int) -> list[tuple[int, int, list[int]]]:
    """All non-empty SR candidates ``(p1, p2, nodes)`` of superstep s.

    One flat pass over the superstep's compute phase builds, per node, the
    processors it is *usable toward* (a child computed there or an onward
    send from there, minus processors it is already assigned to); the
    candidate list then reads off as the non-zero (p1, p2) combinations,
    in the deterministic lexicographic order both search paths share.
    ``nodes`` reproduces ``try_superstep_replication``'s eligibility
    filter exactly (sorted members of ``comp[s][p1]`` with a use on p2).
    """
    P = sched.inst.P
    entries: list[int] = []
    p1_of: list[int] = []
    for p1 in range(P):
        for v in sorted(sched.comp[s][p1]):
            entries.append(v)
            p1_of.append(p1)
    if not entries:
        return []
    assign = sched.assign
    children = sched.inst.dag.children
    src_index = sched.src_index
    U = np.zeros((len(entries), P), dtype=bool)
    for i, v in enumerate(entries):
        row = U[i]
        for c in children[v]:
            for pp in assign[c]:
                row[pp] = True
        for pp in range(P):
            if src_index.get((v, pp)):
                row[pp] = True
        for pp in assign[v]:
            row[pp] = False
    p1_arr = np.asarray(p1_of)
    front = []
    for p1 in range(P):
        idx = np.flatnonzero(p1_arr == p1)
        if not len(idx):
            continue
        nz = U[idx].any(axis=0)
        for p2 in range(P):
            if p2 == p1 or not nz[p2]:
                continue
            front.append((p1, p2, [entries[i] for i in idx if U[i, p2]]))
    return front


def price_superstep_replication(sched: ScheduleState, s: int, p1: int,
                                p2: int, nodes: list[int]) -> float | None:
    """Pure price of replicating ``nodes`` (from ``V_{p1,s}``) onto p2.

    Simulates the exact mutation sequence of the transactional trial --
    parent comms added at s-1, comms (v, p2) arriving at >= s dropped,
    replica compute added at (s, p2) -- without touching the schedule, and
    returns the cost delta *before* ``prune_useless_comms`` (which can
    only decrease it further, so an improving price implies an improving
    commit).  Returns None when some parent cannot be made present on p2
    (the trial would roll back).
    """
    dag = sched.inst.dag
    node_set = set(nodes)
    cells: list[tuple[str, int, int, float]] = []
    added_comp: set[int] = set()   # nodes virtually replicated at (p2, s)
    added_comm: set[int] = set()   # parents virtually comm'd to p2 at s-1
    for v in nodes:
        for u in dag.parents[v]:
            if (u in added_comp or u in added_comm
                    or sched.present_at(u, p2, s)):
                continue
            if u in node_set and sched.assign[u].get(p1) == s:
                continue  # replicated alongside
            cs_any = min(sched.assign[u].values())
            if (cs_any <= s - 1 and s - 1 >= 0
                    and (u, p2) not in sched.comms):
                src = min(sched.assign[u],
                          key=lambda p: (sched.assign[u][p], p))
                mu = dag.mu[u]
                cells.append(("sent", s - 1, src, mu))
                cells.append(("recv", s - 1, p2, mu))
                added_comm.add(u)
            else:
                return None
        c = sched.comms.get((v, p2))
        if c is not None and c[1] >= s:  # arrives later than the replica
            src0, t0 = c
            mu = dag.mu[v]
            cells.append(("sent", t0, src0, -mu))
            cells.append(("recv", t0, p2, -mu))
        cells.append(("work", s, p2, dag.omega[v]))
        added_comp.add(v)
    return sched._delta_cells(cells)


def apply_sr_mutations(sched, s: int, p1: int, p2: int,
                       nodes: list[int]) -> bool:
    """The SR mutation sequence (no prune): parent comms at s-1, late
    comms (v, p2) dropped, replica compute added at (s, p2).

    Single home of the sequence, shared by the engine commit below and the
    ``reference.py`` oracle (it only touches the mutation API the two
    schedule classes have in common); ``price_superstep_replication``'s
    pure simulation must mirror it cell-for-cell.  Returns False when some
    parent cannot be made present (caller rolls back / discards).
    """
    node_set = set(nodes)
    for v in nodes:
        # parents must be present on p2 by superstep s
        for u in sched.inst.dag.parents[v]:
            if sched.present_at(u, p2, s):
                continue
            if u in node_set and sched.assign[u].get(p1) == s:
                continue  # replicated alongside
            cs_any = min(sched.assign[u].values())
            if cs_any <= s - 1 and s - 1 >= 0 and (u, p2) not in sched.comms:
                src = min(sched.assign[u],
                          key=lambda p: (sched.assign[u][p], p))
                sched.add_comm(u, src, p2, s - 1)
            else:
                return False
        if (v, p2) in sched.comms and sched.comms[(v, p2)][1] >= s:
            sched.remove_comm(v, p2)  # arrives later than the replica
        sched.add_comp(v, p2, s)
    return True


# --------------------------------------------------------------------------
# Superstep-merging front
# --------------------------------------------------------------------------

def _ensure_present_for_merge(sched, v: int, dst: int, s: int) -> bool:
    """Make value v usable on dst within merged superstep s, replicating
    recursively when the producer sits in superstep s itself (paper SM).
    Mutates sched; returns False if impossible (caller rolls back).

    Single home of the recursion, shared by the engine commit, the
    ``reference.py`` oracle and -- cell-for-cell -- the pure pricing
    simulation below (``_MergeSim`` implements the same mutation API).
    """
    if sched.present_at(v, dst, s):
        return True
    cs_any = min(sched.assign[v].values())
    if cs_any <= s - 1 and s - 1 >= 0 and (v, dst) not in sched.comms:
        src = min(sched.assign[v],
                  key=lambda p: (sched.assign[v][p], p))
        sched.add_comm(v, src, dst, s - 1)
        return True
    # must replicate v on dst at superstep s -> parents must be available too
    if dst in sched.assign[v]:
        return False  # computed later on dst; moving it up is out of scope
    for u in sched.inst.dag.parents[v]:
        if not _ensure_present_for_merge(sched, u, dst, s):
            return False
    sched.add_comp(v, dst, s)
    return True


def apply_sm_mutations(sched, s: int, comms_at=None) -> bool:
    """The SM mutation sequence (no prune): comms at s used at s+1 move to
    s-1 or are replaced by recursive replication, compute and comms of
    s+1 shift into s.

    Single home of the sequence, shared by the engine commit, the
    ``reference.py`` oracle (mutation API only) and the pure pricing
    simulation (a ``_MergeSim`` quacks like a schedule).  Returns False
    when the merge is infeasible (caller rolls back / discards).

    ``comms_at`` optionally supplies the two sorted comm snapshots
    ``(at s, at s+1)`` so a pricing sweep can sort the comm dict once per
    round instead of once per candidate.  This is exactly the iteration
    the inline sort produces: the s+1 snapshot stays valid throughout
    because the earlier steps only remove/move comms scheduled *at s* and
    only add comms at s-1.
    """
    P = sched.inst.P
    if comms_at is None:
        snap = sorted(sched.comms.items())
        at_s = [kv for kv in snap if kv[1][1] == s]
        at_s1 = [kv for kv in snap if kv[1][1] == s + 1]
    else:
        at_s, at_s1 = comms_at
    for (v, dst), (src, t) in at_s:
        uses = [x for x in sched.uses_on(v, dst)
                if x > t and not sched.compute_sstep(v, dst) <= x]
        if not uses or min(uses) > s + 1:
            continue  # stays in merged superstep, delivers for >= s+2
        if sched.assign[v].get(src, INF) <= s - 1 and s - 1 >= 0:
            sched.move_comm(v, dst, s - 1)
            continue
        # replicate v (and recursively its parents) on dst
        sched.remove_comm(v, dst)
        if not _ensure_present_for_merge(sched, v, dst, s):
            return False
    # move compute s+1 -> s.  A pricing sim aggregates the whole shift
    # into per-processor work transfers (``shift_comp_bulk``): nothing
    # after this step reads assignments, and the per-node infeasibility
    # guard below cannot fire (``_ensure_present_for_merge`` refuses to
    # replicate onto a processor the value is already assigned to).
    shift = getattr(sched, "shift_comp_bulk", None)
    if shift is not None:
        shift(s)
    else:
        for p in range(P):
            for v in sorted(sched.comp[s + 1][p]):
                sched.remove_comp(v, p)
                if p in sched.assign[v]:
                    return False  # already replicated there during merge
                sched.add_comp(v, p, s)
    # move comms at s+1 -> s
    for (v, dst), _ in at_s1:
        sched.move_comm(v, dst, s)
    return True


class _CowComms:
    """Copy-on-write view of a comm dict: reads fall through to the base,
    writes land in an overlay (None = removed).  Supports exactly the
    operations the SM/split sequences perform -- ``get`` / ``in`` / ``[]``
    / ``pop`` / ``[] =`` -- so building a pricing sim is O(1) instead of
    O(comms).  ``map_base`` (optional) is applied to base *values* on
    read: the split sim renumbers base comm positions into post-shift
    coordinates without materializing anything."""

    __slots__ = ("base", "over", "map_base")

    def __init__(self, base: dict, map_base=None) -> None:
        self.base = base
        self.over: dict = {}
        self.map_base = map_base

    def get(self, k, default=None):
        if k in self.over:
            v = self.over[k]
            return default if v is None else v
        v = self.base.get(k)
        if v is None:
            return default
        return v if self.map_base is None else self.map_base(v)

    def __contains__(self, k) -> bool:
        return self.get(k) is not None

    def __getitem__(self, k):
        v = self.get(k)
        if v is None:
            raise KeyError(k)
        return v

    def __setitem__(self, k, v) -> None:
        self.over[k] = v

    def pop(self, k):
        v = self[k]
        self.over[k] = None
        return v

    def items(self):
        mb = self.map_base
        for k, v in self.base.items():
            if k not in self.over:
                yield k, (v if mb is None else mb(v))
        for k, v in self.over.items():
            if v is not None:
                yield k, v


class _MergeSim:
    """Virtual overlay over a ``ScheduleState`` exposing exactly the reads
    and mutations ``apply_sm_mutations`` performs, without touching the
    real schedule.  Mutations accumulate cost cells instead; the price is
    ``base._delta_cells(cells)`` at the end.

    Only the members the SM sequence uses are implemented: ``comms`` /
    ``assign`` (merged dict views), ``comp`` (base -- the sequence never
    revisits a phase it mutates), ``uses_on`` / ``compute_sstep`` /
    ``present_at``, and the four mutation primitives.
    """

    def __init__(self, base: ScheduleState) -> None:
        self.base = base
        self.inst = base.inst
        self.comp = base.comp          # never mutated during pricing
        self.cells: list[tuple[str, int, int, float]] = []
        self.comms = _CowComms(base.comms)
        self._assign: dict[int, dict[int, int]] = {}   # copy-on-write
        self._src: dict[tuple[int, int], set[int]] = {}

    # ------------------------------------------------------------- views
    @property
    def assign(self):
        return self

    def __getitem__(self, v: int) -> dict[int, int]:
        # self.assign[v] -- copy-on-write per node
        got = self._assign.get(v)
        if got is None:
            got = dict(self.base.assign[v])
            self._assign[v] = got
        return got

    def _src_set(self, v: int, src: int) -> set[int]:
        key = (v, src)
        got = self._src.get(key)
        if got is None:
            got = set(self.base.src_index.get(key, ()))
            self._src[key] = got
        return got

    def compute_sstep(self, v: int, p: int) -> float:
        return self[v].get(p, INF)

    def recv_sstep(self, v: int, p: int) -> float:
        c = self.comms.get((v, p))
        return c[1] if c is not None else INF

    def present_at(self, v: int, p: int, s: int) -> bool:
        return self.compute_sstep(v, p) <= s or self.recv_sstep(v, p) < s

    def uses_on(self, v: int, p: int) -> list[int]:
        out = []
        for c in self.inst.dag.children[v]:
            t = self[c].get(p)
            if t is not None:
                out.append(t)
        for dst in self._src_set(v, p):
            out.append(self.comms[(v, dst)][1])
        return sorted(out)

    # --------------------------------------------------------- mutations
    def add_comp(self, v: int, p: int, s: int) -> None:
        assert p not in self[v]
        self[v][p] = s
        self.cells.append(("work", s, p, self.inst.dag.omega[v]))

    def remove_comp(self, v: int, p: int) -> None:
        s = self[v].pop(p)
        self.cells.append(("work", s, p, -self.inst.dag.omega[v]))

    def add_comm(self, v: int, src: int, dst: int, s: int) -> None:
        assert (v, dst) not in self.comms
        self.comms[(v, dst)] = (src, s)
        self._src_set(v, src).add(dst)
        mu = self.inst.dag.mu[v]
        self.cells.append(("sent", s, src, mu))
        self.cells.append(("recv", s, dst, mu))

    def remove_comm(self, v: int, dst: int) -> None:
        src, s = self.comms.pop((v, dst))
        self._src_set(v, src).discard(dst)
        mu = self.inst.dag.mu[v]
        self.cells.append(("sent", s, src, -mu))
        self.cells.append(("recv", s, dst, -mu))

    def move_comm(self, v: int, dst: int, new_s: int) -> None:
        src, _ = self.comms[(v, dst)]
        self.remove_comm(v, dst)
        self.add_comm(v, src, dst, new_s)

    def shift_comp_bulk(self, s: int) -> None:
        """Aggregate the s+1 -> s compute shift: the work row at s+1 *is*
        the per-processor omega sum of ``comp[s + 1]``, so the whole step
        collapses into P cell transfers (step 1 never touches row s+1)."""
        row = self.base.work[s + 1]
        for p in range(self.inst.P):
            w = row[p]
            if w:
                self.cells.append(("work", s + 1, p, -w))
                self.cells.append(("work", s, p, w))


def sm_front(sched: ScheduleState) -> list[int]:
    """All SM candidates: merge s+1 into s for every adjacent pair."""
    return list(range(sched.S - 1))


def price_superstep_merge(sched: ScheduleState, s: int,
                          comms_at=None) -> float | None:
    """Pure price of merging superstep s+1 into s.

    Replays ``apply_sm_mutations`` against a virtual overlay, so the real
    schedule (and its undo log) is never touched; returns the *pre-prune*
    cost delta -- the quantity both search paths rank winners by; pruning
    after a commit only lowers it further -- or None when the merge is
    infeasible (the transactional trial would roll back).  ``comms_at``
    forwards the pre-sorted per-superstep comm snapshots (see
    ``apply_sm_mutations``).
    """
    if s + 1 >= sched.S:
        return None
    sim = _MergeSim(sched)
    if not apply_sm_mutations(sim, s, comms_at):
        return None
    return sched._delta_cells(sim.cells)


def commit_superstep_merge(sched: ScheduleState, s: int) -> None:
    """Replay a priced SM winner through the transaction machinery, then
    prune (the commit is never worse than its price) and compact."""
    sched.begin()
    try:
        if not apply_sm_mutations(sched, s):
            raise RuntimeError("priced SM became infeasible at commit")
        sched.prune_useless_comms()
    except BaseException:
        sched.rollback()
        raise
    sched.commit()
    sched.compact()


def commit_superstep_replication(sched: ScheduleState, s: int, p1: int,
                                 p2: int, nodes: list[int]) -> None:
    """Replay a priced SR winner through the transaction machinery.

    Performs exactly the mutations ``price_superstep_replication``
    simulated (feasibility was established there), then prunes; a
    surprise infeasibility or mid-commit failure rolls the transaction
    back before re-raising, so the schedule is never left corrupted.
    """
    sched.begin()
    try:
        if not apply_sr_mutations(sched, s, p1, p2, nodes):
            raise RuntimeError("priced SR became infeasible at commit")
        sched.prune_useless_comms()
    except BaseException:
        sched.rollback()
        raise
    sched.commit()


# --------------------------------------------------------------------------
# Superstep-split front (inverse of SM)
# --------------------------------------------------------------------------

class _SplitSim:
    """Virtual overlay over a ``ScheduleState`` exposing exactly the reads
    and mutations ``apply_split_mutations`` performs, without touching the
    real schedule.  Mutations accumulate cost cells; the price is
    ``base._delta_cells(cells)`` at the end.

    The sim lives in *post-split* coordinates once ``shift_tail_bulk`` has
    run: base positions ``t > s`` read as ``t + 1`` (comms through the
    ``_CowComms`` value map, assignments through the lazy copy-on-write
    dicts -- every assign read in the split sequence happens post-shift).
    Cells map post positions back onto base rows: ``t <= s`` hits row t,
    the inserted superstep ``s + 1`` hits the virtual row at ``base.S``
    (``_delta_cells`` folds everything at exactly that index into one
    all-zero row -- the correct model of the one new superstep), and
    ``t >= s + 2`` hits base row ``t - 1`` -- the row whose content it is
    after the pure renumbering.  The renumbering itself moves no load
    between rows, so ``shift_tail_bulk`` emits **no** cells: the tail
    shift prices to exactly zero, by construction rather than by O(S * P)
    transfer pairs.  Single-use: one sim per priced candidate.
    """

    def __init__(self, base: ScheduleState, s: int) -> None:
        self.base = base
        self.inst = base.inst
        self.S = base.S
        self.cells: list[tuple[str, int, int, float]] = []
        self._split = s
        self._shifted = False
        self.comms = _CowComms(base.comms, map_base=self._map_comm)
        self._assign: dict[int, dict[int, int]] = {}   # copy-on-write

    def _map_comm(self, val):
        src, t = val
        if self._shifted and t > self._split:
            return (src, t + 1)
        return val

    def _cell_s(self, t: int) -> int:
        """Base row a mutation at post-shift position t lands on."""
        if not self._shifted or t <= self._split:
            return t
        if t == self._split + 1:
            return self.base.S   # the inserted superstep: virtual row
        return t - 1

    # ------------------------------------------------------------- views
    @property
    def assign(self):
        return self

    def __getitem__(self, v: int) -> dict[int, int]:
        got = self._assign.get(v)
        if got is None:
            base = self.base.assign[v]
            if self._shifted:
                sp = self._split
                got = {p: (t + 1 if t > sp else t) for p, t in base.items()}
            else:
                got = dict(base)
            self._assign[v] = got
        return got

    # --------------------------------------------------------- mutations
    def shift_tail_bulk(self, s: int) -> None:
        assert s == self._split and not self._shifted
        self._shifted = True
        self.S += 1

    def add_comp(self, v: int, p: int, t: int) -> None:
        av = self[v]
        assert p not in av
        av[p] = t
        self.cells.append(("work", self._cell_s(t), p,
                           self.inst.dag.omega[v]))

    def remove_comp(self, v: int, p: int) -> None:
        t = self[v].pop(p)
        self.cells.append(("work", self._cell_s(t), p,
                           -self.inst.dag.omega[v]))

    def add_comm(self, v: int, src: int, dst: int, t: int) -> None:
        assert (v, dst) not in self.comms
        self.comms[(v, dst)] = (src, t)
        mu = self.inst.dag.mu[v]
        cs = self._cell_s(t)
        self.cells.append(("sent", cs, src, mu))
        self.cells.append(("recv", cs, dst, mu))

    def remove_comm(self, v: int, dst: int) -> None:
        src, t = self.comms.pop((v, dst))
        mu = self.inst.dag.mu[v]
        cs = self._cell_s(t)
        self.cells.append(("sent", cs, src, -mu))
        self.cells.append(("recv", cs, dst, -mu))


def split_front(sched: ScheduleState, s: int, level,
                max_candidates: int = 8) -> list[tuple[int, list]]:
    """Candidate bipartitions of superstep s's compute phase, as
    ``(cut_level, late)`` pairs in ascending cut order.

    Cut points are the distinct topological levels present in the phase
    (``level`` from ``list_sched.dag_levels``): candidate ``cut`` delays
    every ``(node, proc)`` entry whose node sits at level >= cut into the
    new superstep.  Cutting by level guarantees structural feasibility --
    an edge u -> c inside the phase implies ``level[c] > level[u]``, so a
    delayed parent's children delay with it, and every replica of a
    delayed node delays together.  With more than ``max_candidates``
    distinct cut levels a deterministic evenly-spaced subset is priced
    (the front stays bounded per superstep; no RNG, so engine and oracle
    enumerate identically).  ``late`` is sorted -- the shared mutation
    order of ``apply_split_mutations``.
    """
    P = sched.inst.P
    members = [(level[v], v, p)
               for p in range(P) for v in sched.comp[s][p]]
    lvls = sorted({l for (l, _v, _p) in members})
    if len(lvls) < 2:
        return []
    cuts = lvls[1:]
    k = len(cuts)
    if k > max_candidates:
        idxs = sorted({(i * (k - 1)) // (max_candidates - 1)
                       for i in range(max_candidates)})
        cuts = [cuts[i] for i in idxs]
    front = []
    for cut in cuts:
        late = sorted((v, p) for (l, v, p) in members if l >= cut)
        front.append((cut, late))
    return front


def price_superstep_split(sched: ScheduleState, s: int, late,
                          pre=None) -> float | None:
    """Pure price of splitting superstep s's compute phase (``late`` pairs
    delay into a new superstep ``s + 1``).

    Replays ``apply_split_mutations`` against a virtual overlay, so the
    real schedule (and its undo log) is never touched; returns the
    *pre-prune* cost delta -- the quantity the winner rule ranks by;
    pruning after a commit only lowers it further -- or None when some
    re-derived comm cannot reach a consumer in time (the transactional
    trial would roll back).  ``pre`` forwards the sorted pre-mutation comm
    snapshot (see ``apply_split_mutations``); on integer weights the price
    equals the transactional replay's cost change bit-for-bit, the same
    contract as ``price_superstep_merge``.
    """
    from ..schedule.engine import apply_split_mutations
    sim = _SplitSim(sched, s)
    if not apply_split_mutations(sim, s, late, pre):
        return None
    return sched._delta_cells(sim.cells)


def commit_superstep_split(sched: ScheduleState, s: int, late) -> None:
    """Replay a priced split winner through the transaction machinery,
    then prune (the commit is never worse than its price) and compact --
    so superstep indices never drift from the oracle's."""
    from ..schedule.engine import apply_split_mutations
    sched.begin()
    try:
        if not apply_split_mutations(sched, s, late):
            raise RuntimeError("priced split became infeasible at commit")
        sched.prune_useless_comms()
    except BaseException:
        sched.rollback()
        raise
    sched.commit()
    sched.compact()

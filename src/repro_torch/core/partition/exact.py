"""Exact branch-and-bound solver for (hyper)graph partitioning.

This plays the role of the paper's ILP formulations (§5).  The container has
no commercial ILP solver (the paper uses COPT), so we solve the same 0/1
programs exactly with a branch-and-bound search that certifies optimality on
small instances:

  * mode='none'  -- classical partitioning, each node on exactly 1 processor
                    (the base ILP of §5.1);
  * mode='dup'   -- ILP/D semantics (§5.2.1): at most 2 replicas per node;
  * mode='rep'   -- ILP/R semantics (§5.2.2): unlimited replication.

Branching assigns each node a processor *bitmask*.  Partial-assignment
state (per-edge uncovered-subset counts, loads, and the monotone lower
bound -- the connectivity cost of partially-assigned hyperedges, which can
only grow as pins are added) lives in the incremental ``PartitionState``
engine: assigning a node is ``engine.apply`` (O(degree)), backtracking is
``engine.undo``.  Processor-permutation symmetry is broken by only allowing
a new processor index once all smaller indices are in use.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..hypergraph import Hypergraph
from .cost import capacity, partition_cost
from .engine import _MAX_P, PartitionState


@dataclasses.dataclass
class ExactResult:
    masks: np.ndarray
    cost: float
    optimal: bool
    nodes_explored: int
    seconds: float


def _candidate_masks(P: int, mode: str) -> list[int]:
    out = []
    for m in range(1, 1 << P):
        k = bin(m).count("1")
        if mode == "none" and k != 1:
            continue
        if mode == "dup" and k > 2:
            continue
        out.append(m)
    # prefer fewer replicas first: cheaper loads, finds good UBs earlier
    out.sort(key=lambda m: (bin(m).count("1"), m))
    return out


def exact_partition(
    hg: Hypergraph,
    P: int,
    eps: float,
    mode: str = "none",
    time_limit: float | None = None,
    ub_masks: np.ndarray | None = None,
) -> ExactResult:
    assert mode in ("none", "dup", "rep")
    if P > _MAX_P:
        raise ValueError(
            f"exact_partition supports P <= {_MAX_P} (2^P subset tables); "
            "wider meshes are heuristic-only -- use partition_heuristic")
    cap = capacity(hg, P, eps) + 1e-9
    t0 = time.monotonic()

    # scalar backend: B&B applies/undoes one tiny assignment per search
    # node, where per-op numpy dispatch would dominate (see engine.py)
    st = PartitionState(hg, P, backend="python")  # unassigned; st.cost = LB
    xinc, inc_edges = hg.xinc, hg.inc_edges
    # order nodes by decreasing total incident edge weight (tight LBs early)
    score = [float(hg.mu[inc_edges[xinc[v]:xinc[v + 1]]].sum())
             for v in range(hg.n)]
    order = sorted(range(hg.n), key=lambda v: -score[v])

    cands = _candidate_masks(P, mode)

    best_cost = np.inf
    best_masks: np.ndarray | None = None
    if ub_masks is not None:
        best_masks = np.asarray(ub_masks).copy()
        best_cost = partition_cost(hg, best_masks, P)

    remaining_w = [0.0] * (hg.n + 1)
    for i in range(hg.n - 1, -1, -1):
        remaining_w[i] = remaining_w[i + 1] + hg.omega[order[i]]

    state = {"explored": 0, "timed_out": False,
             "best_cost": best_cost, "best_masks": best_masks}

    def dfs(idx: int, used_procs: int) -> None:
        if state["timed_out"]:
            return
        state["explored"] += 1
        if time_limit is not None and state["explored"] % 2048 == 0:
            if time.monotonic() - t0 > time_limit:
                state["timed_out"] = True
                return
        if idx == hg.n:
            if st.cost < state["best_cost"] - 1e-12:
                state["best_cost"] = st.cost
                state["best_masks"] = st.masks.copy()
            return
        v = order[idx]
        # capacity feasibility: every remaining node needs >= its weight somewhere
        free = 0.0
        for load in st.loads:
            if load < cap:
                free += cap - load
        if remaining_w[idx] > free + 1e-9:
            return
        w_v = hg.omega[v]
        for m in cands:
            # Symmetry breaking: used processors always form the prefix
            # {0..used_procs-1}; a mask may use any of those plus a
            # *contiguous block* of fresh processors starting at used_procs
            # (fresh processors are mutually symmetric).
            high = m >> used_procs
            if high & (high + 1):
                continue
            # balance check
            ok = True
            mm = m
            while mm:
                p = (mm & -mm).bit_length() - 1
                if st.loads[p] + w_v > cap:
                    ok = False
                    break
                mm &= mm - 1
            if not ok:
                continue
            st.apply(v, m)
            if st.cost < state["best_cost"] - 1e-12:
                dfs(idx + 1, max(used_procs, m.bit_length()))
            st.undo()
            if state["timed_out"]:
                return

    dfs(0, 0)
    seconds = time.monotonic() - t0
    if state["best_masks"] is None:
        raise RuntimeError("no feasible partition found (check eps/P)")
    return ExactResult(
        masks=np.asarray(state["best_masks"]),
        cost=float(state["best_cost"]),
        optimal=not state["timed_out"],
        nodes_explored=state["explored"],
        seconds=seconds,
    )

"""Full-recompute heuristic: the path for P beyond the engine's tables.

Every candidate move re-runs exact set cover over all incident
hyperedges.  It is O(deg^2)-ish per evaluation, so it only suits small
instances, but it needs no 2^P table: ``heuristic.py`` takes it when
P > ``engine._MAX_P`` (``partition_heuristic``,
``replicate_local_search`` and the FM step of
``partition_with_replication``).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..hypergraph import Hypergraph
from .cost import capacity, edge_cost, min_cover, partition_cost


def _incident_lists(hg: Hypergraph) -> list[list[int]]:
    """Seed-identical list-of-lists incidence (not the CSR view), so the
    reference's timing stays an honest baseline."""
    inc: list[list[int]] = [[] for _ in range(hg.n)]
    for ei, e in enumerate(hg.edges):
        for v in e:
            inc[v].append(ei)
    return inc


def greedy_initial_reference(hg: Hypergraph, P: int, eps: float,
                             rng: np.random.Generator) -> np.ndarray:
    """BFS-grow partitions over the pin-adjacency, balanced by weight."""
    cap_target = float(hg.omega.sum()) / P
    inc = _incident_lists(hg)
    visited = np.zeros(hg.n, dtype=bool)
    part = np.zeros(hg.n, dtype=np.int64)
    order = rng.permutation(hg.n)
    cur_p, cur_w = 0, 0.0
    queue: deque[int] = deque()
    qi = 0
    while True:
        if not queue:
            while qi < hg.n and visited[order[qi]]:
                qi += 1
            if qi == hg.n:
                break
            queue.append(order[qi])
        v = queue.popleft()
        if visited[v]:
            continue
        visited[v] = True
        if cur_w + hg.omega[v] > cap_target and cur_p < P - 1:
            cur_p += 1
            cur_w = 0.0
        part[v] = cur_p
        cur_w += hg.omega[v]
        for ei in inc[v]:
            for u in hg.edges[ei]:
                if not visited[u]:
                    queue.append(u)
    return (1 << part).astype(np.int64)


def fm_refine_reference(hg: Hypergraph, masks: np.ndarray, P: int, eps: float,
                        rng: np.random.Generator, passes: int = 6) -> np.ndarray:
    """Move-based refinement with per-move full recomputation (seed)."""
    cap = capacity(hg, P, eps) + 1e-9
    inc = _incident_lists(hg)
    load = np.zeros(P)
    for v in range(hg.n):
        load[int(masks[v]).bit_length() - 1] += hg.omega[v]

    def incident_cost(v: int) -> float:
        return sum(edge_cost(hg, masks, ei, P) for ei in inc[v])

    for _ in range(passes):
        improved = False
        for v in rng.permutation(hg.n):
            p = int(masks[v]).bit_length() - 1
            base = incident_cost(v)
            best_gain, best_q = 0.0, -1
            for q in range(P):
                if q == p or load[q] + hg.omega[v] > cap:
                    continue
                masks[v] = 1 << q
                gain = base - incident_cost(v)
                masks[v] = 1 << p
                if gain > best_gain + 1e-12:
                    best_gain, best_q = gain, q
            if best_q >= 0:
                masks[v] = 1 << best_q
                load[p] -= hg.omega[v]
                load[best_q] += hg.omega[v]
                improved = True
        if not improved:
            break
    return masks


def partition_heuristic_reference(hg: Hypergraph, P: int, eps: float,
                                  restarts: int = 4, seed: int = 0):
    """Seed non-replicating baseline: greedy + FM, best of restarts.

    Returns ``(masks, cost)``.
    """
    rng = np.random.default_rng(seed)
    best_masks, best_cost = None, np.inf
    for _ in range(restarts):
        masks = greedy_initial_reference(hg, P, eps, rng)
        masks = fm_refine_reference(hg, masks, P, eps, rng)
        c = partition_cost(hg, masks, P)
        if c < best_cost:
            best_cost, best_masks = c, masks.copy()
    return best_masks, float(best_cost)


def replicate_local_search_reference(
    hg: Hypergraph,
    masks: np.ndarray,
    P: int,
    eps: float,
    max_replicas: int | None = None,
    max_passes: int = 30,
    seed: int = 0,
):
    """Seed replication local search (full recompute).  Returns (masks, cost)."""
    rng = np.random.default_rng(seed)
    masks = np.asarray(masks, dtype=np.int64).copy()
    cap = capacity(hg, P, eps) + 1e-9
    inc = _incident_lists(hg)
    load = np.zeros(P)
    for v in range(hg.n):
        m = int(masks[v])
        for p in range(P):
            if (m >> p) & 1:
                load[p] += hg.omega[v]

    def incident_cost(v: int) -> float:
        return sum(edge_cost(hg, masks, ei, P) for ei in inc[v])

    def try_edge_move(ei: int) -> bool:
        e = hg.edges[ei]
        pin_masks = [int(masks[v]) for v in e]
        lam = min_cover(pin_masks, P)
        if lam < 2:
            return False
        best = None
        for p in range(P):
            movers = [v for v in e if not (int(masks[v]) >> p) & 1]
            if not movers:
                continue
            if max_replicas is not None and any(
                    bin(int(masks[v])).count("1") >= max_replicas
                    for v in movers):
                continue
            w = sum(hg.omega[v] for v in movers)
            if load[p] + w > cap:
                continue
            if best is None or len(movers) < len(best[1]):
                best = (p, movers, w)
        if best is None:
            return False
        p, movers, w = best
        touched = sorted({e2 for v in movers for e2 in inc[v]})
        before = sum(edge_cost(hg, masks, e2, P) for e2 in touched)
        old = [int(masks[v]) for v in movers]
        for v in movers:
            masks[v] = int(masks[v]) | (1 << p)
        after = sum(edge_cost(hg, masks, e2, P) for e2 in touched)
        if after < before - 1e-12:
            load[p] += w
            return True
        for v, m_old in zip(movers, old):
            masks[v] = m_old
        return False

    for _ in range(max_passes):
        improved = False
        for ei in rng.permutation(len(hg.edges)):
            if try_edge_move(int(ei)):
                improved = True
        for v in rng.permutation(hg.n):
            m = int(masks[v])
            k = bin(m).count("1")
            base = incident_cost(v)
            if max_replicas is None or k < max_replicas:
                best_gain, best_p = 0.0, -1
                for p in range(P):
                    if (m >> p) & 1 or load[p] + hg.omega[v] > cap:
                        continue
                    masks[v] = m | (1 << p)
                    gain = base - incident_cost(v)
                    masks[v] = m
                    if gain > best_gain + 1e-12:
                        best_gain, best_p = gain, p
                if best_p >= 0:
                    masks[v] = m | (1 << best_p)
                    load[best_p] += hg.omega[v]
                    improved = True
                    continue
            if k > 1:
                for p in range(P):
                    if bin(m).count("1") <= 1:
                        break
                    if not (m >> p) & 1:
                        continue
                    masks[v] = m & ~(1 << p)
                    if incident_cost(v) <= base + 1e-12:
                        load[p] -= hg.omega[v]
                        improved = True
                        m = int(masks[v])
                        base = incident_cost(v)
                    else:
                        masks[v] = m
        if not improved:
            break
    return masks, partition_cost(hg, masks, P)

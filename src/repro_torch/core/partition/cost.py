"""Cost model for balanced hypergraph partitioning with replication.

An assignment is an array ``masks`` of length n; ``masks[v]`` is a bitmask of
the processors node v is assigned to (possibly several -> replication).

Paper §3.2: with replication, lambda_e is the minimal number of processors
that *cover* hyperedge e (a set-cover instance, tractable because P is a
small constant); the cost of a partitioning is  sum_e mu(e) * (lambda_e - 1).
The balance constraint is  omega(V_p) <= (1+eps)/P * omega(V)  for every p.
"""
from __future__ import annotations

from functools import reduce
from itertools import combinations

import numpy as np

from ..hypergraph import Hypergraph


def capacity(hg: Hypergraph, P: int, eps: float) -> float:
    return (1.0 + eps) / P * float(hg.omega.sum())


def min_cover(pin_masks, P: int) -> int:
    """Minimum number of processors covering every pin mask (lambda_e).

    ``pin_masks`` are the processor bitmasks of the nodes of one hyperedge.
    Exact set cover by enumeration in popcount order -- fine for P <= ~10.
    """
    distinct = set(pin_masks)
    distinct.discard(0)
    if not distinct:
        return 0
    inter = reduce(lambda a, b: a & b, distinct)
    if inter:
        return 1
    union = reduce(lambda a, b: a | b, distinct)
    procs = [p for p in range(P) if (union >> p) & 1]
    masks = sorted(distinct)
    for k in range(2, len(procs)):
        for combo in combinations(procs, k):
            s = 0
            for p in combo:
                s |= 1 << p
            if all(m & s for m in masks):
                return k
    return len(procs)


def edge_cost(hg: Hypergraph, masks: np.ndarray, ei: int, P: int) -> float:
    e = hg.edges[ei]
    lam = min_cover([int(masks[v]) for v in e], P)
    return float(hg.mu[ei]) * max(0, lam - 1)


def edge_lambdas(hg: Hypergraph, masks: np.ndarray, P: int) -> np.ndarray:
    """Vectorized lambda_e for every hyperedge at once.

    Batch analogue of the engine's uncovered-subset table: one reduceat
    over the CSR pin array replaces a python set-cover per edge.  Falls
    back to the scalar path for P beyond the table limit.
    """
    from .engine import _MAX_P, _lambda_from_rows, _tables, _uncov_rows

    m = len(hg.edges)
    if m == 0:
        return np.zeros(0, dtype=np.int16)
    if P > _MAX_P:
        return np.array([min_cover([int(masks[v]) for v in e], P)
                         for e in hg.edges], dtype=np.int16)
    _, order, order_pc, contrib = _tables(P)
    masks = np.asarray(masks, dtype=np.int64)
    uncov = _uncov_rows(masks, hg.pins, hg.xpins, contrib)
    return _lambda_from_rows(uncov, order, order_pc)


def partition_cost(hg: Hypergraph, masks: np.ndarray, P: int) -> float:
    """Total (lambda_e - 1) connectivity cost under replication semantics."""
    lam = edge_lambdas(hg, masks, P).astype(np.float64)
    return float((hg.mu * np.maximum(lam - 1, 0)).sum())


def loads(hg: Hypergraph, masks: np.ndarray, P: int) -> np.ndarray:
    masks = np.asarray(masks, dtype=np.int64)
    bits = (masks[:, None] >> np.arange(P)) & 1
    return (bits * hg.omega[:, None]).sum(axis=0).astype(np.float64)


def is_balanced(hg: Hypergraph, masks: np.ndarray, P: int, eps: float) -> bool:
    cap = capacity(hg, P, eps)
    # tolerance for float weight sums
    return bool(np.all(loads(hg, masks, P) <= cap + 1e-9))


def is_valid(hg: Hypergraph, masks: np.ndarray, P: int, eps: float,
             max_replicas: int | None = None) -> bool:
    if len(masks) != hg.n:
        return False
    for v in range(hg.n):
        m = int(masks[v])
        if m <= 0 or m >= (1 << P):
            return False
        if max_replicas is not None and bin(m).count("1") > max_replicas:
            return False
    return is_balanced(hg, masks, P, eps)

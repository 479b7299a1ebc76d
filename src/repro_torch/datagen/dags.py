"""Computational-DAG generators mirroring the paper's scheduling datasets.

  * hdb-like (§B.2): fine-grained DAGs of SpMV, conjugate gradient, k-NN and
    iterated matrix multiplication on random sparse structures -- the same
    four computations the HyperDAG database is built from;
  * sptrsv-like: the dependency DAG of a sparse lower-triangular solve
    (node = row, edge = sub-diagonal non-zero) on synthetic banded+fill
    triangular matrices;
  * psdd-like: irregular arithmetic-circuit DAGs (alternating sum/product
    units with random fan-in, as in PSDD evaluation graphs).

Sizes are scaled to the single-core CPU budget of this container (the paper
uses up to 175k nodes on a 128-thread EPYC; we default to 400-4000 and the
generators accept any size).
"""
from __future__ import annotations

import numpy as np

from ..core.hypergraph import Dag


def _rand_sparse_rows(n: int, nnz_per_row: int, rng) -> list[list[int]]:
    rows = []
    for i in range(n):
        deg = max(1, int(rng.poisson(nnz_per_row)))
        rows.append(sorted(set(rng.integers(0, n, size=deg).tolist())))
    return rows


def spmv_dag(n_rows: int = 60, nnz_per_row: int = 3, seed: int = 0) -> Dag:
    """Fine-grained y = A x: input nodes x_j -> multiply nodes -> row sums."""
    rng = np.random.default_rng(seed)
    rows = _rand_sparse_rows(n_rows, nnz_per_row, rng)
    edges = []
    x_nodes = list(range(n_rows))  # x_j
    nid = n_rows
    mul_nodes_of_row = []
    for i, cols in enumerate(rows):
        muls = []
        for j in cols:
            edges.append((x_nodes[j], nid))
            muls.append(nid)
            nid += 1
        mul_nodes_of_row.append(muls)
    for i, muls in enumerate(mul_nodes_of_row):  # reduction node per row
        for m in muls:
            edges.append((m, nid))
        nid += 1
    return Dag(n=nid, edge_list=edges, name=f"spmv_N{n_rows}")


def iterated_matmul_dag(n: int = 20, iters: int = 4, nnz_per_row: int = 3,
                        seed: int = 0) -> Dag:
    """x <- A x repeated: exp_N*_K* graphs of the HyperDAG DB."""
    rng = np.random.default_rng(seed)
    rows = _rand_sparse_rows(n, nnz_per_row, rng)
    edges = []
    cur = list(range(n))
    nid = n
    for _ in range(iters):
        nxt = []
        for i, cols in enumerate(rows):
            for j in cols:
                edges.append((cur[j], nid))
            nxt.append(nid)
            nid += 1
        cur = nxt
    return Dag(n=nid, edge_list=edges, name=f"exp_N{n}_K{iters}")


def cg_dag(n: int = 20, iters: int = 4, nnz_per_row: int = 3, seed: int = 0) -> Dag:
    """Conjugate-gradient-like iteration: SpMV + two reductions + axpy."""
    rng = np.random.default_rng(seed)
    rows = _rand_sparse_rows(n, nnz_per_row, rng)
    edges = []
    x = list(range(n))
    nid = n
    for _ in range(iters):
        # SpMV
        y = []
        for i, cols in enumerate(rows):
            for j in cols:
                edges.append((x[j], nid))
            y.append(nid)
            nid += 1
        # global reduction (dot product) as a binary tree
        layer = y
        while len(layer) > 1:
            nxt = []
            for a in range(0, len(layer) - 1, 2):
                edges.append((layer[a], nid))
                edges.append((layer[a + 1], nid))
                nxt.append(nid)
                nid += 1
            if len(layer) % 2:
                nxt.append(layer[-1])
            layer = nxt
        dot = layer[0]
        # axpy: new x depends on old x, y and the scalar
        x2 = []
        for i in range(n):
            edges.append((x[i], nid))
            edges.append((y[i], nid))
            edges.append((dot, nid))
            x2.append(nid)
            nid += 1
        x = x2
    return Dag(n=nid, edge_list=edges, name=f"CG_N{n}_K{iters}")


def knn_dag(n: int = 30, k: int = 4, iters: int = 3, seed: int = 0) -> Dag:
    """k-NN style: each new value depends on k nearest previous values."""
    rng = np.random.default_rng(seed)
    edges = []
    cur = list(range(n))
    nid = n
    for _ in range(iters):
        nxt = []
        for i in range(n):
            window = np.clip(np.arange(i - k - 2, i + k + 3), 0, n - 1)
            window = np.unique(window)
            nbrs = set(rng.choice(window, size=min(k, len(window)),
                                  replace=False).tolist())
            nbrs.add(i)
            for j in nbrs:
                edges.append((cur[j], nid))
            nxt.append(nid)
            nid += 1
        cur = nxt
    return Dag(n=nid, edge_list=edges, name=f"kNN_N{n}_K{iters}")


def sptrsv_dag(n: int = 800, band: int = 32, fill: float = 0.0,
               seed: int = 0, p_cross: float = 0.06) -> Dag:
    """Lower-triangular solve dependencies with supernodal structure: rows
    form ``band`` interleaved strands (the paper's application matrices
    come from elimination trees with many independent subtrees).  A row
    depends on the previous 1-2 rows of its own strand plus occasional
    cross-strand couplings -- wavefront depth ~ n/band, ancestor cones stay
    sparse, so both parallelism and communication pressure are realistic."""
    rng = np.random.default_rng(seed)
    strands = band
    edges = set()
    for i in range(strands, n):
        edges.add((i - strands, i))            # own strand
        if rng.random() < 0.35 and i - 2 * strands >= 0:
            edges.add((i - 2 * strands, i))
        if rng.random() < p_cross:             # cross-strand coupling
            off = int(rng.integers(1, strands))
            j = i - off
            if j >= 0:
                edges.add((j, i))
        if fill and rng.random() < fill:
            j = int(rng.integers(0, i))
            edges.add((j, i))
    return Dag(n=n, edge_list=sorted(edges), name=f"sptrsv_{n}")


def psdd_dag(n_leaves: int = 200, depth: int = 14, seed: int = 0) -> Dag:
    """Irregular arithmetic circuit: random sum/product units over earlier
    units, fan-in 2 (products) or 2-4 (sums), single root-ish top layer."""
    rng = np.random.default_rng(seed)
    edges = []
    nodes = list(range(n_leaves))
    nid = n_leaves
    per_layer = max(8, n_leaves // 2)
    for d in range(depth):
        layer_size = max(4, int(per_layer * (0.85 ** d)))
        new = []
        lo = max(0, len(nodes) - 3 * per_layer)
        for _ in range(layer_size):
            fanin = 2 if rng.random() < 0.6 else int(rng.integers(2, 5))
            srcs = rng.choice(np.arange(lo, len(nodes)), size=min(fanin, len(nodes) - lo),
                              replace=False)
            for s in srcs:
                edges.append((int(nodes[s]), nid))
            new.append(nid)
            nid += 1
        nodes.extend(new)
    return Dag(n=nid, edge_list=edges, name=f"psdd_{nid}")


# ------------------------------------------------------ streaming generators
# Flat-numpy builders for multilevel-scale instances (mirroring
# ``spmv.large_row_net``): the per-row python loops of ``sptrsv_dag`` /
# ``psdd_dag`` spend seconds in rng calls and tuple churn at n = 100k;
# these draw every random decision as one vectorized batch and construct
# the Dag through ``Dag.from_arrays`` -- n = 100k builds in well under a
# second.  Same structural mix as the loop generators, parameterized the
# same way; n and seed are the knobs the scale benchmarks sweep.

def large_sptrsv_dag(n: int = 100_000, band: int = 48, fill: float = 0.0,
                     seed: int = 0, p_cross: float = 0.06) -> Dag:
    """Streaming ``sptrsv_dag``: banded strands + probabilistic second
    in-strand edge + cross-strand couplings + optional random fill, all as
    flat coordinate arrays."""
    rng = np.random.default_rng(seed)
    strands = band
    i = np.arange(strands, n, dtype=np.int64)
    srcs = [i - strands]
    dsts = [i]
    sel = i[(rng.random(len(i)) < 0.35) & (i >= 2 * strands)]
    srcs.append(sel - 2 * strands)
    dsts.append(sel)
    sel = i[rng.random(len(i)) < p_cross]
    off = rng.integers(1, strands, size=len(sel))
    keep = sel - off >= 0
    srcs.append(sel[keep] - off[keep])
    dsts.append(sel[keep])
    if fill:
        sel = i[rng.random(len(i)) < fill]
        j = np.floor(rng.random(len(sel)) * sel).astype(np.int64)
        srcs.append(j)
        dsts.append(sel)
    return Dag.from_arrays(n, np.concatenate(srcs), np.concatenate(dsts),
                           name=f"sptrsv_large_{n}")


def large_psdd_dag(n_leaves: int = 25_000, depth: int = 16,
                   seed: int = 0) -> Dag:
    """Streaming ``psdd_dag``: the same layered sum/product circuit shape
    (decaying layer sizes, fan-in 2 or 2-4, sources drawn from a recency
    window), one vectorized draw per layer; duplicate (child, source)
    picks collapse in the ``from_arrays`` dedup (slightly shrinking the
    occasional fan-in, as ``rng.choice(replace=False)`` would avoid)."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    nid = n_leaves
    per_layer = max(8, n_leaves // 2)
    for d in range(depth):
        layer_size = max(4, int(per_layer * (0.85 ** d)))
        lo = max(0, nid - 3 * per_layer)
        fanin = np.where(rng.random(layer_size) < 0.6, 2,
                         rng.integers(2, 5, size=layer_size))
        fanin = np.minimum(fanin, nid - lo)
        new = np.arange(nid, nid + layer_size, dtype=np.int64)
        dsts.append(np.repeat(new, fanin))
        srcs.append(rng.integers(lo, nid, size=int(fanin.sum()),
                                 dtype=np.int64))
        nid += layer_size
    return Dag.from_arrays(nid, np.concatenate(srcs), np.concatenate(dsts),
                           name=f"psdd_large_{nid}")


def hdb_dataset(scale: int = 1, seed: int = 0) -> list[Dag]:
    """Mixed hdb-like set (SpMV / CG / kNN / iterated matmul)."""
    out = [
        spmv_dag(n_rows=60 * scale, seed=seed),
        spmv_dag(n_rows=90 * scale, seed=seed + 1),
        iterated_matmul_dag(n=30 * scale, iters=4, seed=seed + 2),
        iterated_matmul_dag(n=40 * scale, iters=5, seed=seed + 3),
        cg_dag(n=16 * scale, iters=4, seed=seed + 4),
        cg_dag(n=24 * scale, iters=5, seed=seed + 5),
        knn_dag(n=40 * scale, k=4, iters=4, seed=seed + 6),
        knn_dag(n=50 * scale, k=5, iters=5, seed=seed + 7),
    ]
    return out


def sptrsv_dataset(scale: int = 1, seed: int = 0) -> list[Dag]:
    return [sptrsv_dag(n=n * scale, band=b, seed=seed + i)
            for i, (n, b) in enumerate([(600, 24), (800, 32), (1000, 32),
                                        (1200, 40), (1500, 48)])]


def psdd_dataset(scale: int = 1, seed: int = 0) -> list[Dag]:
    return [psdd_dag(n_leaves=nl * scale, depth=d, seed=seed + i)
            for i, (nl, d) in enumerate([(150, 10), (200, 12), (250, 14),
                                         (300, 12), (350, 16)])]


def tiny_dataset(seed: int = 0) -> list[Dag]:
    """40-80-node DAGs for the exact-vs-heuristic comparison (§C.2.2)."""
    out = []
    rng = np.random.default_rng(seed)
    for i in range(8):
        kind = i % 4
        if kind == 0:
            d = spmv_dag(n_rows=int(rng.integers(8, 14)), seed=seed + i)
        elif kind == 1:
            d = iterated_matmul_dag(n=int(rng.integers(8, 12)), iters=3, seed=seed + i)
        elif kind == 2:
            d = knn_dag(n=int(rng.integers(8, 12)), k=3, iters=2, seed=seed + i)
        else:
            d = psdd_dag(n_leaves=16, depth=4, seed=seed + i)
        out.append(d)
    return out

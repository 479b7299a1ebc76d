"""SpMV hypergraphs: fine-grained and row-net models (paper §3.2, §B.1).

The paper samples application matrices from SuiteSparse; offline we generate
sparse matrices with application-like structure (banded diagonals + random
off-band fill + a few dense rows/columns, the patterns partitioners care
about) and apply the two standard hypergraph constructions:

  * fine-grained [24, 27]: one node per non-zero; one hyperedge per row and
    one per column, connecting the non-zeros it contains;
  * row-net [10]: one node per column (weight = its non-zero count); one
    hyperedge per row, connecting the columns with a non-zero in that row.
"""
from __future__ import annotations

import numpy as np

from ..core.hypergraph import Hypergraph


def synthetic_sparse_matrix(n_rows: int, n_cols: int, seed: int = 0,
                            band: int = 3, fill: float = 0.01,
                            n_dense: int = 2) -> list[tuple[int, int]]:
    """Return the non-zero coordinate list of an application-like matrix."""
    rng = np.random.default_rng(seed)
    nz: set[tuple[int, int]] = set()
    # banded structure (stencil-like applications)
    for i in range(n_rows):
        for off in range(-band, band + 1):
            j = i + off
            if 0 <= j < n_cols and rng.random() < 0.7:
                nz.add((i, j))
    # random fill (irregular coupling)
    n_fill = int(fill * n_rows * n_cols)
    rows = rng.integers(0, n_rows, size=n_fill)
    cols = rng.integers(0, n_cols, size=n_fill)
    nz.update(zip(rows.tolist(), cols.tolist()))
    # a few dense rows/columns (constraints, hubs)
    for _ in range(n_dense):
        r = int(rng.integers(0, n_rows))
        for j in rng.choice(n_cols, size=max(2, n_cols // 6), replace=False):
            nz.add((r, int(j)))
        c = int(rng.integers(0, n_cols))
        for i in rng.choice(n_rows, size=max(2, n_rows // 6), replace=False):
            nz.add((int(i), c))
    return sorted(nz)


def fine_grained_hypergraph(nz: list[tuple[int, int]], name: str = "spmv_fg") -> Hypergraph:
    n = len(nz)
    rows: dict[int, list[int]] = {}
    cols: dict[int, list[int]] = {}
    for idx, (i, j) in enumerate(nz):
        rows.setdefault(i, []).append(idx)
        cols.setdefault(j, []).append(idx)
    edges = [tuple(v) for v in rows.values() if len(v) >= 2]
    edges += [tuple(v) for v in cols.values() if len(v) >= 2]
    return Hypergraph(n=n, edges=edges, name=name).remove_isolated()


def row_net_hypergraph(nz: list[tuple[int, int]], n_cols: int,
                       name: str = "spmv_rn") -> Hypergraph:
    rows: dict[int, list[int]] = {}
    col_nnz = np.zeros(n_cols, dtype=np.float64)
    for (i, j) in nz:
        rows.setdefault(i, []).append(j)
        col_nnz[j] += 1
    edges = [tuple(sorted(set(v))) for v in rows.values() if len(set(v)) >= 2]
    omega = np.maximum(col_nnz, 1.0)  # node weight = nnz in the column [10]
    return Hypergraph(n=n_cols, edges=edges, omega=omega, name=name).remove_isolated()


def large_row_net(n: int, seed: int = 0, band: int = 3,
                  fill_per_row: float = 2.0, n_dense: int = 2,
                  dense_len: int = 256,
                  name: str | None = None,
                  chunk_rows: int | None = None,
                  alloc=None) -> Hypergraph:
    """Streaming row-net generator for multilevel-scale instances.

    ``synthetic_sparse_matrix`` materializes a python set of (i, j) pairs
    and its ``fill`` fraction scales with n^2 -- at n = 65536 that is tens
    of millions of python tuples before the hypergraph even exists.  This
    generator keeps the same structural mix (band + random fill + a few
    dense rows/columns) but parameterized *per row* (``fill_per_row``
    non-zeros of random fill per row, dense rows/columns capped at
    ``dense_len``), and builds everything as flat numpy coordinate arrays
    emitted straight as a CSR ``Hypergraph`` (no per-edge tuples at all).
    n = 65536 builds in a couple of seconds; n and seed are the knobs the
    scale benchmarks sweep.

    ``chunk_rows`` bounds the dedup working set: the i*n + j key space is
    partitioned by row ranges, each range deduped/sorted on its own, and
    the per-range results concatenated -- bit-identical to the one-shot
    ``np.unique`` (row-major key order is preserved across ranges), so the
    default (one shot) and chunked paths produce the same hypergraph.

    ``alloc(shape, dtype)``, when given, allocates the output CSR arrays
    (``xpins``/``pins``/``omega``) -- pass ``ShmRegistry.alloc`` and a
    ~10^7-pin instance lands directly in shared memory, never copied again
    for the worker pool.
    """
    if alloc is None:
        alloc = np.zeros
    rng = np.random.default_rng(seed)
    coords = []
    # banded structure, each diagonal kept with prob 0.7 (as the seed gen)
    for off in range(-band, band + 1):
        i = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        i = i[rng.random(len(i)) < 0.7]
        coords.append(np.stack([i, i + off]))
    # random fill (irregular coupling), ~fill_per_row nz per row
    n_fill = int(fill_per_row * n)
    coords.append(np.stack([rng.integers(0, n, size=n_fill, dtype=np.int64),
                            rng.integers(0, n, size=n_fill, dtype=np.int64)]))
    # a few dense rows/columns (constraints, hubs), capped length
    k = max(2, min(dense_len, n // 6))
    for _ in range(n_dense):
        r = int(rng.integers(0, n))
        cols = rng.choice(n, size=k, replace=False).astype(np.int64)
        coords.append(np.stack([np.full(k, r, dtype=np.int64), cols]))
        c = int(rng.integers(0, n))
        rows_d = rng.choice(n, size=k, replace=False).astype(np.int64)
        coords.append(np.stack([rows_d, np.full(k, c, dtype=np.int64)]))
    ij = np.concatenate(coords, axis=1)
    keys = ij[0] * np.int64(n) + ij[1]
    if chunk_rows is None or chunk_rows >= n:
        flat = np.unique(keys)          # dedup + row-major sort, one shot
    else:
        # partitioned key space: rows [lo, hi) own keys [lo*n, hi*n), so
        # per-range uniques concatenate into exactly the global unique
        parts = []
        for lo in range(0, n, int(chunk_rows)):
            hi = min(lo + int(chunk_rows), n)
            sel = (ij[0] >= lo) & (ij[0] < hi)
            if sel.any():
                parts.append(np.unique(keys[sel]))
        flat = np.concatenate(parts)
    i_arr, j_arr = flat // n, flat % n
    # row-net model: nodes = columns (weight = nnz), edges = rows with >= 2
    # distinct columns; isolated columns dropped (cf. row_net_hypergraph)
    col_nnz = np.bincount(j_arr, minlength=n)
    row_len = np.bincount(i_arr, minlength=n)
    keep = row_len[i_arr] >= 2
    i_arr, j_arr = i_arr[keep], j_arr[keep]
    used = np.unique(j_arr)   # columns appearing in some kept edge
    remap = np.zeros(n, dtype=np.int64)
    remap[used] = np.arange(len(used), dtype=np.int64)
    # CSR straight out: i_arr is sorted, runs of equal i are the edges (and
    # j ascends within a run, so ``presorted`` pin order holds); the output
    # arrays come from ``alloc`` so they can live in shared memory
    first = np.ones(len(i_arr), dtype=bool)
    first[1:] = i_arr[1:] != i_arr[:-1]
    starts = np.flatnonzero(first)
    lens = np.diff(np.append(starts, len(i_arr)))
    xpins = alloc(len(starts) + 1, np.int64)
    np.cumsum(lens, out=xpins[1:])
    pins = alloc(len(j_arr), np.int64)
    pins[:] = remap[j_arr]
    omega = alloc(len(used), np.float64)
    omega[:] = np.maximum(col_nnz[used], 1.0)
    return Hypergraph.from_csr(len(used), xpins, pins, omega=omega,
                               name=name or f"spmv_rn_large_{n}")


def spmv_dataset(kind: str = "fg", count: int = 10, seed: int = 0,
                 sizes: tuple[int, int] = (30, 90)) -> list[Hypergraph]:
    """A dataset of `count` instances with paper-like size spread."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        m = int(rng.integers(sizes[0], sizes[1]))
        nz = synthetic_sparse_matrix(m, m, seed=seed * 1000 + k)
        if kind == "fg":
            out.append(fine_grained_hypergraph(nz, name=f"spmv_fg_{k}"))
        else:
            out.append(row_net_hypergraph(nz, m, name=f"spmv_rn_{k}"))
    return out

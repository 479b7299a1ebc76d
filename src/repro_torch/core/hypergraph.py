"""Hypergraph data structure for partitioning.

These mirror the paper's Section 3 definitions:
  * a hypergraph is (V, E) with each e in E a subset of V; a (v, e) pair with
    v in e is a *pin*;
  * node weights ``omega`` express compute cost, hyperedge weights ``mu``
    express communicated data size (both default to 1).

The scheduling side's ``Dag`` is not part of this package yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# Bound (pins) on the per-block scratch of one ``Hypergraph.contract``
# dedup/collapse block.  Blocks never split an edge, and both the run-length
# dedup and the hash grouping are per-edge computations, so blocking cannot
# change any output byte -- it only caps the transient (order, edge-of-pin)
# arrays so the fine instance is never materialized twice (the out-of-core
# half of the process-parallel V-cycle).
_CONTRACT_CHUNK_PINS = 4_000_000


class _CsrEdgeView(Sequence):
    """Read-only ``edges`` sequence backed by CSR arrays (no python tuples).

    ``Hypergraph.from_csr`` stores this in place of the edge-tuple list so a
    10^7-pin instance never materializes per-edge python objects; indexing
    still yields plain tuples, and equality against any sequence of tuples
    (or another view) is element-wise, so existing callers and tests see a
    list-compatible object.  Segments must be sorted, deduplicated and
    in-range -- the ``presorted=True`` contract.
    """

    __slots__ = ("xpins", "pins")

    def __init__(self, xpins: np.ndarray, pins: np.ndarray) -> None:
        self.xpins = xpins
        self.pins = pins

    def __len__(self) -> int:
        return len(self.xpins) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return tuple(self.pins[self.xpins[i]:self.xpins[i + 1]].tolist())

    def __iter__(self):
        x = self.xpins
        for i in range(len(self)):
            yield tuple(self.pins[x[i]:x[i + 1]].tolist())

    def __eq__(self, other):
        if isinstance(other, _CsrEdgeView):
            return (np.array_equal(self.xpins, other.xpins)
                    and np.array_equal(self.pins, other.pins))
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __repr__(self) -> str:
        return f"<CsrEdgeView m={len(self)} pins={len(self.pins)}>"

    # __slots__ classes need explicit pickle support (spawn-start workers)
    def __getstate__(self):
        return (self.xpins, self.pins)

    def __setstate__(self, state):
        self.xpins, self.pins = state


@dataclasses.dataclass
class Hypergraph:
    n: int
    edges: list[tuple[int, ...]]
    omega: np.ndarray | None = None  # node weights, shape (n,)
    mu: np.ndarray | None = None     # hyperedge weights, shape (len(edges),)
    name: str = "hypergraph"
    # edges already sorted, deduplicated tuples of in-range ints: skip the
    # per-edge python normalization pass (used by vectorized constructors --
    # ``contract`` and the streaming datagen -- where it would dominate)
    presorted: bool = False

    def __post_init__(self) -> None:
        if self.omega is None:
            self.omega = np.ones(self.n, dtype=np.float64)
        else:
            self.omega = np.asarray(self.omega, dtype=np.float64)
        if self.mu is None:
            self.mu = np.ones(len(self.edges), dtype=np.float64)
        else:
            self.mu = np.asarray(self.mu, dtype=np.float64)
        if not self.presorted:
            self.edges = [tuple(sorted(set(e))) for e in self.edges]
            for e in self.edges:
                if any(v < 0 or v >= self.n for v in e):
                    raise ValueError(f"edge {e} out of range for n={self.n}")
        self._csr: tuple[np.ndarray, ...] | None = None

    @property
    def num_pins(self) -> int:
        if isinstance(self.edges, _CsrEdgeView):
            return len(self.edges.pins)
        return sum(len(e) for e in self.edges)

    # pickling (spawn-start workers): ship the instance without the lazy CSR
    # cache -- a 10^7-pin hypergraph pickled with it would carry every pin
    # twice, and the cache rebuilds deterministically from ``edges`` anyway
    # (for ``from_csr`` instances the edge view *is* the primary CSR, so
    # nothing is recomputed but the incidence/adjacency halves)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_csr"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._csr = None

    # ------------------------------------------------------------- CSR layout
    # Two cached compressed-sparse-row views of the pin relation; everything
    # in core/partition iterates these flat arrays instead of python lists.
    #   * edge -> pins:  pins[xpins[e] : xpins[e+1]]      (node ids)
    #   * node -> edges: inc_edges[xinc[v] : xinc[v+1]]   (edge ids)
    # ``edges`` must not be mutated after construction (the cache would go
    # stale); build a new Hypergraph instead.
    @classmethod
    def from_csr(cls, n: int, xpins: np.ndarray, pins: np.ndarray,
                 omega: np.ndarray | None = None,
                 mu: np.ndarray | None = None,
                 name: str = "hypergraph") -> "Hypergraph":
        """Vectorized constructor from a CSR edge layout (no edge tuples).

        ``pins[xpins[e] : xpins[e+1]]`` are edge e's pins, already sorted,
        deduplicated and in range (the ``presorted=True`` contract -- the
        streaming datagen and ``contract`` guarantee it).  The arrays are
        adopted, not copied, so shared-memory-backed inputs stay
        shared-memory-backed (the zero-copy half of the parallel layer).
        """
        xpins = np.asarray(xpins, dtype=np.int64)
        pins = np.asarray(pins, dtype=np.int64)
        return cls(n=n, edges=_CsrEdgeView(xpins, pins), omega=omega, mu=mu,
                   name=name, presorted=True)

    def _build_csr(self) -> tuple[np.ndarray, ...]:
        if self._csr is not None:
            return self._csr
        m = len(self.edges)
        if isinstance(self.edges, _CsrEdgeView):
            xpins, pins = self.edges.xpins, self.edges.pins
            lens = np.diff(xpins)
        else:
            lens = np.fromiter((len(e) for e in self.edges), dtype=np.int64,
                               count=m)
            xpins = np.zeros(m + 1, dtype=np.int64)
            np.cumsum(lens, out=xpins[1:])
            total = int(xpins[-1])
            pins = np.fromiter((v for e in self.edges for v in e),
                               dtype=np.int64, count=total)
        edge_of_pin = np.repeat(np.arange(m, dtype=np.int64), lens)
        order = np.argsort(pins, kind="stable")
        inc_edges = edge_of_pin[order]
        xinc = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(pins, minlength=self.n), out=xinc[1:])
        # pin-adjacency: for node v, the concatenated pins of its incident
        # edges (multiset, edge order) -- the BFS frontier of greedy growth.
        e_lens = lens[inc_edges]
        node_tot = np.zeros(self.n, dtype=np.int64)
        np.add.at(node_tot, pins, lens[edge_of_pin])
        xadj = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(node_tot, out=xadj[1:])
        if e_lens.sum():
            starts = xpins[inc_edges]
            offs = np.arange(int(e_lens.sum()), dtype=np.int64)
            offs -= np.repeat(np.cumsum(e_lens) - e_lens, e_lens)
            adj = pins[np.repeat(starts, e_lens) + offs]
        else:
            adj = np.zeros(0, dtype=np.int64)
        self._csr = (xpins, pins, xinc, inc_edges, xadj, adj)
        return self._csr

    @property
    def xpins(self) -> np.ndarray:
        return self._build_csr()[0]

    @property
    def pins(self) -> np.ndarray:
        return self._build_csr()[1]

    @property
    def xinc(self) -> np.ndarray:
        return self._build_csr()[2]

    @property
    def inc_edges(self) -> np.ndarray:
        return self._build_csr()[3]

    @property
    def xadj(self) -> np.ndarray:
        return self._build_csr()[4]

    @property
    def adj_nodes(self) -> np.ndarray:
        return self._build_csr()[5]

    # --------------------------------------------------- contraction layer
    # Multilevel coarsening support (multilevel V-cycle): given a
    # cluster map ``cmap`` (fine node -> coarse node id), ``contract``
    # builds the contracted hypergraph fully vectorized over the CSR pin
    # arrays and returns the edge prolongation map alongside it.  The node
    # prolongation map is ``cmap`` itself: coarse masks project to fine
    # masks as ``coarse_masks[cmap]`` (replication masks project as unions
    # -- every member of a cluster inherits the cluster's full mask, which
    # *is* the union since the cluster is one coarse node).
    def contract(self, cmap: np.ndarray, nc: int | None = None,
                 chunk_pins: int | None = None
                 ) -> tuple["Hypergraph", np.ndarray]:
        """Contract clusters of nodes into single coarse nodes.

        ``cmap[v]`` is the coarse id of fine node v (0 <= cmap[v] < nc).
        Coarse node weights are the cluster sums of ``omega``.  Each fine
        edge maps its pins through ``cmap`` and deduplicates; edges left
        with fewer than two distinct coarse pins are dropped (their
        ``lambda`` is at most 1 under any assignment, so they can never
        cost anything), and edges with *identical* coarse pin sets collapse
        into one coarse edge whose ``mu`` is their sum (identical-net
        collapsing).  Returns ``(coarse, edge_map)`` with ``edge_map[e]``
        the coarse edge id of fine edge e, or -1 if it was dropped.

        The pin dedup streams over edge-range blocks of at most
        ``chunk_pins`` pins (default ``_CONTRACT_CHUNK_PINS``; an edge is
        never split), so the transient sort scratch stays bounded and the
        fine pin expansion is never held twice -- blocking is invisible in
        the output.  Identical-net collapsing is a dual-64-bit polynomial
        hash grouping with exact verification against each group's
        representative segment; any verification miss (probability ~2^-128)
        falls back to the byte-key dict path, so the result is always exact.

        Cost identity (the multilevel contract): for any coarse masks ``M``
        the fine cost of the projected masks ``M[cmap]`` equals the coarse
        cost of ``M``, and the per-processor loads agree exactly -- see
        ``PartitionState.from_projection`` and ``tests/test_multilevel.py``.
        """
        cmap = np.asarray(cmap, dtype=np.int64)
        if cmap.shape != (self.n,):
            raise ValueError("cmap must have shape (n,)")
        if nc is None:
            nc = int(cmap.max()) + 1 if self.n else 0
        if self.n and (cmap.min() < 0 or cmap.max() >= nc):
            raise ValueError("cmap out of range")
        omega_c = np.bincount(cmap, weights=self.omega, minlength=nc)
        m = len(self.edges)
        edge_map = np.full(m, -1, dtype=np.int64)
        if m == 0:
            coarse = Hypergraph(n=nc, edges=[], omega=omega_c,
                                mu=np.zeros(0), name=f"{self.name}_c",
                                presorted=True)
            return coarse, edge_map
        xpins, pins = self.xpins, self.pins
        lens = np.diff(xpins)
        chunk = (_CONTRACT_CHUNK_PINS if chunk_pins is None
                 else max(int(chunk_pins), 1))
        # sort pins within each edge by coarse id, keep first of each run --
        # streamed: lexsort keys on (edge, coarse pin) segment by edge, so
        # per-block results concatenate to exactly the monolithic output
        lens_c = np.zeros(m, dtype=np.int64)
        cp_parts: list[np.ndarray] = []
        e0 = 0
        while e0 < m:
            e1 = int(np.searchsorted(xpins, xpins[e0] + chunk,
                                     side="right")) - 1
            e1 = min(max(e1, e0 + 1), m)
            cp_b = cmap[pins[xpins[e0]:xpins[e1]]]
            ep_b = np.repeat(np.arange(e0, e1, dtype=np.int64),
                             lens[e0:e1]) - e0
            order = np.lexsort((cp_b, ep_b))
            ep_b, cp_b = ep_b[order], cp_b[order]
            first = np.ones(len(cp_b), dtype=bool)
            first[1:] = (ep_b[1:] != ep_b[:-1]) | (cp_b[1:] != cp_b[:-1])
            cp_parts.append(cp_b[first])
            lens_c[e0:e1] = np.bincount(ep_b[first], minlength=e1 - e0)
            e0 = e1
        cp = np.concatenate(cp_parts)
        xk = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(lens_c, out=xk[1:])
        kept = np.flatnonzero(lens_c >= 2)
        if not len(kept):
            coarse = Hypergraph(n=nc, edges=[], omega=omega_c,
                                mu=np.zeros(0), name=f"{self.name}_c",
                                presorted=True)
            return coarse, edge_map
        ids = _collapse_ids_hash(cp, xk, kept, lens_c[kept])
        if ids is None:  # dual-hash collision (~2^-128): exact dict path
            ids = _collapse_ids_dict(cp, xk, kept)
        edge_map[kept] = ids
        ncc = int(ids.max()) + 1
        # mu sums accumulate in ascending fine-edge order (bincount walks
        # the array in order), matching the dict path float-for-float
        mu_c = np.bincount(ids, weights=self.mu[kept], minlength=ncc)
        # coarse edge id -> its first (representative) fine edge; the
        # coarse CSR gathers each representative's deduped segment
        rep_fine = np.zeros(ncc, dtype=np.int64)
        rep_fine[ids[::-1]] = kept[::-1]          # first occurrence wins
        lens_cc = lens_c[rep_fine]
        xpins_c = np.zeros(ncc + 1, dtype=np.int64)
        np.cumsum(lens_cc, out=xpins_c[1:])
        total_c = int(xpins_c[-1])
        offs = (np.arange(total_c, dtype=np.int64)
                - np.repeat(xpins_c[:-1], lens_cc))
        pins_c = cp[np.repeat(xk[rep_fine], lens_cc) + offs]
        coarse = Hypergraph.from_csr(nc, xpins_c, pins_c, omega=omega_c,
                                     mu=mu_c, name=f"{self.name}_c")
        return coarse, edge_map

    def remove_isolated(self) -> "Hypergraph":
        """Drop nodes appearing in no hyperedge (paper §B.1 does the same)."""
        used = sorted({v for e in self.edges for v in e})
        remap = {v: i for i, v in enumerate(used)}
        edges = [tuple(remap[v] for v in e) for e in self.edges]
        return Hypergraph(
            n=len(used),
            edges=edges,
            omega=self.omega[used],
            mu=self.mu.copy(),
            name=self.name,
        )

    @staticmethod
    def from_graph(n: int, pairs: Iterable[tuple[int, int]], **kw) -> "Hypergraph":
        return Hypergraph(n=n, edges=[tuple(p) for p in pairs], **kw)


# odd multipliers of the dual wraparound polynomial hash (splitmix64-ish
# constants); two independent 64-bit hashes make an accidental group merge
# a ~2^-128 event, and the merge is *verified* before being trusted anyway
_HASH_M1 = np.uint64(0x9E3779B97F4A7C15)
_HASH_M2 = np.uint64(0xC2B2AE3D27D4EB4F)


def _collapse_ids_hash(cp: np.ndarray, xk: np.ndarray, kept: np.ndarray,
                       klens: np.ndarray) -> np.ndarray | None:
    """Identical-net group ids for the kept segments, or None on collision.

    Segments ``cp[xk[e] : xk[e] + klens]`` (sorted coarse pins) hash to a
    (length, h1, h2) key; equal-key runs are groups, each verified exactly
    against its first (smallest fine id) member.  Returned ids follow the
    first-fine-occurrence order of the dict path byte for byte.
    """
    K = len(kept)
    total = int(klens.sum())
    starts_flat = np.cumsum(klens) - klens
    offs = np.arange(total, dtype=np.int64) - np.repeat(starts_flat, klens)
    idx = np.repeat(xk[kept], klens) + offs
    vals = cp[idx].astype(np.uint64) + np.uint64(1)
    maxlen = int(klens.max())
    pows1 = np.ones(maxlen, dtype=np.uint64)
    pows1[1:] = _HASH_M1
    np.cumprod(pows1, out=pows1)                  # M1^pos mod 2^64
    pows2 = np.ones(maxlen, dtype=np.uint64)
    pows2[1:] = _HASH_M2
    np.cumprod(pows2, out=pows2)
    h1 = np.add.reduceat(vals * pows1[offs], starts_flat)
    h2 = np.add.reduceat(vals * pows2[offs], starts_flat)
    # group by (len, h1, h2); within a group, fine ids stay ascending
    order_h = np.lexsort((kept, h2, h1, klens))
    ks_len, ks_h1, ks_h2 = klens[order_h], h1[order_h], h2[order_h]
    new = np.ones(K, dtype=bool)
    new[1:] = ((ks_len[1:] != ks_len[:-1]) | (ks_h1[1:] != ks_h1[:-1])
               | (ks_h2[1:] != ks_h2[:-1]))
    gid = np.cumsum(new) - 1
    kept_sorted = kept[order_h]
    rep_sorted = kept_sorted[new]       # per group: its smallest fine id
    memb = np.flatnonzero(~new)         # non-representative members
    if len(memb):
        ln = ks_len[memb]
        tot = int(ln.sum())
        off2 = (np.arange(tot, dtype=np.int64)
                - np.repeat(np.cumsum(ln) - ln, ln))
        own = np.repeat(xk[kept_sorted[memb]], ln) + off2
        rep = np.repeat(xk[rep_sorted[gid[memb]]], ln) + off2
        if not np.array_equal(cp[own], cp[rep]):
            return None
    # coarse ids in first-fine-occurrence order == groups sorted by their
    # representative's fine id (the representative IS the first occurrence)
    order_g = np.argsort(rep_sorted, kind="stable")
    cid = np.empty(len(rep_sorted), dtype=np.int64)
    cid[order_g] = np.arange(len(rep_sorted), dtype=np.int64)
    ids = np.empty(K, dtype=np.int64)
    ids[order_h] = cid[gid]
    return ids


def _collapse_ids_dict(cp: np.ndarray, xk: np.ndarray,
                       kept: np.ndarray) -> np.ndarray:
    """Byte-key reference path of identical-net collapsing (exact, serial);
    also the fallback should the dual hash ever collide."""
    groups: dict[bytes, int] = {}
    ids = np.empty(len(kept), dtype=np.int64)
    for j, e in enumerate(kept):
        key = cp[xk[e]:xk[e + 1]].tobytes()
        idx = groups.get(key)
        if idx is None:
            idx = len(groups)
            groups[key] = idx
        ids[j] = idx
    return ids


def connected_components(hg: Hypergraph) -> list[list[int]]:
    parent = list(range(hg.n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in hg.edges:
        for v in e[1:]:
            ra, rb = find(e[0]), find(v)
            if ra != rb:
                parent[ra] = rb
    comps: dict[int, list[int]] = {}
    for v in range(hg.n):
        comps.setdefault(find(v), []).append(v)
    return list(comps.values())

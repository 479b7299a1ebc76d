"""Batched gain evaluation for the partition engine (frontier layer).

``price_mask_front`` evaluates a *ragged front* of candidate masks -- node
``vs[i]`` with candidates ``cands[xcand[i]:xcand[i+1]]`` -- in one
vectorized pass over the engine's CSR state, returning exactly what
``PartitionState.delta_masks`` would return per node, bit-for-bit: the
per-(candidate, edge) cost terms are summed sequentially in edge order
(``np.bincount``), the same reduction the engine uses, so a front of one
node and a front of a thousand produce identical floats.

Two interchangeable lambda backends (selected per call or via
``set_backend``):

  * ``"torch"`` (default): ``repro_torch.kernels.gain.min_cover_lambdas``
    -- the reduction as a hand-written CUDA kernel on ``device="cuda"``
    (its plain PyTorch version on ``device="cpu"``), on fronts of at least
    ``_DEVICE_MIN_ROWS`` rows;
  * ``"numpy"``: ``engine._lambda_from_rows`` on the host -- a single
    argmax over the popcount-ordered subset columns.

Lambdas are small integers, so both backends feed identical values into
the (float64, NumPy) cost reduction -- bit-equality holds across backends.
With the torch backend, ``device_pass`` hands whole refinement passes of
large integer-weight instances to ``kernels.front_pass``.

``GainCache`` sits on top: it memoizes each node's candidate deltas and
invalidates through the pin-adjacency on every applied move, so FM-style
passes reprice only nodes whose gain actually changed (output-sensitive)
and reprice them in batched fronts instead of one engine call per node.

Decision-identical refinements shared with the flat heuristics:
``connected_targets`` restricts candidate fronts to processors that appear
in another pin of a shared edge (moves toward unconnected processors
provably cannot strictly improve), front pricing exploits the
single-pin-change lambda bound (``_bounded_lambdas``: only popcount
classes ``lambda_old +- 1`` can hold the first zero cover), and
``lookahead_window`` adapts the GainCache scan window to the instance's
degree so dense instances do not thrash the cache.
"""
from __future__ import annotations

import numpy as np
import torch

from ..partition.engine import PartitionState, _lambda_from_rows

_BACKEND = "torch"

# cap on the (rows x 2^P) scratch of one evaluation chunk (elements);
# fronts beyond it are split on candidate boundaries, which cannot change
# any per-candidate sum
_CHUNK_ELEMS = 4_000_000

# the device backend only pays for itself on big fronts: below this row
# count dispatch dominates and the numpy reduction runs instead (the two
# produce bit-identical lambdas, so this is a pure scheduling choice)
_DEVICE_MIN_ROWS = 4096


def set_backend(backend: str) -> None:
    """Select the default lambda backend: ``"torch"`` or ``"numpy"``."""
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown frontier backend {backend!r}")
    global _BACKEND
    _BACKEND = backend


def get_backend() -> str:
    return _BACKEND


def check_device(backend: str | None, device: str | torch.device) -> None:
    """Raise when the torch backend is asked for a CUDA device that this
    process does not have: the port never moves to the CPU on its own."""
    if (backend or _BACKEND) != "torch":
        return
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "frontier 'torch' on device 'cuda', but no CUDA device is "
            "available; pass device='cpu' for the plain PyTorch versions "
            "or frontier='numpy' for the host path")


def device_pass(state: PartitionState, cap: float, backend: str | None = None,
                device: str | torch.device = "cuda", **kw):
    """Device-resident whole-pass runner for the torch backend, or None.

    The per-front path ships one front to the device per priced node; the
    device-resident path (``kernels.front_pass``) keeps the engine state on
    ``device`` for an entire refinement pass with one host read per
    committed move.  Dispatch mirrors ``_lambdas``: the explicit
    ``frontier=`` argument wins, else the module default backend; anything
    but ``"torch"`` -- or an instance the device pass cannot hold
    bit-identically (too small, non-integer mu, unassigned nodes) --
    returns None and the caller keeps the numpy front path.
    """
    if backend is None:
        backend = _BACKEND
    if backend != "torch":
        return None
    from ...kernels.front_pass import attach
    return attach(state, cap, device=device, **kw)


def _ragged_gather(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat indices for concatenating ``arr[starts[i]:starts[i]+lens[i]]``."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    off = np.repeat(np.cumsum(lens) - lens, lens)
    return np.repeat(starts, lens) + (np.arange(total, dtype=np.int64) - off)


def _lambdas(rows: np.ndarray, state: PartitionState, backend: str,
             device: str | torch.device) -> np.ndarray:
    if backend == "torch" and rows.shape[0] >= _DEVICE_MIN_ROWS:
        from ...kernels import gain
        return gain.min_cover_lambdas(rows, state._order, state._order_pc,
                                      device=device)
    return _lambda_from_rows(rows, state._order, state._order_pc)


def price_mask_front(state: PartitionState, vs: np.ndarray, cands: np.ndarray,
                     xcand: np.ndarray, backend: str | None = None,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Cost deltas for a ragged candidate front, one vectorized pass.

    ``vs[i]`` gets candidates ``cands[xcand[i]:xcand[i+1]]``; the result is
    the flat float64 array equal (bit-for-bit) to concatenating
    ``state.delta_masks(vs[i], cands[xcand[i]:xcand[i+1]])`` per node.
    Requires the numpy engine backend (the python backend has no uncov
    matrix to batch over).
    """
    if state.backend != "numpy":
        raise ValueError("price_mask_front needs a numpy-backend PartitionState")
    backend = backend or _BACKEND
    vs = np.asarray(vs, dtype=np.int64)
    cands = np.asarray(cands, dtype=np.int64)
    xcand = np.asarray(xcand, dtype=np.int64)
    C = len(cands)
    out = np.zeros(C, dtype=np.float64)
    if C == 0 or len(vs) == 0:
        return out
    K = np.diff(xcand)                       # candidates per node
    node_of_pair = np.repeat(np.arange(len(vs), dtype=np.int64), K)
    deg = state.xinc[vs + 1] - state.xinc[vs]
    deg_of_pair = deg[node_of_pair]
    # rows for pair (i, c): uncov[e] + contrib[c] - contrib[old_i], for each
    # incident edge e of vs[i] -- contiguous per pair, edges in CSR order
    edge_rep = state.inc_edges[
        _ragged_gather(state.xinc[vs][node_of_pair], deg_of_pair)]
    old_rows = np.repeat(state.masks[vs][node_of_pair], deg_of_pair)
    cand_rows = np.repeat(cands, deg_of_pair)
    pair_ids = np.repeat(np.arange(C, dtype=np.int64), deg_of_pair)
    nsub = state._contrib.shape[0]
    chunk_rows = max(_CHUNK_ELEMS // nsub, 1)
    R = len(edge_rep)
    lam_old_all = state.edge_lambda[edge_rep]
    base_lam = np.maximum(lam_old_all.astype(np.float64) - 1, 0)
    order, order_pc = state._order, state._order_pc
    # popcount-class boundaries inside ``order`` (classes 1..P)
    bounds = np.searchsorted(order_pc, np.arange(int(order_pc[-1]) + 2))
    lo = 0
    while lo < R:
        hi = min(lo + chunk_rows, R)
        # never split a pair across chunks (the bincount below must see a
        # pair's terms in one sequential run)
        while hi < R and pair_ids[hi] == pair_ids[hi - 1]:
            hi += 1
        if nsub <= 64 or (backend == "torch" and hi - lo >= _DEVICE_MIN_ROWS):
            # small tables (P <= 6): the one-shot scan beats the grouped
            # bounded scan; torch: the device kernel takes full uncov rows.
            # Both produce bit-equal lambdas.
            rows = (state.uncov[edge_rep[lo:hi]]
                    + state._contrib[cand_rows[lo:hi]]
                    - state._contrib[old_rows[lo:hi]])
            lam = _lambdas(rows, state, backend, device)
        else:
            lam = _bounded_lambdas(state, edge_rep[lo:hi],
                                   cand_rows[lo:hi], old_rows[lo:hi],
                                   lam_old_all[lo:hi], order, bounds)
        terms = ((np.maximum(lam.astype(np.float64) - 1, 0) - base_lam[lo:hi])
                 * state.mu[edge_rep[lo:hi]])
        out += np.bincount(pair_ids[lo:hi], weights=terms, minlength=C)
        lo = hi
    return out


def _bounded_lambdas(state: PartitionState, er: np.ndarray,
                     cand: np.ndarray, old: np.ndarray,
                     lam_old: np.ndarray, order: np.ndarray,
                     bounds: np.ndarray) -> np.ndarray:
    """Candidate-row lambdas using the single-pin-change bound.

    Every front row is ``uncov[e]`` with exactly one pin's mask changed,
    and a one-pin change moves an edge's min cover by at most one:
    re-adding the pin to any cover of the remaining pins costs at most one
    extra processor (so ``lam_new <= lam_old + 1`` and, symmetrically,
    ``lam_old <= lam_new + 1``).  Only the popcount classes
    ``[lam_old - 1, lam_old + 1]`` of the subset order can therefore hold
    the first zero, so per ``lam_old`` group at most three classes are
    scanned (column 0 settles the no-assigned-pin case) -- identical
    integers to the full 2^P scan at a fraction of the work.
    """
    n_rows = len(er)
    lam = np.zeros(n_rows, dtype=np.int16)
    if n_rows == 0:
        return lam
    P_max = int(state._order_pc[-1])
    rows = state.uncov[er] + state._contrib[cand] - state._contrib[old]
    for k in np.unique(lam_old):
        idx = np.flatnonzero(lam_old == k)
        rem = idx
        for pc in range(max(int(k) - 1, 1), min(int(k) + 1, P_max) + 1):
            cols = order[bounds[pc]:bounds[pc + 1]]
            hit = (rows[np.ix_(rem, cols)] == 0).any(axis=1)
            lam[rem[hit]] = pc
            rem = rem[~hit]
            if not len(rem):
                break
        # rows still unresolved lost their last assigned pin (lambda 0)
    lam[rows[:, 0] == 0] = 0
    return lam


# --------------------------------------------------------------------------
# Candidate builders (vectorized): masks per node, ascending processor order
# --------------------------------------------------------------------------

def connected_targets(state: PartitionState, vs: np.ndarray) -> np.ndarray:
    """(len(vs), P) bools: q appears in another pin of an edge of ``vs[i]``.

    ``uncov[e, 0] > uncov[e, 1 << q]`` says some assigned pin of e carries
    q; for candidate processors (q outside the node's own mask) that pin
    is necessarily another node.  A mask change toward an *unconnected* q
    can never strictly improve: a cover of the changed edge that beats the
    old lambda would have to avoid the node's old mask entirely and enter
    through q, which costs a full extra processor unless q already hits
    some other pin.  Restricting candidate fronts to connected targets is
    therefore decision-identical and shrinks the priced volume by ~P/deg
    of the cut (pinned by ``tests/test_multilevel.py``).
    """
    P = state.P
    vs = np.asarray(vs, dtype=np.int64)
    out = np.zeros((len(vs), P), dtype=bool)
    if len(vs) == 0:
        return out
    deg = state.xinc[vs + 1] - state.xinc[vs]
    edges_rep = state.inc_edges[_ragged_gather(state.xinc[vs], deg)]
    if len(edges_rep) == 0:
        return out
    cols = np.concatenate(([0], np.int64(1) << np.arange(P, dtype=np.int64)))
    # outer-product gather: only the P+1 needed columns, never the full
    # (rows, 2^P) intermediate
    sub = state.uncov[edges_rep[:, None], cols[None, :]]
    haveq = sub[:, 1:] < sub[:, :1]
    nz = deg > 0
    starts = np.cumsum(deg) - deg
    out[nz] = np.logical_or.reduceat(haveq, starts[nz], axis=0)
    return out


def fm_move_candidates(state: PartitionState, vs: np.ndarray):
    """``move_candidates`` restricted to connected targets (the FM default
    builder): same ascending-q order, same deltas for every emitted
    candidate, decision-identical to the unrestricted front because every
    dropped candidate's delta is provably >= 0."""
    P = state.P
    vs = np.asarray(vs, dtype=np.int64)
    prim = np.zeros(len(vs), dtype=np.int64)
    m = state.masks[vs].copy()
    while np.any(m > 1):                      # primary = highest set bit
        gt = m > 1
        prim[gt] += 1
        m[gt] >>= 1
    targets = np.arange(P, dtype=np.int64)
    keep = (targets[None, :] != prim[:, None]) & connected_targets(state, vs)
    cands = np.broadcast_to(np.int64(1) << targets, (len(vs), P))[keep]
    xcand = np.zeros(len(vs) + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=xcand[1:])
    return cands, xcand


def move_candidates(state: PartitionState, vs: np.ndarray):
    """FM move front: for each single-assignment node, masks ``1 << q`` for
    every q except the current primary, ascending q (the deterministic
    tie-break order, see ``heuristic._fm_refine``)."""
    P = state.P
    vs = np.asarray(vs, dtype=np.int64)
    prim = np.zeros(len(vs), dtype=np.int64)
    m = state.masks[vs].copy()
    while np.any(m > 1):                      # primary = highest set bit
        gt = m > 1
        prim[gt] += 1
        m[gt] >>= 1
    targets = np.arange(P, dtype=np.int64)
    keep = targets[None, :] != prim[:, None]
    cands = np.broadcast_to(np.int64(1) << targets, (len(vs), P))[keep]
    xcand = np.zeros(len(vs) + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=xcand[1:])
    return cands, xcand


def add_replica_candidates(state: PartitionState, vs: np.ndarray):
    """Replication front: ``mask | (1 << q)`` for every unset q, ascending
    q -- the candidate order of ``replicate_local_search``'s add step."""
    P = state.P
    vs = np.asarray(vs, dtype=np.int64)
    m = state.masks[vs]
    targets = np.arange(P, dtype=np.int64)
    unset = (m[:, None] >> targets[None, :]) & 1 == 0
    cands = (m[:, None] | (np.int64(1) << targets)[None, :])[unset]
    xcand = np.zeros(len(vs) + 1, dtype=np.int64)
    np.cumsum(unset.sum(axis=1), out=xcand[1:])
    return cands, xcand


def connected_add_candidates(state: PartitionState, vs: np.ndarray):
    """``add_replica_candidates`` restricted to connected targets (the
    replication default builder): an added replica lowers some lambda only
    when the new processor already appears in another pin of a shared
    edge, so dropping unconnected targets is decision-identical."""
    P = state.P
    vs = np.asarray(vs, dtype=np.int64)
    m = state.masks[vs]
    targets = np.arange(P, dtype=np.int64)
    keep = (((m[:, None] >> targets[None, :]) & 1) == 0) \
        & connected_targets(state, vs)
    cands = (m[:, None] | (np.int64(1) << targets)[None, :])[keep]
    xcand = np.zeros(len(vs) + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=xcand[1:])
    return cands, xcand


class GainCache:
    """Output-sensitive per-node candidate deltas over a ``PartitionState``.

    ``cands_builder(state, vs) -> (cands, xcand)`` defines the (ordered)
    candidate rule; ``get(v)`` returns that node's ``(cands, deltas)``
    exactly as a fresh ``state.delta_masks`` call would produce them.  A
    node's entry goes stale only when the uncov row of one of its incident
    edges changes, i.e. when a node sharing a hyperedge with it (or the
    node itself) is re-assigned -- ``invalidate_move`` marks exactly that
    pin-adjacency set.  ``refresh_dirty`` reprices every stale node in one
    batched front, so a full FM pass touches clean nodes for free.
    """

    def __init__(self, state: PartitionState, cands_builder,
                 backend: str | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.state = state
        self.cands_builder = cands_builder
        self.backend = backend
        self.device = device
        n = state.hg.n
        self._dirty = np.ones(n, dtype=bool)
        self._cands: list = [None] * n
        self._deltas: list = [None] * n

    def _refresh(self, vs: np.ndarray) -> None:
        cands, xcand = self.cands_builder(self.state, vs)
        deltas = price_mask_front(self.state, vs, cands, xcand,
                                  backend=self.backend, device=self.device)
        for i, v in enumerate(vs):
            lo, hi = xcand[i], xcand[i + 1]
            self._cands[v] = cands[lo:hi]
            self._deltas[v] = deltas[lo:hi]
            self._dirty[v] = False

    def refresh_dirty(self) -> int:
        """Batch-reprice every stale node; returns how many were stale."""
        vs = np.flatnonzero(self._dirty)
        if len(vs):
            self._refresh(vs)
        return len(vs)

    def refresh_window(self, vs: np.ndarray) -> None:
        """Batch-reprice the stale subset of ``vs`` (permutation lookahead).

        Scan loops call this when they reach a stale node, passing the next
        W entries of their visit order: stale nodes about to be visited are
        repriced in one front instead of one engine call each.  A node
        re-dirtied by a later move is simply repriced again at its visit --
        values returned by ``get`` are always current-state exact.
        """
        vs = vs[self._dirty[vs]]
        if len(vs):
            self._refresh(vs)

    def get(self, v: int):
        """(cands, deltas) for node v, repricing lazily if stale."""
        if self._dirty[v]:
            self._refresh(np.array([v], dtype=np.int64))
        return self._cands[v], self._deltas[v]

    def is_dirty(self, v: int) -> bool:
        return bool(self._dirty[v])

    def invalidate_move(self, v: int) -> None:
        """Mark v and every node sharing a hyperedge with it stale."""
        hg = self.state.hg
        self._dirty[hg.adj_nodes[hg.xadj[v]:hg.xadj[v + 1]]] = True
        self._dirty[v] = True

    @property
    def dirty_count(self) -> int:
        return int(self._dirty.sum())


def refresh_boundary_window(cache: GainCache, perm: np.ndarray, i: int,
                            W: int) -> None:
    """Reprice the dirty *boundary* slice of ``perm[i:i + W]`` in one front.

    Single home of the scan loops' lookahead rule (fm_refine and
    replicate_local_search share it): nodes already clean keep their
    cached deltas, and interior nodes -- every incident edge at
    lambda <= 1 -- are skipped because their prices are never consulted
    (the visit loops skip them via the same boundary test).  Purely a
    batching choice; cached values stay exact either way.
    """
    st = cache.state
    xinc, inc_edges, elam = st.xinc, st.inc_edges, st.edge_lambda
    win = [u for u in (int(x) for x in perm[i:i + W])
           if cache.is_dirty(u) and xinc[u] < xinc[u + 1]
           and int(elam[inc_edges[xinc[u]:xinc[u + 1]]].max()) > 1]
    cache.refresh_window(np.asarray(win, dtype=np.int64))


def lookahead_window(state: PartitionState) -> int:
    """Permutation-lookahead width for ``GainCache`` scan loops.

    Purely a batching choice (cached values are exact regardless, so
    decisions cannot change): wide windows amortize numpy call overhead on
    low-degree instances, but on high-degree ones (coarse multilevel
    levels average hundreds of pins per node) a 64-node window prices tens
    of thousands of rows per cache miss, most re-dirtied before their
    visit.  Target a few thousand rows per window instead.
    """
    hg = state.hg
    rows_per_node = (len(state.pins) / max(hg.n, 1)) * max(state.P - 1, 1)
    return int(min(64, max(8, 4096 // max(int(rows_per_node), 1))))

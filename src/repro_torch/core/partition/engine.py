"""Incremental-gain partition engine (the FM-style core of this package).

The seed implementation re-ran exact set cover (``min_cover``) over every
incident hyperedge for each candidate move -- O(deg(v) * pins * 2^P) per
evaluation, which caps local search at toy instance sizes.  ``PartitionState``
maintains enough per-edge state to evaluate any single-node mask change in
O(deg(v) * 2^P) and apply/undo it in the same bound, with exact
``min_cover`` semantics (not the connectivity approximation classical FM
uses).

Representation
--------------
For each hyperedge ``e`` and each processor subset ``S`` (all ``2^P`` of
them) we keep

    uncov[e, S] = #\\{assigned pins v in e : masks[v] & S == 0\\}

i.e. the number of pins *not* covered by ``S``.  Then

    lambda_e = min\\{ popcount(S) : S != 0, uncov[e, S] == 0 \\}

which is exactly the minimum set cover of the pin masks (``uncov[e, 0]``
doubles as the count of assigned pins; unassigned pins -- mask 0 -- are
excluded, so the same state drives the exact solver's monotone lower bound
over partial assignments).  Changing one pin's mask from ``a`` to ``b``
adds the precomputed row ``contrib[b] - contrib[a]`` to ``uncov[e]``: a
table lookup plus a vector add of length ``2^P``.

Complexity (P constant): ``delta_*`` and ``apply`` are O(deg(v) * 2^P);
``undo`` is the same; construction is O(pins * 2^P).  Memory is
O(|E| * 2^P) for ``uncov`` plus the O(4^P) mask tables, which bounds the
engine to P <= 12 (the paper's experiments use P in {2, 4, 8}).

Invariants (asserted by ``check()``):
  * ``uncov`` matches a from-scratch count over current masks;
  * ``edge_lambda[e]`` equals ``min_cover`` of e's assigned pin masks;
  * ``cost == sum_e mu[e] * max(0, edge_lambda[e] - 1)``;
  * ``loads[p] == sum_{v: masks[v] has bit p} omega[v]``.
"""
from __future__ import annotations

import functools

import numpy as np

from ..hypergraph import Hypergraph

_MAX_P = 12


@functools.lru_cache(maxsize=None)
def _tables(P: int):
    """(popcnt, order, order_pc, contrib) for processor count P.

    ``order`` lists the non-empty subsets sorted by popcount (ties by
    value), so the first subset with ``uncov == 0`` is a minimum cover.
    ``contrib[m]`` is the row a pin with mask ``m`` adds to ``uncov``:
    zero for unassigned pins, else ``1 - (m & S != 0)`` over all S.
    """
    if P < 1 or P > _MAX_P:
        raise ValueError(f"engine supports 1 <= P <= {_MAX_P}, got {P}")
    nsub = 1 << P
    subsets = np.arange(nsub)
    popcnt = np.array([bin(s).count("1") for s in range(nsub)], dtype=np.int16)
    order = np.array(sorted(range(1, nsub), key=lambda s: (popcnt[s], s)),
                     dtype=np.int64)
    hits = (subsets[:, None] & subsets[None, :]) != 0        # hits[m, S]
    contrib = (1 - hits.astype(np.int16))
    contrib[0] = 0                                           # mask 0 = unassigned
    return popcnt, order, popcnt[order], contrib


# cap on the (pins x 2^P) gather scratch of one _uncov_rows block
# (elements): construction memory stays bounded at any instance size, which
# is what keeps fresh PartitionState builds from projected masks cheap at
# multilevel scale (n=65536 would otherwise materialize a multi-hundred-MB
# intermediate).  Integer sums are associative, so blocking cannot change
# any row.
_UNCOV_CHUNK_ELEMS = 4_000_000


def _uncov_rows(masks: np.ndarray, pins: np.ndarray, xpins: np.ndarray,
                contrib: np.ndarray) -> np.ndarray:
    """uncov matrix (|E|, 2^P): per edge, sum of its pins' contrib rows.

    Single home of the reduceat segmentation, shared by the engine and the
    batch cost path.  Empty edges (including trailing ones, whose start
    index would fall off the pins array) come out as all-zero rows.
    Processes edges in blocks of at most ``_UNCOV_CHUNK_ELEMS`` scratch
    elements (never splitting an edge), so peak memory is bounded.
    """
    m = len(xpins) - 1
    nsub = contrib.shape[0]
    rows = np.zeros((m, nsub), dtype=np.int32)
    if m == 0 or len(pins) == 0:
        return rows
    # reduceat over non-empty edges only: their starts are strictly
    # increasing and in range, and consecutive non-empty starts delimit
    # exactly one edge's pins (empty edges contribute no pins in between)
    nonempty = xpins[:-1] < xpins[1:]
    chunk_pins = max(_UNCOV_CHUNK_ELEMS // nsub, 1)
    e0 = 0
    while e0 < m:
        # last edge fully contained in the pin budget (at least one edge)
        e1 = int(np.searchsorted(xpins, xpins[e0] + chunk_pins,
                                 side="right")) - 1
        e1 = min(max(e1, e0 + 1), m)
        ne = nonempty[e0:e1]
        if ne.any():
            seg = contrib[masks[pins[xpins[e0]:xpins[e1]]]]
            rows[e0:e1][ne] = np.add.reduceat(
                seg, xpins[e0:e1][ne] - xpins[e0], axis=0)
        e0 = e1
    return rows


def _lambda_from_rows(rows: np.ndarray, order: np.ndarray,
                      order_pc: np.ndarray) -> np.ndarray:
    """Min-cover size per uncov row (0 for rows with no assigned pin).

    Scans the popcount classes of ``order`` smallest-first and retires a
    row at the first class containing a zero -- in a refined partition
    almost every edge has lambda 1 or 2, so most rows only ever touch the
    P singleton columns instead of all 2^P - 1 (output identical to the
    full scan: the value is the *popcount* of the first zero subset, which
    any zero inside the class determines).  For small tables (P <= 6) the
    one-shot argmax over all columns is cheaper than the class loop.
    """
    m = rows.shape[0]
    if m == 0:
        return np.zeros(0, dtype=np.int16)
    if len(order) <= 63:  # P <= 6: full scan is a single vectorized op
        lam = order_pc[np.argmax(rows[:, order] == 0, axis=1)].astype(np.int16)
        lam[rows[:, 0] == 0] = 0
        return lam
    lam = np.zeros(m, dtype=np.int16)
    remaining = np.arange(m)
    # class boundaries: order_pc is sorted ascending (1, ..., P)
    bounds = np.searchsorted(order_pc, np.arange(order_pc[-1] + 2))
    for pc in range(1, int(order_pc[-1]) + 1):
        lo, hi = bounds[pc], bounds[pc + 1]
        hit = (rows[np.ix_(remaining, order[lo:hi])] == 0).any(axis=1)
        lam[remaining[hit]] = pc
        remaining = remaining[~hit]
        if not len(remaining):
            break
    lam[rows[:, 0] == 0] = 0
    return lam


class PartitionState:
    """Mutable partition assignment with O(degree) incremental costs.

    ``masks[v]`` is the processor bitmask of node v; 0 means *unassigned*
    (allowed -- the exact solver grows partial assignments through the same
    engine).  All ``delta_*`` methods are pure; ``apply`` mutates and pushes
    an undo record.

    Two interchangeable backends share the semantics:

      * ``backend='numpy'`` (default): ``uncov`` is one (|E|, 2^P) array and
        every operation is a few vectorized calls -- right for heuristic
        local search, where ``delta_masks`` prices many candidates at once;
      * ``backend='python'``: ``uncov`` rows are plain lists updated in
        pure python -- per-operation numpy dispatch (~microseconds) would
        dominate the branch-and-bound solver, which applies/undoes one tiny
        assignment per search node.
    """

    def __init__(self, hg: Hypergraph, P: int,
                 masks: np.ndarray | None = None,
                 backend: str = "numpy",
                 lambda_hint: np.ndarray | None = None) -> None:
        if backend not in ("numpy", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.hg = hg
        self.P = int(P)
        self.popcnt, self._order, self._order_pc, self._contrib = _tables(P)
        self.xpins = hg.xpins
        self.pins = hg.pins
        self.xinc = hg.xinc
        self.inc_edges = hg.inc_edges
        self.mu = np.asarray(hg.mu, dtype=np.float64)
        self.omega = np.asarray(hg.omega, dtype=np.float64)
        m = len(hg.edges)
        nsub = 1 << self.P
        if masks is None:
            self.masks = np.zeros(hg.n, dtype=np.int64)
        else:
            self.masks = np.asarray(masks, dtype=np.int64).copy()
            if self.masks.shape != (hg.n,):
                raise ValueError("masks must have shape (n,)")
            if np.any(self.masks < 0) or np.any(self.masks >= (1 << self.P)):
                raise ValueError("mask out of range for P")
        # uncov[e] = sum of contrib rows of e's pins  (vectorized build)
        self.uncov = _uncov_rows(self.masks, self.pins, self.xpins,
                                 self._contrib)
        if lambda_hint is not None:
            # caller-supplied per-edge lambdas (``from_projection``): must
            # equal what the subset scan would compute -- skipping the scan
            # is the single costly reduction of a from-masks build
            self.edge_lambda = np.asarray(lambda_hint, dtype=np.int16)
            if self.edge_lambda.shape != (m,):
                raise ValueError("lambda_hint must have shape (|E|,)")
        else:
            self.edge_lambda = self._lambda_rows(self.uncov)
        self.cost = float(
            (self.mu * np.maximum(self.edge_lambda - 1, 0)).sum())
        bits = (self.masks[:, None] >> np.arange(self.P)) & 1
        self.loads = (bits * self.omega[:, None]).sum(axis=0)
        self._undo: list[tuple[int, int, list | np.ndarray]] = []
        self._frames: list[int] = []
        self._dynamic = False
        # optional device mirror (kernels.front_pass.DevicePartitionPass):
        # when attached, every numpy-backend apply/undo forwards the
        # (v, old, new) mutation so the device buffers stay in lockstep
        self.device = None
        if backend == "python":
            # plain-python mirrors; the numpy arrays above are build-only
            self._uncov_l = self.uncov.tolist()
            self._lam_l = self.edge_lambda.tolist()
            self.uncov = None
            self.edge_lambda = None
            self._contrib_l = self._contrib.tolist()
            self._order_pairs = list(zip(self._order.tolist(),
                                         self._order_pc.tolist()))
            self._inc_l = [self.inc_edges[self.xinc[v]:self.xinc[v + 1]]
                           .tolist() for v in range(hg.n)]
            self._mu_l = self.mu.tolist()
            self._nsub = nsub
            self.loads = self.loads.tolist()
            self._omega_l = self.omega.tolist()

    # ------------------------------------------------------------- adoption
    @classmethod
    def from_arrays(cls, hg: Hypergraph, P: int, masks: np.ndarray,
                    uncov: np.ndarray, edge_lambda: np.ndarray,
                    loads: np.ndarray | None = None) -> "PartitionState":
        """Adopt prebuilt engine arrays without any rebuild (numpy backend).

        The process-parallel layer uses this twice over: workers slice the
        parent state's shared-memory ``uncov``/``edge_lambda`` rows for
        their shard's edges and resume refinement on them directly, and the
        parent re-adopts shared-memory copies of its own arrays so later
        mutations stay zero-copy visible.  The arrays are adopted, NOT
        copied (except ``loads``, which each side mutates privately) --
        callers own the aliasing discipline.  ``uncov``/``edge_lambda``
        must be consistent with ``masks`` over ``hg``'s edges; ``check()``
        verifies exactly that.
        """
        st = cls.__new__(cls)
        st.backend = "numpy"
        st.hg = hg
        st.P = int(P)
        st.popcnt, st._order, st._order_pc, st._contrib = _tables(P)
        st.xpins = hg.xpins
        st.pins = hg.pins
        st.xinc = hg.xinc
        st.inc_edges = hg.inc_edges
        st.mu = np.asarray(hg.mu, dtype=np.float64)
        st.omega = np.asarray(hg.omega, dtype=np.float64)
        st.masks = np.asarray(masks, dtype=np.int64)
        st.uncov = uncov
        st.edge_lambda = edge_lambda
        st.cost = float(
            (st.mu * np.maximum(st.edge_lambda - 1, 0)).sum())
        if loads is None:
            bits = (st.masks[:, None] >> np.arange(st.P)) & 1
            st.loads = (bits * st.omega[:, None]).sum(axis=0)
        else:
            st.loads = np.asarray(loads, dtype=np.float64).copy()
        st._undo = []
        st._frames = []
        st._dynamic = False
        st.device = None
        return st

    # ------------------------------------------------------------- projection
    @classmethod
    def from_projection(cls, hg: Hypergraph, P: int,
                        coarse_state: "PartitionState",
                        cmap: np.ndarray,
                        edge_map: np.ndarray) -> "PartitionState":
        """Fine-level state from a coarse state's masks, projected down.

        ``cmap``/``edge_map`` come from ``Hypergraph.contract`` (``hg`` is
        the *fine* hypergraph the coarse one was contracted from).  Fine
        masks are ``coarse_state.masks[cmap]`` -- replication masks project
        as unions, see ``Hypergraph.contract`` -- and because a fine edge's
        *distinct* pin-mask set equals its coarse image's, per-edge lambdas
        carry over verbatim: surviving edges reuse the coarse lambda, the
        dropped ones (single coarse pin) are 1 (0 if empty).  That skips
        the subset-order scan, the dominant term of a from-masks build; the
        uncov table itself is rebuilt blockwise (memory-bounded).

        The result is *bit-identical* to ``PartitionState(hg, P,
        masks=coarse_state.masks[cmap])`` -- same uncov, lambdas, cost and
        loads (property-tested by ``tests/test_multilevel.py``), which is
        the cost-exactness contract of the multilevel V-cycle: projection
        changes the level, never the cost.
        """
        cmap = np.asarray(cmap, dtype=np.int64)
        edge_map = np.asarray(edge_map, dtype=np.int64)
        masks = coarse_state.masks[cmap]
        m = len(hg.edges)
        lam = np.zeros(m, dtype=np.int16)
        kept = edge_map >= 0
        coarse_lam = (coarse_state.edge_lambda if coarse_state.backend ==
                      "numpy" else np.asarray(coarse_state._lam_l,
                                              dtype=np.int16))
        lam[kept] = coarse_lam[edge_map[kept]]
        # dropped non-empty edges sit inside one coarse node: every pin
        # shares that node's mask, so lambda is 1 (0 when unassigned)
        dropped = np.flatnonzero(~kept & (hg.xpins[1:] > hg.xpins[:-1]))
        if len(dropped):
            lam[dropped] = (masks[hg.pins[hg.xpins[dropped]]] != 0)
        return cls(hg, P, masks=masks, lambda_hint=lam)

    # ---------------------------------------------------------------- lambdas
    def _lambda_rows(self, rows: np.ndarray) -> np.ndarray:
        return _lambda_from_rows(rows, self._order, self._order_pc)

    def _incident(self, v: int) -> np.ndarray:
        return self.inc_edges[self.xinc[v]:self.xinc[v + 1]]

    # ------------------------------------------------- scalar (python) backend
    def _delta_py(self, v: int, new_mask: int) -> float:
        old = int(self.masks[v])
        if new_mask == old:
            return 0.0
        ca, cb = self._contrib_l[old], self._contrib_l[new_mask]
        d = 0.0
        for ei in self._inc_l[v]:
            row = self._uncov_l[ei]
            if row[0] + cb[0] - ca[0] == 0:
                lam_new = 0
            else:
                for s, pc in self._order_pairs:
                    if row[s] + cb[s] - ca[s] == 0:
                        lam_new = pc
                        break
            lam_old = self._lam_l[ei]
            d += self._mu_l[ei] * ((lam_new - 1 if lam_new else 0)
                                   - (lam_old - 1 if lam_old else 0))
        return d

    def _apply_py(self, v: int, new_mask: int) -> float:
        old = int(self.masks[v])
        inc = self._inc_l[v]
        self._undo.append((v, old, [self._lam_l[ei] for ei in inc]))
        if new_mask == old:
            return 0.0
        ca, cb = self._contrib_l[old], self._contrib_l[new_mask]
        delta = 0.0
        for ei in inc:
            row = self._uncov_l[ei]
            for s in range(self._nsub):
                row[s] += cb[s] - ca[s]
            if row[0] == 0:
                lam_new = 0
            else:
                for s, pc in self._order_pairs:
                    if row[s] == 0:
                        lam_new = pc
                        break
            lam_old = self._lam_l[ei]
            delta += self._mu_l[ei] * ((lam_new - 1 if lam_new else 0)
                                       - (lam_old - 1 if lam_old else 0))
            self._lam_l[ei] = lam_new
        self.cost += delta
        self._shift_loads(v, old, new_mask)
        self.masks[v] = new_mask
        return delta

    def _undo_py(self) -> None:
        v, old, old_lams = self._undo.pop()
        cur = int(self.masks[v])
        if cur == old:
            return
        ca, cb = self._contrib_l[cur], self._contrib_l[old]
        delta = 0.0
        for ei, lam_old in zip(self._inc_l[v], old_lams):
            row = self._uncov_l[ei]
            for s in range(self._nsub):
                row[s] += cb[s] - ca[s]
            lam_cur = self._lam_l[ei]
            delta += self._mu_l[ei] * ((lam_old - 1 if lam_old else 0)
                                       - (lam_cur - 1 if lam_cur else 0))
            self._lam_l[ei] = lam_old
        self.cost += delta
        self._shift_loads(v, cur, old)
        self.masks[v] = old

    def _shift_loads(self, v: int, old: int, new: int) -> None:
        w = (self._omega_l[v] if self.backend == "python"
             else self.omega[v])
        diff = new ^ old
        p = 0
        while diff:
            if diff & 1:
                self.loads[p] += w if (new >> p) & 1 else -w
            diff >>= 1
            p += 1

    # ----------------------------------------------------------------- deltas
    def delta_set_mask(self, v: int, new_mask: int) -> float:
        """Cost change of ``masks[v] -> new_mask`` (pure, O(deg * 2^P))."""
        if self.backend == "python":
            return self._delta_py(v, new_mask)
        old = int(self.masks[v])
        if new_mask == old:
            return 0.0
        inc = self._incident(v)
        if inc.size == 0:
            return 0.0
        rows = self.uncov[inc] + (self._contrib[new_mask]
                                  - self._contrib[old])[None, :]
        lam_new = self._lambda_rows(rows).astype(np.float64)
        lam_old = self.edge_lambda[inc].astype(np.float64)
        return float((self.mu[inc] * (np.maximum(lam_new - 1, 0)
                                      - np.maximum(lam_old - 1, 0))).sum())

    def delta_masks(self, v: int, new_masks: np.ndarray) -> np.ndarray:
        """Cost change for each candidate mask in ``new_masks`` at once.

        Single-node front of the frontier layer's batched evaluator
        (``core.frontier.price_mask_front``), which amortizes numpy call
        overhead across all K candidates and -- because the frontier
        reduction is the single shared implementation -- is bit-equal to
        pricing the same candidates as part of any larger node front.
        """
        new_masks = np.asarray(new_masks, dtype=np.int64)
        if self.backend == "python":
            return np.array([self._delta_py(v, int(m)) for m in new_masks])
        from ..frontier.partition_front import price_mask_front
        return price_mask_front(
            self, np.array([v], dtype=np.int64), new_masks,
            np.array([0, len(new_masks)], dtype=np.int64), backend="numpy")

    def delta_move(self, v: int, p_from: int, p_to: int) -> float:
        m = int(self.masks[v])
        return self.delta_set_mask(v, (m & ~(1 << p_from)) | (1 << p_to))

    def delta_add_replica(self, v: int, p: int) -> float:
        return self.delta_set_mask(v, int(self.masks[v]) | (1 << p))

    def delta_drop_replica(self, v: int, p: int) -> float:
        return self.delta_set_mask(v, int(self.masks[v]) & ~(1 << p))

    # ------------------------------------------------------------ application
    def apply(self, v: int, new_mask: int) -> float:
        """Set ``masks[v] = new_mask``; returns the cost delta.

        Records an undo entry (see ``undo``/``commit``).
        """
        if self.backend == "python":
            return self._apply_py(v, new_mask)
        old = int(self.masks[v])
        inc = self._incident(v)
        old_lams = self.edge_lambda[inc].copy()
        self._undo.append((v, old, old_lams))
        if new_mask == old:
            return 0.0
        delta = 0.0
        if inc.size:
            self.uncov[inc] += (self._contrib[new_mask]
                                - self._contrib[old])[None, :]
            lam_new = self._lambda_rows(self.uncov[inc])
            delta = float(
                (self.mu[inc] * (np.maximum(lam_new - 1, 0)
                                 - np.maximum(old_lams - 1, 0))).sum())
            self.edge_lambda[inc] = lam_new
        self.cost += delta
        self._shift_loads(v, old, new_mask)
        self.masks[v] = new_mask
        if self.device is not None:
            self.device.apply(v, old, new_mask)
        return delta

    def undo(self, count: int = 1) -> None:
        """Revert the last ``count`` ``apply`` calls."""
        if count > len(self._undo):
            raise IndexError(
                f"undo({count}): only {len(self._undo)} applied operations "
                "on the undo log")
        if self._frames and len(self._undo) - count < self._frames[-1]:
            raise IndexError(
                "undo would cross the innermost transaction frame; use "
                "rollback() to abandon the frame")
        if self.backend == "python":
            for _ in range(count):
                self._undo_py()
            return
        for _ in range(count):
            v, old, old_lams = self._undo.pop()
            cur = int(self.masks[v])
            if cur == old:
                continue
            inc = self._incident(v)
            if inc.size:
                self.uncov[inc] += (self._contrib[old]
                                    - self._contrib[cur])[None, :]
                cur_lams = self.edge_lambda[inc].astype(np.float64)
                self.cost += float(
                    (self.mu[inc] * (np.maximum(old_lams - 1, 0)
                                     - np.maximum(cur_lams - 1, 0))).sum())
                self.edge_lambda[inc] = old_lams
            self._shift_loads(v, cur, old)
            self.masks[v] = old
            if self.device is not None:
                self.device.apply(v, cur, old)

    def commit(self) -> None:
        """Accept everything applied so far.

        Outside a transaction this drops the whole undo history (the
        historical behavior every heuristic relies on).  Inside a
        ``begin()`` frame it accepts the innermost transaction: the frame
        mark is popped and its records merge into the parent frame -- only
        when the outermost frame commits is the log actually cleared, so a
        parent ``rollback()`` stays bit-exact.
        """
        if self._frames:
            self._frames.pop()
            if not self._frames:
                self._undo.clear()
            return
        self._undo.clear()

    # ------------------------------------------------------------ transactions
    # Speculative re-placement protocol of the online subsystem
    # (``core.placement.online``): open a frame, apply a candidate plan's
    # mask diffs, read the exact repriced cost, then ``commit()`` or
    # ``rollback()``.  Frames nest; rollback is bit-exact because ``undo``
    # restores the overwritten lambda rows verbatim.  NOTE: the stock
    # heuristics call ``commit()`` after every accepted move, so they must
    # not run directly on a state with an open frame -- replan on a
    # throwaway state and replay the diffs through the frame instead.
    def begin(self) -> None:
        """Open a transaction frame at the current undo depth."""
        self._frames.append(len(self._undo))

    def rollback(self) -> None:
        """Undo every ``apply`` since the innermost ``begin()`` and close
        the frame (bit-exact: lambdas/uncov/cost/loads all restored)."""
        if not self._frames:
            raise IndexError("rollback() without begin()")
        mark = self._frames.pop()
        self.undo(len(self._undo) - mark)

    @property
    def depth(self) -> int:
        """Number of undoable ``apply`` records."""
        return len(self._undo)

    # ------------------------------------------------------ structural deltas
    # Dynamic hyperedge mutations for the *online* placement regime
    # (``core.placement.online``): a drifting co-activation hypergraph adds,
    # expires and re-weights edges between refinement epochs.  Each mutation
    # is priced incrementally against the live uncov/lambda tables -- no
    # from-scratch rebuild -- and the resulting state is bit-identical to
    # ``PartitionState(live_hypergraph(), P, masks)`` (property-tested by
    # ``tests/test_placement.py``).  Designed for the online scale (hundreds
    # of edges, thousands of pins): the incidence CSR is re-derived in
    # O(pins) per mutation, while the *pricing* of the mutation itself is
    # O(2^P) (update/remove) or O(|e| * 2^P) (add).  numpy backend only;
    # mutations are forbidden mid-transaction (the undo log stores edge ids)
    # and with a device mirror attached.

    def _require_structural(self) -> None:
        if self.backend != "numpy":
            raise NotImplementedError(
                "structural deltas require the numpy backend")
        if self._undo or self._frames:
            raise RuntimeError(
                "structural mutation with pending undo records / open "
                "transaction frames (commit or rollback first)")
        if self.device is not None:
            raise RuntimeError(
                "structural mutation with a device mirror attached")
        if not self._dynamic:
            # detach from the construction-time Hypergraph: private mu and
            # per-edge pin arrays become the primary edge representation
            self.mu = self.mu.copy()
            self._edge_pins = [
                self.pins[self.xpins[e]:self.xpins[e + 1]].copy()
                for e in range(len(self.xpins) - 1)]
            self.hg = None  # stale by construction; use live_hypergraph()
            self._dynamic = True

    def _rebuild_structure(self) -> None:
        """Re-derive the CSR pin layout and node->edge incidence from
        ``_edge_pins`` (O(pins log pins); online-scale instances only)."""
        n = len(self.masks)
        m = len(self._edge_pins)
        lens = np.fromiter((len(p) for p in self._edge_pins),
                           dtype=np.int64, count=m)
        self.xpins = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(lens, out=self.xpins[1:])
        self.pins = (np.concatenate(self._edge_pins)
                     if m else np.zeros(0, dtype=np.int64))
        edge_of_pin = np.repeat(np.arange(m, dtype=np.int64), lens)
        order = np.argsort(self.pins, kind="stable")
        self.inc_edges = edge_of_pin[order]
        self.xinc = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.pins, minlength=n), out=self.xinc[1:])

    def live_hypergraph(self, name: str = "live") -> Hypergraph:
        """Snapshot of the current edge set as a ``Hypergraph`` (dynamic
        states only; edge order is the engine's live order, so a state
        rebuilt from it is comparable row-for-row)."""
        if not self._dynamic:
            return self.hg
        return Hypergraph.from_csr(
            len(self.masks), self.xpins.copy(), self.pins.copy(),
            omega=self.omega, mu=self.mu.copy(), name=name)

    def update_mu(self, ei: int, new_mu: float) -> float:
        """Re-weight edge ``ei``; returns the exact cost delta (O(1))."""
        self._require_structural()
        new_mu = float(new_mu)
        delta = (new_mu - self.mu[ei]) * max(int(self.edge_lambda[ei]) - 1, 0)
        self.mu[ei] = new_mu
        self.cost += delta
        return delta

    def add_edge(self, pins, mu: float) -> int:
        """Append a new hyperedge; returns its edge id (= old edge count).

        The uncov row and lambda are computed from the *current* masks, so
        the edge is priced exactly as a rebuild would price it."""
        self._require_structural()
        pins_arr = np.unique(np.asarray(pins, dtype=np.int64))
        if len(pins_arr) == 0:
            raise ValueError("add_edge: empty pin set")
        if pins_arr[0] < 0 or pins_arr[-1] >= len(self.masks):
            raise ValueError("add_edge: pin out of range")
        row = self._contrib[self.masks[pins_arr]].sum(
            axis=0, dtype=np.int32)
        lam = int(self._lambda_rows(row[None, :])[0])
        self.uncov = np.vstack([self.uncov, row[None, :]])
        self.edge_lambda = np.concatenate(
            [self.edge_lambda, np.array([lam], dtype=np.int16)])
        self.mu = np.concatenate([self.mu, [float(mu)]])
        self._edge_pins.append(pins_arr)
        self.cost += float(mu) * max(lam - 1, 0)
        self._rebuild_structure()
        return len(self._edge_pins) - 1

    def remove_edge(self, ei: int) -> float:
        """Remove edge ``ei`` (swap-remove: the last edge takes id ``ei``;
        callers tracking edge ids must apply that rename).  Returns the
        exact cost delta."""
        self._require_structural()
        m = len(self._edge_pins)
        if not 0 <= ei < m:
            raise IndexError(f"remove_edge({ei}): {m} edges")
        delta = -float(self.mu[ei]) * max(int(self.edge_lambda[ei]) - 1, 0)
        last = m - 1
        if ei != last:
            self.uncov[ei] = self.uncov[last]
            self.edge_lambda[ei] = self.edge_lambda[last]
            self.mu[ei] = self.mu[last]
            self._edge_pins[ei] = self._edge_pins[last]
        self.uncov = self.uncov[:last]
        self.edge_lambda = self.edge_lambda[:last]
        self.mu = self.mu[:last]
        self._edge_pins.pop()
        self.cost += delta
        self._rebuild_structure()
        return delta

    # -------------------------------------------------------------- utilities
    def fits(self, v: int, p: int, cap: float) -> bool:
        return self.loads[p] + self.omega[v] <= cap

    def lambda_of(self, ei: int) -> int:
        if self.backend == "python":
            return self._lam_l[ei]
        return int(self.edge_lambda[ei])

    def check(self) -> None:
        """Assert all invariants against a from-scratch rebuild (tests)."""
        fresh = PartitionState(self.live_hypergraph() if self._dynamic
                               else self.hg, self.P, masks=self.masks)
        if self.backend == "python":
            uncov = np.asarray(self._uncov_l, dtype=np.int32).reshape(
                fresh.uncov.shape)
            lam = np.asarray(self._lam_l, dtype=np.int16)
        else:
            uncov, lam = self.uncov, self.edge_lambda
        assert np.array_equal(fresh.uncov, uncov), "uncov drifted"
        assert np.array_equal(fresh.edge_lambda, lam), "edge_lambda drifted"
        assert abs(fresh.cost - self.cost) < 1e-6, \
            f"cost drifted: {self.cost} vs {fresh.cost}"
        assert np.allclose(fresh.loads, self.loads), "loads drifted"

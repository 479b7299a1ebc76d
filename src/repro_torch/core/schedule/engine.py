"""Incremental-delta BSP schedule engine (mirror of the partition engine).

The seed costed most candidate moves by ``Schedule.copy()`` + mutate +
discard -- an O(n + S*P + comms) copy per trial -- and re-derived superstep
costs through a dirty-set sweep.  ``ScheduleState`` replaces both: it owns
the compute phases (``comp``/``assign``), the communication phase
(``comms``/``src_index``) and the per-superstep ``work``/``sent``/``recv``
load rows, and keeps just enough derived state to price and apply any
primitive move in O(touched supersteps):

  * per superstep s and per row kind (work / sent / recv) the **top-2
    maxima** ``[m1, i1, m2]`` -- the row maximum, one argmax, and the
    maximum over the remaining processors -- so "what is the row max if
    entry p changed to x" is an O(1) query and maintenance needs an O(P)
    rescan only when the leader drops below the runner-up;
  * the cached superstep cost ``_scost[s] = m1_work + [h > EPS] * (L + g*h)``
    with ``h = max(m1_sent, m1_recv)``, and their running total ``_total``,
    so ``current_cost()`` is O(1).

Pricing vs applying
-------------------
``delta_add_comp`` / ``delta_remove_comp`` / ``delta_add_comm`` /
``delta_remove_comm`` / ``delta_move_comm`` / ``delta_replicate_for_comm`` /
``delta_node_move`` are **pure**: they fold the move's cell changes per
touched superstep and return the exact total-cost change without mutating
anything.  The mutation methods (``add_comp``, ``remove_comm``, ...) keep
every invariant eagerly, in O(1) amortized per touched cell.

Transactions
------------
Compound trial moves (superstep merging, superstep replication, batch
replication, node moves) wrap their mutations in ``begin()`` ...
``commit()`` / ``rollback()``.  While a frame is open every mutation pushes
an undo record carrying the *overwritten values* (cells, top-2 triples,
step costs, total), so ``rollback`` restores the numeric state bit-for-bit
-- no inverse arithmetic, hence exact for arbitrary float weights -- and
re-inserts/removes the structural entries (comp sets, assign/comms dicts,
src_index).  Frames nest; an inner ``commit`` folds its records into the
enclosing frame.  Outside any frame, mutations skip logging entirely.

Invariants (asserted by ``check()``):
  * each row's top-2 triple matches a from-scratch scan;
  * ``_scost[s] == superstep_cost(s)`` recomputed from the rows;
  * ``_total == sum(_scost)``;
  * ``work``/``sent``/``recv`` match a rebuild from ``assign``/``comms``.

Complexity per operation (P = #processors, deg = node degree):
mutations and single-move deltas O(P) worst case, O(1) typical;
``delta_node_move`` O(out-comms + deg); ``rollback`` O(ops in the frame);
``compact`` O(nodes in shifted supersteps + comms + S*P).
"""
from __future__ import annotations

import math
from collections import defaultdict

EPS = 1e-12
"""Shared cost-comparison tolerance for every accept/threshold test in the
scheduling stack (moves are kept only when they improve by more than EPS)."""

INF = math.inf

_KINDS = ("work", "sent", "recv")


def _retop(row):
    """Fresh top-2 triple [m1, i1, m2] of a non-negative row."""
    m1, i1 = row[0], 0
    for q in range(1, len(row)):
        if row[q] > m1:
            m1, i1 = row[q], q
    m2 = 0.0
    for q, x in enumerate(row):
        if q != i1 and x > m2:
            m2 = x
    return [m1, i1, m2]


def _canonical_comm_plan_scalar(dag, assign) -> list[tuple[int, int, int, int]]:
    """Scalar reference implementation of ``canonical_comm_plan`` (kept as
    the pinned oracle for the vectorized path; see tests)."""
    first_use: dict[tuple[int, int], int] = {}
    parents = dag.parents
    for c in range(dag.n):
        for p, s in assign[c].items():
            for u in parents[c]:
                key = (u, p)
                t = first_use.get(key)
                if t is None or s < t:
                    first_use[key] = s
    plan = []
    for (v, p), s_use in sorted(first_use.items()):
        av = assign[v]
        if av.get(p, INF) <= s_use:
            continue  # locally computed in time
        src, s_src = min(((pp, ss) for pp, ss in av.items()),
                         key=lambda x: (x[1], x[0]))
        assert s_src < s_use, \
            f"value {v} for proc {p} not producible in time"
        plan.append((v, src, p, s_use - 1))
    return plan


# cap on the dense (value, processor) scratch tables of the vectorized plan;
# past it (n * P ~ 2^27 cells ~ 1 GiB of int64) fall back to the dict path
_PLAN_DENSE_CAP = 1 << 27
# expanded (assignment x parent) rows are processed in blocks of this many
# entries so peak scratch memory stays bounded at million-node projections
_PLAN_BLOCK = 1 << 22


def _canonical_comm_plan_arrays(dag, assign):
    """Vectorized core of ``canonical_comm_plan``: returns four flat int64
    arrays ``(value, src, dst, superstep)``, rows sorted by (value, dst) --
    bit-identical content to ``_canonical_comm_plan_scalar``.

    One bincount/sort pass over the flat parents-CSR instead of a python
    loop per (assignment x parent): per-(value, proc) first uses fold via a
    blocked ``np.minimum.at`` (min is order-independent, so blocking cannot
    change results), the earliest replica per value comes from one lexsort
    by (value, superstep, proc), and ascending ``np.flatnonzero`` over the
    dense first-use table reproduces the scalar ``sorted(first_use)``
    emission order exactly.
    """
    import numpy as np

    n = dag.n
    counts = np.fromiter((len(a) for a in assign), dtype=np.int64, count=n)
    m = int(counts.sum())
    z = np.zeros(0, dtype=np.int64)
    if m == 0:
        return z, z, z, z
    an_node = np.repeat(np.arange(n, dtype=np.int64), counts)
    an_p = np.fromiter((p for a in assign for p in a),
                       dtype=np.int64, count=m)
    an_s = np.fromiter((s for a in assign for s in a.values()),
                       dtype=np.int64, count=m)
    P = int(an_p.max()) + 1
    if n * P > _PLAN_DENSE_CAP:
        plan = _canonical_comm_plan_scalar(dag, assign)
        if not plan:
            return z, z, z, z
        arr = np.asarray(plan, dtype=np.int64)
        return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    xpar, par_arr = dag.xpar, dag.par_arr
    indeg = np.diff(xpar)
    sentinel = np.iinfo(np.int64).max
    first_use = np.full(n * P, sentinel, dtype=np.int64)
    reps = indeg[an_node]
    cum = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(reps, out=cum[1:])
    start = 0
    while start < m:
        end = int(np.searchsorted(cum, cum[start] + _PLAN_BLOCK, "left"))
        end = min(m, max(end, start + 1))
        tot = int(cum[end] - cum[start])
        if tot:
            rows = np.repeat(np.arange(start, end, dtype=np.int64),
                             reps[start:end])
            within = cum[start] + np.arange(tot, dtype=np.int64) - cum[rows]
            par = par_arr[xpar[an_node[rows]] + within]
            np.minimum.at(first_use, par * P + an_p[rows], an_s[rows])
        start = end
    # local compute superstep per (value, proc); at most one s per pair
    comp_s = np.full(n * P, sentinel, dtype=np.int64)
    comp_s[an_node * P + an_p] = an_s
    # earliest replica per value: min (superstep, proc)
    order = np.lexsort((an_p, an_s, an_node))
    lead = np.ones(m, dtype=bool)
    lead[1:] = an_node[order][1:] != an_node[order][:-1]
    src_of = np.full(n, -1, dtype=np.int64)
    ssrc_of = np.full(n, sentinel, dtype=np.int64)
    src_of[an_node[order][lead]] = an_p[order][lead]
    ssrc_of[an_node[order][lead]] = an_s[order][lead]
    keys = np.flatnonzero(first_use != sentinel)  # ascending == sorted (v, p)
    v_k, p_k = keys // P, keys % P
    s_use = first_use[keys]
    need = comp_s[keys] > s_use  # no local compute in time
    v_k, p_k, s_use = v_k[need], p_k[need], s_use[need]
    late = ssrc_of[v_k] >= s_use
    assert not late.any(), \
        f"value {int(v_k[late.argmax()]) if late.any() else -1} " \
        "not producible in time"
    return v_k, src_of[v_k], p_k, s_use - 1


def canonical_comm_plan(dag, assign) -> list[tuple[int, int, int, int]]:
    """The canonical communication set of a compute assignment, as
    ``(value, src, dst, superstep)`` rows sorted by ``(value, dst)``.

    One comm per (value, consuming processor): skipped when the consumer
    computes the value locally in time, sourced at the earliest replica
    (ties to the lowest processor id), placed at the latest valid
    superstep (first use - 1).  Single home of the rule -- both
    ``list_sched.derive_comms`` (live rebuild) and
    ``ScheduleState.from_projection`` (bulk expansion) consume it, so the
    two paths cannot drift.  The body is the vectorized
    ``_canonical_comm_plan_arrays`` (one bincount/sort pass over flat edge
    arrays); ``_canonical_comm_plan_scalar`` pins its output bit-for-bit.
    """
    v, src, dst, t = _canonical_comm_plan_arrays(dag, assign)
    return list(zip(v.tolist(), src.tolist(), dst.tolist(), t.tolist()))


def apply_split_mutations(sched, s: int, late, pre=None) -> bool:
    """Execute the superstep-split mutation sequence on any schedule object
    exposing the primitive-op protocol (engine ``ScheduleState``, reference
    ``Schedule``, or the pricing sim) -- shared so the engine and oracle
    trajectories stay bit-identical, exactly the SM/SR contract.

    The split is the inverse of the SM merge: every compute phase after
    ``s`` shifts one superstep later (opening an empty superstep ``s + 1``),
    the ``late`` pairs -- sorted ``(node, proc)`` compute entries of
    superstep ``s`` -- delay into the new superstep, and the comms of every
    *affected* value (delayed nodes, parents of delayed nodes, and values
    with a comm in phase ``s``) are re-derived canonically per the
    ``derive_comms`` rule.  The re-derivation is the gain mechanism: the
    merged comm phase at ``s`` redistributes between phases ``s`` and
    ``s + 1`` (an h-relation split, trading ``g*h`` against ``L``), while
    delayed values' phase-``s`` comms -- whose source would no longer be
    computed in time -- are re-placed at later, valid phases.  Returns
    False when some affected value cannot reach a consumer in time (the
    candidate is infeasible); the caller prices on a sim or rolls back.

    Determinism contract: supersteps shift in descending order with nodes
    ascending per cell, pre-mutation comms are walked in sorted key order,
    and affected values re-derive ascending -- every consumer (engine
    transaction, oracle copy, pricing sim) sees the identical sequence.
    ``pre`` optionally supplies the sorted pre-mutation comm snapshot so a
    pricing sweep sorts the comm dict once per round, not per candidate.
    """
    dag = sched.inst.dag
    P = sched.inst.P
    if pre is None:
        pre = sorted(sched.comms.items())
    dsts_of: dict[int, list[int]] = {}
    affected = set()
    for (v, dst), (_src, t) in pre:
        dsts_of.setdefault(v, []).append(dst)
        if t == s:
            affected.add(v)
    for (v, _p) in late:
        affected.add(v)
        affected.update(dag.parents[v])
    S0 = sched.S
    bulk = getattr(sched, "shift_tail_bulk", None)
    if bulk is not None:
        bulk(s)  # pricing sim: zero-delta renumbering, no per-node traffic
    else:
        for t in range(S0 - 1, s, -1):
            for p in range(P):
                for v in sorted(sched.comp[t][p]):
                    sched.remove_comp(v, p)
                    sched.add_comp(v, p, t + 1)
        for (v, dst), (_src, t) in pre:
            if t > s:
                sched.move_comm(v, dst, t + 1)
    for (v, p) in late:
        sched.remove_comp(v, p)
        sched.add_comp(v, p, s + 1)
    for u in sorted(affected):
        for dst in dsts_of.get(u, ()):
            sched.remove_comm(u, dst)
        first_use: dict[int, int] = {}
        for c in dag.children[u]:
            for q, t in sched.assign[c].items():
                cur = first_use.get(q)
                if cur is None or t < cur:
                    first_use[q] = t
        av = sched.assign[u]
        for q, s_use in sorted(first_use.items()):
            if av.get(q, INF) <= s_use:
                continue  # locally computed in time
            src, s_src = min(av.items(), key=lambda x: (x[1], x[0]))
            if s_src >= s_use:
                return False
            sched.add_comm(u, src, q, s_use - 1)
    return True


class ScheduleState:
    """Mutable BSP schedule with O(touched-supersteps) incremental costing.

    Structure mirrors the seed ``Schedule``: compute phases ``comp[s][p]``
    (sets of nodes), canonical comms ``(v, dst) -> (src, s)``, the reverse
    ``src_index[(v, src)] -> set of dsts``, and ``assign[v]: {p: s}``.
    ``work``/``sent``/``recv`` are plain S x P list-of-list rows (scalar
    updates dominate; numpy per-element dispatch would, as in the partition
    engine's scalar backend, cost more than it saves).
    """

    def __init__(self, inst, S: int):
        self.inst = inst
        P = inst.P
        self.S = S
        self.comp: list[list[set[int]]] = [[set() for _ in range(P)]
                                           for _ in range(S)]
        # (v, dst) -> (src, superstep)
        self.comms: dict[tuple[int, int], tuple[int, int]] = {}
        # (v, src) -> set of dsts, for O(deg) use queries
        self.src_index: dict[tuple[int, int], set[int]] = defaultdict(set)
        # v -> {p: superstep computed}  (at most one superstep per (v,p))
        self.assign: list[dict[int, int]] = [dict() for _ in range(inst.dag.n)]
        self.work = [[0.0] * P for _ in range(S)]
        self.sent = [[0.0] * P for _ in range(S)]
        self.recv = [[0.0] * P for _ in range(S)]
        self._wtop = [[0.0, 0, 0.0] for _ in range(S)]
        self._stop = [[0.0, 0, 0.0] for _ in range(S)]
        self._rtop = [[0.0, 0, 0.0] for _ in range(S)]
        self._scost = [0.0] * S
        self._total = 0.0
        # transaction machinery: undo records + open-frame start indices
        self._undo: list = []
        self._frames: list[int] = []
        self._replaying = False
        # values whose comms may have changed needed-status since the last
        # prune_useless_comms (see there); start conservatively dirty
        self._prune_dirty: set[int] = set(range(inst.dag.n))

    # ----------------------------------------------------------- row helpers
    def _rows_top(self, kind: str):
        if kind == "work":
            return self.work, self._wtop
        if kind == "sent":
            return self.sent, self._stop
        return self.recv, self._rtop

    def work_max(self, s: int) -> float:
        return self._wtop[s][0]

    def h_of(self, s: int) -> float:
        return max(self._stop[s][0], self._rtop[s][0])

    def _step_cost(self, w1: float, h: float) -> float:
        if h > EPS:
            return w1 + self.inst.L + self.inst.g * h
        return w1

    def superstep_cost(self, s: int) -> float:
        """Superstep cost recomputed from the raw rows (oracle path)."""
        c = max(self.work[s])
        h = max(max(self.sent[s]), max(self.recv[s]))
        if h > EPS:
            c += self.inst.L + self.inst.g * h
        return c

    def cost(self) -> float:
        """Full-recompute total cost (O(S*P); for tests and assertions)."""
        return sum(self.superstep_cost(s) for s in range(self.S))

    def current_cost(self) -> float:
        """Incrementally maintained total cost (O(1))."""
        return self._total

    # ------------------------------------------------------------- cell edit
    def _cell_add(self, kind: str, s: int, p: int, dv: float,
                  saves: list | None) -> None:
        """row[s][p] += dv, maintaining top-2, step cost and total."""
        rows, tops = self._rows_top(kind)
        row, top = rows[s], tops[s]
        old = row[p]
        if saves is not None:
            saves.append((kind, s, p, old, top.copy(), self._scost[s]))
        new = old + dv
        row[p] = new
        m1, i1, m2 = top
        if p == i1:
            if new >= m2:
                top[0] = new
            else:
                top[:] = _retop(row)
        elif new > m1:
            top[0], top[1], top[2] = new, p, m1
        elif new > m2:
            top[2] = new
        elif new < m2 and old == m2:
            P = self.inst.P
            top[2] = max((row[q] for q in range(P) if q != i1), default=0.0)
        c = self._step_cost(self._wtop[s][0],
                            max(self._stop[s][0], self._rtop[s][0]))
        self._total += c - self._scost[s]
        self._scost[s] = c

    # ------------------------------------------------------------- mutations
    def _grow(self, s: int) -> None:
        P = self.inst.P
        if s >= self.S and self._frames and not self._replaying:
            self._undo.append(("S", self.S, None))
        while s >= self.S:
            self.comp.append([set() for _ in range(P)])
            self.work.append([0.0] * P)
            self.sent.append([0.0] * P)
            self.recv.append([0.0] * P)
            self._wtop.append([0.0, 0, 0.0])
            self._stop.append([0.0, 0, 0.0])
            self._rtop.append([0.0, 0, 0.0])
            self._scost.append(0.0)
            self.S += 1

    def _log(self, inverse: tuple) -> list | None:
        """Open an undo record; returns the saves list or None (no frame)."""
        if not self._frames or self._replaying:
            return None
        saves: list = []
        self._undo.append((inverse[0], inverse[1:], saves, self._total))
        return saves

    def _mark_comp_dirty(self, v: int) -> None:
        self._prune_dirty.add(v)
        self._prune_dirty.update(self.inst.dag.parents[v])

    def add_comp(self, v: int, p: int, s: int) -> None:
        self._grow(s)
        assert p not in self.assign[v], f"node {v} already on proc {p}"
        saves = self._log(("-comp", v, p))
        self.comp[s][p].add(v)
        self.assign[v][p] = s
        self._mark_comp_dirty(v)
        self._cell_add("work", s, p, self.inst.dag.omega[v], saves)

    def remove_comp(self, v: int, p: int) -> None:
        s = self.assign[v].pop(p)
        saves = self._log(("+comp", v, p, s))
        self.comp[s][p].discard(v)
        self._mark_comp_dirty(v)
        self._cell_add("work", s, p, -self.inst.dag.omega[v], saves)

    def add_comm(self, v: int, src: int, dst: int, s: int) -> None:
        self._grow(s)
        assert (v, dst) not in self.comms
        saves = self._log(("-comm", v, dst))
        self.comms[(v, dst)] = (src, s)
        self.src_index[(v, src)].add(dst)
        self._prune_dirty.add(v)
        mu = self.inst.dag.mu[v]
        self._cell_add("sent", s, src, mu, saves)
        self._cell_add("recv", s, dst, mu, saves)

    def remove_comm(self, v: int, dst: int) -> None:
        src, s = self.comms.pop((v, dst))
        saves = self._log(("+comm", v, src, dst, s))
        self.src_index[(v, src)].discard(dst)
        self._prune_dirty.add(v)
        mu = self.inst.dag.mu[v]
        self._cell_add("sent", s, src, -mu, saves)
        self._cell_add("recv", s, dst, -mu, saves)

    def move_comm(self, v: int, dst: int, new_s: int) -> None:
        src, _ = self.comms[(v, dst)]
        self.remove_comm(v, dst)
        self.add_comm(v, src, dst, new_s)

    # ----------------------------------------------------------- transactions
    def begin(self) -> None:
        """Open a transaction frame; mutations log undo records until the
        matching ``commit`` (keep) or ``rollback`` (revert)."""
        self._frames.append(len(self._undo))

    def commit(self) -> None:
        """Accept the innermost frame.  Records fold into the enclosing
        frame (if any) so an outer rollback still reverts them."""
        start = self._frames.pop()
        if not self._frames:
            del self._undo[start:]

    def rollback(self) -> None:
        """Revert every mutation of the innermost frame, exactly."""
        start = self._frames.pop()
        records = self._undo[start:]
        del self._undo[start:]
        self._replaying = True
        try:
            for rec in reversed(records):
                tag = rec[0]
                if tag == "S":
                    old_S = rec[1]
                    del self.comp[old_S:]
                    del self.work[old_S:]
                    del self.sent[old_S:]
                    del self.recv[old_S:]
                    del self._wtop[old_S:]
                    del self._stop[old_S:]
                    del self._rtop[old_S:]
                    del self._scost[old_S:]
                    self.S = old_S
                    continue
                _, args, saves, total_before = rec
                # structural inverse
                if tag == "-comp":
                    v, p = args
                    s = self.assign[v].pop(p)
                    self.comp[s][p].discard(v)
                    self._mark_comp_dirty(v)
                elif tag == "+comp":
                    v, p, s = args
                    self.comp[s][p].add(v)
                    self.assign[v][p] = s
                    self._mark_comp_dirty(v)
                elif tag == "-comm":
                    v, dst = args
                    src, _ = self.comms.pop((v, dst))
                    self.src_index[(v, src)].discard(dst)
                    self._prune_dirty.add(v)
                elif tag == "+comm":
                    v, src, dst, s = args
                    self.comms[(v, dst)] = (src, s)
                    self.src_index[(v, src)].add(dst)
                    self._prune_dirty.add(v)
                # numeric restore: overwrite with the saved values
                for kind, s, p, old, top, scost in reversed(saves):
                    rows, tops = self._rows_top(kind)
                    rows[s][p] = old
                    tops[s][:] = top
                    self._scost[s] = scost
                self._total = total_before
        finally:
            self._replaying = False

    @property
    def depth(self) -> int:
        """Number of open transaction frames."""
        return len(self._frames)

    # ------------------------------------------------------------- presence
    def compute_sstep(self, v: int, p: int) -> float:
        return self.assign[v].get(p, INF)

    def recv_sstep(self, v: int, p: int) -> float:
        c = self.comms.get((v, p))
        return c[1] if c is not None else INF

    def present_at(self, v: int, p: int, s: int) -> bool:
        """Usable on p in superstep s (for compute or as a send source)."""
        return self.compute_sstep(v, p) <= s or self.recv_sstep(v, p) < s

    # ------------------------------------------------------ use / windows
    def uses_on(self, v: int, p: int) -> list[int]:
        """Supersteps where v's value is consumed on p (compute or send)."""
        out = []
        for c in self.inst.dag.children[v]:
            s = self.assign[c].get(p)
            if s is not None:
                out.append(s)
        for dst in self.src_index.get((v, p), ()):
            out.append(self.comms[(v, dst)][1])
        return sorted(out)

    def has_use_on(self, v: int, p: int) -> bool:
        """O(deg) short-circuit version of ``bool(uses_on(v, p))``."""
        for c in self.inst.dag.children[v]:
            if p in self.assign[c]:
                return True
        return bool(self.src_index.get((v, p)))

    def first_use_on(self, v: int, p: int) -> float:
        u = self.uses_on(v, p)
        return u[0] if u else INF

    def earliest_replication(self, v: int, p: int) -> float:
        """First superstep where all parents of v are present on p."""
        e = 0
        for u in self.inst.dag.parents[v]:
            cs = self.compute_sstep(u, p)
            rs = self.recv_sstep(u, p)
            e = max(e, min(cs, rs + 1))
        return e

    # ----------------------------------------------------------- delta pricing
    def _delta_cells(self, cells) -> float:
        """Exact total-cost change of applying ``cells`` — an iterable of
        ``(kind, s, p, dv)`` — without mutating anything.  O(touched
        supersteps), O(1) per superstep unless several cells hit the same
        row (then one O(P) scan).  Per-superstep deltas are summed in
        ascending superstep order, so batched pricers (the frontier layer)
        can reproduce the result bit-for-bit."""
        by_s: dict[int, dict[str, dict[int, float]]] = {}
        for kind, s, p, dv in cells:
            d = by_s.setdefault(s, {}).setdefault(kind, {})
            d[p] = d.get(p, 0.0) + dv
        delta = 0.0
        for s in sorted(by_s):
            kinds = by_s[s]
            if s < self.S:
                w1 = self._max_with("work", s, kinds.get("work"))
                s1 = self._max_with("sent", s, kinds.get("sent"))
                r1 = self._max_with("recv", s, kinds.get("recv"))
                delta += self._step_cost(w1, max(s1, r1)) - self._scost[s]
            else:  # beyond current horizon: all-zero virtual rows
                w1 = max(0.0, max(kinds.get("work", {}).values(),
                                  default=0.0))
                h = max(max(kinds.get("sent", {}).values(), default=0.0),
                        max(kinds.get("recv", {}).values(), default=0.0),
                        0.0)
                delta += self._step_cost(w1, h)
        return delta

    def _max_with(self, kind: str, s: int, dvs: dict[int, float] | None):
        """Row max of ``kind`` at s if each p in dvs changed by dvs[p]."""
        rows, tops = self._rows_top(kind)
        top = tops[s]
        if not dvs:
            return top[0]
        row = rows[s]
        if len(dvs) == 1:
            (p, dv), = dvs.items()
            new = row[p] + dv
            return max(top[2], new) if p == top[1] else max(top[0], new)
        return max(row[q] + dvs.get(q, 0.0) for q in range(self.inst.P))

    def _kind_max_if(self, kind: str, s: int, p: int, dv: float) -> float:
        """Row max of ``kind`` at s if entry p changed by dv (O(1))."""
        rows, tops = self._rows_top(kind)
        top = tops[s]
        new = rows[s][p] + dv
        return max(top[2], new) if p == top[1] else max(top[0], new)

    def _comm_step_delta(self, s: int, src: int, dst: int, mu: float) -> float:
        """Step-cost change at s if sent[src] and recv[dst] change by mu."""
        s1 = self._kind_max_if("sent", s, src, mu)
        r1 = self._kind_max_if("recv", s, dst, mu)
        return self._step_cost(self._wtop[s][0], max(s1, r1)) - self._scost[s]

    def delta_add_comp(self, v: int, p: int, s: int) -> float:
        if s >= self.S:
            return self._step_cost(self.inst.dag.omega[v], 0.0)
        w1 = self._kind_max_if("work", s, p, self.inst.dag.omega[v])
        return self._step_cost(w1, self.h_of(s)) - self._scost[s]

    def delta_remove_comp(self, v: int, p: int) -> float:
        s = self.assign[v][p]
        w1 = self._kind_max_if("work", s, p, -self.inst.dag.omega[v])
        return self._step_cost(w1, self.h_of(s)) - self._scost[s]

    def delta_add_comm(self, v: int, src: int, dst: int, s: int) -> float:
        mu = self.inst.dag.mu[v]
        if s >= self.S:
            return self._step_cost(0.0, mu)
        return self._comm_step_delta(s, src, dst, mu)

    def delta_remove_comm(self, v: int, dst: int) -> float:
        src, s = self.comms[(v, dst)]
        return self._comm_step_delta(s, src, dst, -self.inst.dag.mu[v])

    def delta_move_comm(self, v: int, dst: int, new_s: int) -> float:
        src, s = self.comms[(v, dst)]
        if new_s == s:
            return 0.0
        mu = self.inst.dag.mu[v]
        d = self._comm_step_delta(s, src, dst, -mu)
        if new_s >= self.S:
            return d + self._step_cost(0.0, mu)
        return d + self._comm_step_delta(new_s, src, dst, mu)

    def delta_replicate_for_comm(self, v: int, dst: int, t: int) -> float:
        """Composite basic move: drop comm (v -> dst), compute v on dst at
        superstep t instead."""
        src, s = self.comms[(v, dst)]
        mu = self.inst.dag.mu[v]
        om = self.inst.dag.omega[v]
        if s == t:  # both phases of the same superstep change
            return self._delta_cells([("sent", s, src, -mu),
                                      ("recv", s, dst, -mu),
                                      ("work", t, dst, om)])
        d = self._comm_step_delta(s, src, dst, -mu)
        if t >= self.S:
            return d + self._step_cost(om, 0.0)
        w1 = self._kind_max_if("work", t, dst, om)
        return d + self._step_cost(w1, self.h_of(t)) - self._scost[t]

    def _node_move_cells(self, v: int, q: int):
        """Cell changes of moving single-assigned node v to processor q in
        the same superstep, mirroring the hill-climbing move: outgoing comms
        retarget src p -> q (the one to q itself is dropped), an incoming
        comm to q is dropped, and consumers left on p get one comm q -> p
        before their first use.  Feasibility is the caller's concern."""
        (p, s), = self.assign[v].items()
        dag = self.inst.dag
        mu, om = dag.mu[v], dag.omega[v]
        cells = []
        for dst in sorted(self.src_index.get((v, p), ())):
            _, t = self.comms[(v, dst)]
            cells.append(("sent", t, p, -mu))
            if dst == q:
                cells.append(("recv", t, q, -mu))
            else:
                cells.append(("sent", t, q, mu))
        c0 = self.comms.get((v, q))
        if c0 is not None and c0[0] != p:
            src0, t0 = c0
            cells += [("sent", t0, src0, -mu), ("recv", t0, q, -mu)]
        cells += [("work", s, p, -om), ("work", s, q, om)]
        uses_p = self.uses_on(v, p)
        if uses_p:
            tf = min(uses_p) - 1
            cells += [("sent", tf, q, mu), ("recv", tf, p, mu)]
        return cells

    def delta_node_move(self, v: int, q: int) -> float:
        """Price the compound node move v -> q (pure, O(out-comms + deg))."""
        return self._delta_cells(self._node_move_cells(v, q))

    def apply_node_move(self, v: int, q: int) -> None:
        """Execute the node move priced by ``delta_node_move``."""
        (p, s), = self.assign[v].items()
        uses_p = self.uses_on(v, p)
        for dst in sorted(self.src_index.get((v, p), ())):
            _, t = self.comms[(v, dst)]
            self.remove_comm(v, dst)
            if dst != q:
                self.add_comm(v, q, dst, t)
        if (v, q) in self.comms:
            self.remove_comm(v, q)
        self.remove_comp(v, p)
        self.add_comp(v, q, s)
        if uses_p:
            self.add_comm(v, q, p, min(uses_p) - 1)

    # -------------------------------------------------------------- cleanup
    def prune_useless_comms(self) -> int:
        """Drop comms whose value is never used on the destination after
        arrival (can appear after replication rewrites).

        Incremental: a comm (v, dst)'s needed-status depends only on its own
        placement, v's local compute on dst, v's children's assignments and
        v's onward sends -- every mutation marks the affected value dirty
        (``_prune_dirty``), so only comms of dirty values are re-examined.
        Comms of clean values were needed at the previous prune and their
        status cannot have changed, making this exactly equivalent to (and
        interchangeable with) the reference full scan."""
        drop = []
        dirty = self._prune_dirty
        children = self.inst.dag.children
        assign = self.assign
        comms = self.comms
        src_index = self.src_index
        for (v, dst), (src, s) in comms.items():
            if v not in dirty:
                continue
            cs = assign[v].get(dst)
            # a use at superstep t is satisfied by this comm iff s < t, and
            # does not need it at all when covered by local compute (cs <= t)
            needed = False
            if cs is None:
                for c in children[v]:
                    t = assign[c].get(dst)
                    if t is not None and t > s:
                        needed = True
                        break
                if not needed:
                    for dd in src_index.get((v, dst), ()):
                        if comms[(v, dd)][1] > s:
                            needed = True
                            break
            else:
                for c in children[v]:
                    t = assign[c].get(dst)
                    if t is not None and t > s and cs > t:
                        needed = True
                        break
                if not needed:
                    for dd in src_index.get((v, dst), ()):
                        t = comms[(v, dd)][1]
                        if t > s and cs > t:
                            needed = True
                            break
            if not needed:
                drop.append((v, dst))
        dirty.clear()
        for key in drop:
            self.remove_comm(*key)
        return len(drop)

    def compact(self) -> None:
        """Remove empty supersteps (no compute and no comm anywhere).

        Renumbers through ``comp`` membership -- O(nodes in shifted
        supersteps + comms) -- instead of rebuilding every assign dict.
        Must not run inside an open transaction."""
        assert not self._frames, "compact inside an open transaction"
        P = self.inst.P
        keep = [s for s in range(self.S)
                if any(self.work[s]) or any(self.sent[s]) or any(self.recv[s])
                or any(self.comp[s][p] for p in range(P))]
        if len(keep) == self.S:
            return
        remap = {old: new for new, old in enumerate(keep)}
        for old_s in keep:
            new_s = remap[old_s]
            if new_s == old_s:
                continue
            for p in range(P):
                for v in self.comp[old_s][p]:
                    self.assign[v][p] = new_s
        self.comp = [self.comp[s] for s in keep]
        self.work = [self.work[s] for s in keep]
        self.sent = [self.sent[s] for s in keep]
        self.recv = [self.recv[s] for s in keep]
        self._wtop = [self._wtop[s] for s in keep]
        self._stop = [self._stop[s] for s in keep]
        self._rtop = [self._rtop[s] for s in keep]
        self._scost = [self._scost[s] for s in keep]
        self.S = len(keep)
        self._total = sum(self._scost)
        self.comms = {k: (src, remap[s])
                      for k, (src, s) in self.comms.items()}

    # ------------------------------------------------------------ projection
    @classmethod
    def from_projection(cls, inst, coarse: "ScheduleState",
                        cmap) -> "ScheduleState":
        """Expand a coarse schedule onto the fine DAG (multilevel V-cycle).

        ``cmap[v]`` is the coarse cluster of fine node v.  Every member of
        a cluster inherits every coarse ``(processor, superstep)``
        assignment of that cluster -- replica sets project member-wise --
        and communications are re-derived **canonically** from the expanded
        assignment (one comm per (value, consuming processor), sourced at
        the earliest replica, placed at the latest valid superstep: the
        same rule as ``list_sched.derive_comms``).  Coarse comms are *not*
        projected: one coarse comm stands for one comm per boundary member
        at the fine level, so re-derivation is the only canonical choice.

        The load rows are rebuilt in one vectorized pass (``np.bincount``
        per kind) whose accumulation order matches a from-scratch
        primitive-op build (ascending node id, then sorted assignments,
        then sorted comm keys) cell for cell, so rows, step costs, total
        and comms are **bit-identical** to one -- property-tested by
        ``tests/test_torch_schedule.py``.  (The top-2 argmax may pick
        a different processor among *tied* maxima than the incremental
        maintenance would; any tied index is a valid triple, and when two
        choices exist the runner-up equals the maximum, so every delta
        prices identically either way.)  Validity of the coarse
        schedule implies validity of the expansion: cluster-internal
        dependencies land in the same compute phase on the same processor,
        cross-cluster dependencies inherit the coarse presence guarantees.
        """
        import numpy as np

        cmap = np.asarray(cmap, dtype=np.int64)
        dag, P = inst.dag, inst.P
        if cmap.shape != (dag.n,):
            raise ValueError("cmap must have shape (n,)")
        assert coarse.inst.P == P, "fine and coarse instances disagree on P"
        sched = cls(inst, coarse.S)
        # per-cluster assignment lists, sorted once (deterministic order),
        # flattened so the member-wise expansion is one vectorized gather
        # (ascending node id, then sorted (p, s) -- the exact input order
        # the bincounts below need for bit-identity with a primitive build)
        cl_items = [sorted(a.items()) for a in coarse.assign]
        k_arr = np.fromiter((len(ci) for ci in cl_items), dtype=np.int64,
                            count=len(cl_items))
        cl_off = np.zeros(len(cl_items) + 1, dtype=np.int64)
        np.cumsum(k_arr, out=cl_off[1:])
        cl_p = np.fromiter((p for ci in cl_items for p, _ in ci),
                           dtype=np.int64, count=int(cl_off[-1]))
        cl_s = np.fromiter((s for ci in cl_items for _, s in ci),
                           dtype=np.int64, count=int(cl_off[-1]))
        counts = k_arr[cmap]
        node_rep = np.repeat(np.arange(dag.n, dtype=np.int64), counts)
        cum = np.zeros(dag.n + 1, dtype=np.int64)
        np.cumsum(counts, out=cum[1:])
        pos = cl_off[cmap[node_rep]] \
            + np.arange(len(node_rep), dtype=np.int64) - cum[node_rep]
        p_arr, s_arr = cl_p[pos], cl_s[pos]
        assign, comp = sched.assign, sched.comp
        for v, p, s in zip(node_rep.tolist(), p_arr.tolist(),
                           s_arr.tolist()):
            assign[v][p] = s
            comp[s][p].add(v)
        idx_w = s_arr * P + p_arr
        comms, src_index = sched.comms, sched.src_index
        c_v, c_src, c_dst, c_t = _canonical_comm_plan_arrays(dag, assign)
        for v, src, p, t in zip(c_v.tolist(), c_src.tolist(),
                                c_dst.tolist(), c_t.tolist()):
            comms[(v, p)] = (src, t)
            src_index[(v, src)].add(p)
        idx_s = c_t * P + c_src
        idx_r = c_t * P + c_dst
        # bulk row rebuild: bincount accumulates in input order, which is
        # exactly the sequential add_comp/add_comm order above
        cells = coarse.S * P
        work = np.bincount(idx_w, weights=dag.omega[node_rep],
                           minlength=cells)
        mu_c = dag.mu[c_v]
        sent = np.bincount(idx_s, weights=mu_c, minlength=cells)
        recv = np.bincount(idx_r, weights=mu_c, minlength=cells)
        sched.work = work.reshape(coarse.S, P).tolist()
        sched.sent = sent.reshape(coarse.S, P).tolist()
        sched.recv = recv.reshape(coarse.S, P).tolist()
        sched._wtop = [_retop(r) for r in sched.work]
        sched._stop = [_retop(r) for r in sched.sent]
        sched._rtop = [_retop(r) for r in sched.recv]
        sched._scost = [sched._step_cost(sched._wtop[s][0],
                                         max(sched._stop[s][0],
                                             sched._rtop[s][0]))
                        for s in range(sched.S)]
        sched._total = sum(sched._scost)
        return sched

    def copy(self):
        """Deep copy (undo log excluded; not allowed mid-transaction)."""
        assert not self._frames, "copy inside an open transaction"
        other = type(self).__new__(type(self))
        other.inst = self.inst
        other.S = self.S
        other.comp = [[set(ps) for ps in row] for row in self.comp]
        other.comms = dict(self.comms)
        other.src_index = defaultdict(set)
        for k, dsts in self.src_index.items():
            if dsts:
                other.src_index[k] = set(dsts)
        other.assign = [dict(a) for a in self.assign]
        other.work = [list(r) for r in self.work]
        other.sent = [list(r) for r in self.sent]
        other.recv = [list(r) for r in self.recv]
        other._wtop = [list(t) for t in self._wtop]
        other._stop = [list(t) for t in self._stop]
        other._rtop = [list(t) for t in self._rtop]
        other._scost = list(self._scost)
        other._total = self._total
        other._undo = []
        other._frames = []
        other._replaying = False
        other._prune_dirty = set(self._prune_dirty)
        return other

    # ------------------------------------------------------------ invariants
    def check(self, require_compact: bool = False) -> None:
        """Assert every derived quantity against a from-scratch rebuild.

        With ``require_compact=True`` additionally assert the no-empty-
        superstep invariant: every superstep holds at least one compute
        entry or comm, so superstep indices cannot drift between the
        engine and the oracle across winner-commit rounds (split/merge
        passes run ``compact()`` after each committed winner)."""
        P = self.inst.P
        dag = self.inst.dag
        work = [[0.0] * P for _ in range(self.S)]
        sent = [[0.0] * P for _ in range(self.S)]
        recv = [[0.0] * P for _ in range(self.S)]
        for v in range(dag.n):
            for p, s in self.assign[v].items():
                work[s][p] += dag.omega[v]
        for (v, dst), (src, s) in self.comms.items():
            sent[s][src] += dag.mu[v]
            recv[s][dst] += dag.mu[v]
        for s in range(self.S):
            for p in range(P):
                assert abs(work[s][p] - self.work[s][p]) < 1e-9, \
                    f"work[{s}][{p}] drifted"
                assert abs(sent[s][p] - self.sent[s][p]) < 1e-9, \
                    f"sent[{s}][{p}] drifted"
                assert abs(recv[s][p] - self.recv[s][p]) < 1e-9, \
                    f"recv[{s}][{p}] drifted"
        for kind in _KINDS:
            rows, tops = self._rows_top(kind)
            for s in range(self.S):
                m1, i1, m2 = tops[s]
                assert m1 == max(rows[s]), f"{kind} top1 drifted at s={s}"
                assert rows[s][i1] == m1, f"{kind} argmax drifted at s={s}"
                want2 = max((rows[s][q] for q in range(P) if q != i1),
                            default=0.0)
                assert m2 == want2, f"{kind} top2 drifted at s={s}"
        for s in range(self.S):
            assert abs(self._scost[s] - self.superstep_cost(s)) < 1e-9, \
                f"step cost drifted at s={s}"
        assert abs(self._total - sum(self._scost)) < 1e-9, "total drifted"
        for (v, dst), (src, s) in self.comms.items():
            assert dst in self.src_index[(v, src)], "src_index drifted"
        for (v, src), dsts in self.src_index.items():
            for dst in dsts:
                assert self.comms.get((v, dst), (None,))[0] == src, \
                    "src_index stale entry"
        if require_compact:
            for s in range(self.S):
                assert any(self.comp[s][p] for p in range(P)) \
                    or any(work[s]) or any(sent[s]) or any(recv[s]), \
                    f"empty superstep {s} survived compact"

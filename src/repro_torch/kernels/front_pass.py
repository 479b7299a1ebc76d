"""Device-resident refinement passes: whole FM / replication sweeps in torch.

The engine's state stays resident on the device across an entire
refinement pass: an int32 mirror of ``uncov`` (columns in popcount order),
the edge lambdas and the node masks.  The whole per-visit pipeline -- row
gather, popcount-ordered masked-min lambda pricing (the ``front_dlam``
CUDA kernel), integer cost reduction, winner argmin -- runs on the device,
and the host reads back one (position, kind, processor) triple per
committed move, applies the move to both the host engine and the device
mirror, and re-enters the scan at the next position.

Correctness contract (property-tested against the numpy frontier path):

  * **Bit-identical decisions.**  The device pipeline is all-integer: when
    ``mu`` is integer-valued, cost deltas are exact int32, the host's
    float64 thresholds collapse to integer ones (``delta < -1e-12``  <=>
    ``delta <= -1``;  drop ``delta <= 1e-12``  <=>  ``delta <= 0``), and
    ``argmin``/``argmax`` pick the first extremum on both sides -- so the
    committed trajectory equals the numpy frontier path's, move for move.
    Integer sums make the ``index_add_`` segment sums order-free, so the
    card's atomics are exact.  Non-integer weights take the per-front path.
  * **Feasibility stays on the host.**  Capacity tests compare float64
    loads exactly as ``PartitionState.fits`` does; the host uploads the
    (n + 1, P) feasibility mask whenever a load changed, so no device
    float compare can flip a knife-edge decision.
  * **The scan.**  Candidate fronts are the flat (pair, edge) expansion --
    for each visited node, P candidate masks x its incident edges -- packed
    into fixed blocks (``R_blk`` rows, ``R_blk // P`` node slots, a node
    never split) in visit order.  A block is active when one of its nodes
    was boundary at pass start or was dirtied by a committed move; the host
    knows which, so a find evaluates only the active blocks from the
    current position on, in chunks of 1, 2, 4, ... blocks (capped at
    ``_CHUNK_BYTES`` of materialized rows).  Each chunk is one batched
    gather, one kernel launch, one segment sum and one masked argmin,
    ending in one blocking read; the find stops at the first chunk with an
    event.  State does not change inside a find, so this gives the first
    hit of a block-by-block scan exactly.
  * **Counters.**  ``syncs`` counts blocking reads, ``finds`` the finds
    that read at least one chunk (a find with no active block left reads
    nothing), ``commits`` the committed moves and ``pass_scans`` the
    passes.  ``commits <= finds <= commits + pass_scans`` and
    ``syncs >= finds`` hold.
  * **Queued applies.**  The engine hook *queues* mutations; the next find
    applies the newest one on the device before its scan, on the same
    stream and with no read.  Older entries -- only possible after host-
    side phases that mutate without a following find (the replication
    edge-guided phase) -- go out as standalone applies, counted in
    ``apply_dispatches``: zero across any pure FM / node-sweep pass.
"""
from __future__ import annotations

import numpy as np
import torch

from .gain import _NO_COVER, front_dlam, min_cover

# Below this node count the per-front numpy path wins (device dispatch and
# block padding dominate); tests monkeypatch it to exercise the device path
# on small instances.
DEVICE_MIN_NODES = 4096

_R_BLK_MIN = 2048
_INT32_BUDGET = 2 ** 30  # headroom below int32 max for any partial sum
# cap on the int32 candidate rows one find chunk materializes
_CHUNK_BYTES = 256 << 20
_BIG = int(np.iinfo(np.int32).max)


def _integer_valued(a: np.ndarray) -> bool:
    a = np.asarray(a, dtype=np.float64)
    return bool(np.all(np.isfinite(a)) and np.all(a == np.rint(a)))


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def attach(state, cap: float, *, device: str | torch.device = "cuda",
           min_nodes: int | None = None):
    """Build a ``DevicePartitionPass`` mirroring ``state`` on ``device``,
    or None.

    Returns None -- caller falls back to the per-front path -- when the
    instance is too small to pay for device dispatch, mu is not
    integer-valued (the all-integer device pipeline would not be
    bit-identical), a node is unassigned, or an int32 partial sum could
    overflow.  On success the engine's ``device`` hook is set so every
    ``apply``/``undo`` keeps the device mirror in lockstep.
    """
    if state.backend != "numpy" or state.device is not None:
        return None
    hg = state.hg
    floor = DEVICE_MIN_NODES if min_nodes is None else min_nodes
    if hg.n < floor:
        return None
    if not _integer_valued(state.mu) or np.any(state.mu < 0):
        return None
    if np.any(state.masks == 0):
        # host derives a -1 primary for unassigned nodes, the device table
        # cannot; refinement never unassigns, so the check holds for a pass
        return None
    mu_i = np.rint(state.mu).astype(np.int64)
    # worst-case |delta| for one candidate: sum of incident mu * (P - 1)
    deg = np.diff(state.xinc)
    if len(state.inc_edges):
        wsum = np.bincount(
            np.repeat(np.arange(hg.n), deg), weights=mu_i[state.inc_edges],
            minlength=hg.n)
    else:
        wsum = np.zeros(hg.n)
    if wsum.max(initial=0.0) * max(state.P - 1, 1) >= _INT32_BUDGET:
        return None
    dev = DevicePartitionPass(state, cap, device=device)
    state.device = dev
    return dev


class DevicePartitionPass:
    """Device mirror of a ``PartitionState`` plus the pass pipeline.

    Columns of ``uncov``/``contrib`` are stored pre-permuted in popcount
    order (column 0 = subset 0), so lambda pricing is a pure masked min
    with no per-call gather.  A dummy edge row E (mu 0, all-zero uncov) and
    a dummy node row n (infeasible everywhere) absorb all padding.
    """

    def __init__(self, state, cap: float, *,
                 device: str | torch.device) -> None:
        self.device = torch.device(device)
        self.state = state
        self.cap = float(cap)
        hg = state.hg
        self.n = hg.n
        self.P = state.P
        self.nsub = 1 << state.P
        self.E = len(hg.edges)
        self.xinc = np.asarray(state.xinc, dtype=np.int64)
        self.inc_edges_np = np.asarray(state.inc_edges, dtype=np.int64)
        self.deg = np.diff(self.xinc).astype(np.int64)
        self.Dmax = int(self.deg.max(initial=0))
        max_rows = self.P * max(self.Dmax, 1)
        self.R_blk = max(_R_BLK_MIN, _pow2(max_rows))
        self.B_blk = self.R_blk // self.P
        self._chunk_max = max(1, _CHUNK_BYTES // (self.R_blk * self.nsub * 4))
        # column permutation: subset 0 first, then popcount order
        self.colmap = np.concatenate(
            ([0], np.asarray(state._order, dtype=np.int64)))
        pc_p = np.concatenate(
            ([_NO_COVER], np.asarray(state._order_pc, dtype=np.int64)))
        self._pc = self._up(pc_p.astype(np.int32))
        self._contrib = self._up(
            np.ascontiguousarray(state._contrib[:, self.colmap],
                                 dtype=np.int32))
        self._popcnt = self._up(np.asarray(state.popcnt, dtype=np.int32))
        prim = np.maximum(
            np.array([int(m).bit_length() - 1 for m in range(self.nsub)],
                     dtype=np.int32), 0)
        self._prim = self._up(prim)
        mu_i = np.zeros(self.E + 1, dtype=np.int32)
        mu_i[:self.E] = np.rint(state.mu).astype(np.int32)
        self._mu = self._up(mu_i)
        self._inc_edges = self._up(self.inc_edges_np)
        self._qbits = self._up((1 << np.arange(self.P)).astype(np.int32))
        self._allq = self._up(np.arange(self.P, dtype=np.int32))
        self._owner = np.repeat(np.arange(self.n), self.deg)  # bnd scatter
        # mutation queue: host applies are *deferred*; the next find applies
        # the newest one before its scan
        self._pending: list[tuple[int, int, int]] = []
        self._refresh_from_host()
        self._fits = np.zeros((self.n + 1, self.P), dtype=bool)
        self._fits_t = None
        self._last_loads = None
        self._dirty = np.zeros(self.n, dtype=bool)
        # instrumentation (sync = blocking device->host read)
        self.syncs = 0
        self.finds = 0
        self.commits = 0
        self.pass_scans = 0
        self.apply_dispatches = 0  # standalone applies dispatched

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> a device tensor that owns its memory."""
        return torch.tensor(a, device=self.device)

    # ------------------------------------------------------------ buffers
    def _refresh_from_host(self) -> None:
        """Full host -> device upload of uncov / lambdas / masks."""
        st = self.state
        self._pending.clear()   # host state already includes queued moves
        uncov_p = np.zeros((self.E + 1, self.nsub), dtype=np.int32)
        uncov_p[:self.E] = st.uncov[:, self.colmap]
        self._uncov = self._up(uncov_p)
        # device lambda: masked-min value; differs from the engine's only
        # on rows with no assigned pins (engine 0, masked-min 1) -- the
        # relu(cost) terms agree, so deltas are unaffected
        lam = np.ones(self.E + 1, dtype=np.int32)
        lam[:self.E] = np.where(st.uncov[:, 0] == 0, 1, st.edge_lambda)
        self._lam = self._up(lam)
        masks = np.ones(self.n + 1, dtype=np.int32)
        masks[:self.n] = st.masks
        self._masks = self._up(masks)

    def detach(self) -> None:
        self.state.device = None

    # -------------------------------------------------------- engine hook
    def apply(self, v: int, old: int, new: int) -> None:
        """Mirror one host ``apply``/``undo`` mutation.

        Deferred: the mutation is queued and applied by the *next* find
        (``_call_find``).  ``flush`` forces the queue down when device
        buffers must be current with no find in sight (tests,
        detach-and-inspect).
        """
        self._pending.append((int(v), int(old), int(new)))

    def _apply_now(self, v: int, old: int, new: int) -> None:
        """Add the contrib difference to v's incident uncov rows, then
        recompute their lambdas from the updated rows."""
        lo, hi = int(self.xinc[v]), int(self.xinc[v + 1])
        if hi > lo and old != new:
            e_win = self._inc_edges[lo:hi]   # distinct edges: plain index_put_
            self._uncov[e_win] += self._contrib[new] - self._contrib[old]
            self._lam[e_win] = min_cover(self._uncov[e_win], self._pc,
                                         count_as="min_cover_apply")
        self._masks[v] = new

    def flush(self) -> None:
        """Dispatch every queued mutation as a standalone apply."""
        pending, self._pending = self._pending, []
        for v, old, new in pending:
            self._apply_now(v, old, new)
            self.apply_dispatches += 1

    # ------------------------------------------------------- find pipeline
    def _eval_blocks(self, bs: np.ndarray, rep: bool, fits: torch.Tensor,
                     start_pos: int, resume_p: int,
                     maxrep: int) -> torch.Tensor:
        """First event over blocks ``bs`` (visit order) as a device triple
        (pos, kind, q); pos = n when none of them holds an event."""
        P, B, nsub, n = self.P, self.B_blk, self.nsub, self.n
        k = len(bs)
        bs_t = torch.from_numpy(bs).to(self.device)
        edges = self._blk_edge[bs_t]            # (k, R_blk)
        pairs = self._blk_pair[bs_t]            # (k, R_blk)
        nodes = self._blk_node[bs_t]            # (k, B_blk)
        poss = self._blk_pos[bs_t].reshape(-1)  # (k * B_blk,)
        m_old = self._masks[nodes]              # (k, B_blk)
        qof = pairs % P
        m_row = torch.gather(m_old, 1, pairs // P)
        lam_old = self._lam[edges].reshape(-1)
        mu_row = self._mu[edges].reshape(-1)
        seg = (torch.arange(k, device=self.device)[:, None] * (B * P)
               + pairs).reshape(-1)
        in_win = ((poss >= start_pos) & (poss < n)).reshape(k, B)
        fits_n = fits[nodes]                    # (k, B_blk, P)

        def deltas_for(cand_row):
            rows = self._uncov[edges]
            rows += self._contrib[cand_row]
            rows -= self._contrib[m_row]
            terms = front_dlam(rows.reshape(-1, nsub), self._pc,
                               lam_old) * mu_row
            out = torch.zeros(k * B * P, dtype=torch.int32,
                              device=self.device)
            return out.index_add_(0, seg, terms).reshape(k, B, P)

        def first(mask):
            # sel stays a 1-element tensor and is read with ``take``:
            # indexing with a 0-dim tensor would read it on the host
            flat = mask.reshape(-1)
            sel = flat.to(torch.int32).argmax().reshape(1)  # first True
            return sel, flat.take(sel)

        if not rep:
            # FM: candidate masks 1 << q, primary excluded
            d_move = deltas_for(self._qbits[qof])
            feas = fits_n & (self._allq != self._prim[m_old][..., None])
            masked = torch.where(feas, d_move, _BIG)
            bestq = masked.argmin(dim=2)
            bestd = masked.gather(2, bestq[..., None])[..., 0]
            sel, found = first((bestd <= -1) & in_win)
            pos = torch.where(found, poss.take(sel), n)
            q = torch.where(found, bestq.take(sel), 0)
            return torch.cat([pos, torch.zeros_like(pos), q])

        # replication: add step then drop step, host visit order
        kk = self._popcnt[m_old]
        unset = ((m_old[..., None] >> self._allq) & 1) == 0
        d_add = deltas_for(m_row | self._qbits[qof])
        feas_add = fits_n & unset & (kk < maxrep)[..., None]
        masked = torch.where(feas_add, d_add, _BIG)
        bestq = masked.argmin(dim=2)
        bestd = masked.gather(2, bestq[..., None])[..., 0]
        if resume_p >= 0:
            add_sup = (poss == start_pos).reshape(k, B)
        else:
            add_sup = torch.zeros_like(in_win)
        has_add = (bestd <= -1) & in_win & ~add_sup
        d_drop = deltas_for(m_row & ~self._qbits[qof])
        minp = torch.where(add_sup, resume_p, 0)
        elig_drop = (~unset & (kk > 1)[..., None] & (d_drop <= 0)
                     & (self._allq >= minp[..., None]) & in_win[..., None])
        dropp = elig_drop.to(torch.int32).argmax(dim=2)
        has_drop = elig_drop.gather(2, dropp[..., None])[..., 0]
        sel, found = first(has_add | has_drop)
        add_sel = has_add.take(sel)
        kind = (~add_sel).long()                 # 0 = add, 1 = drop
        q = torch.where(add_sel, bestq.take(sel), dropp.take(sel))
        return torch.cat([torch.where(found, poss.take(sel), n), kind,
                          torch.where(found, q, 0)])

    # ------------------------------------------------------- block builder
    def _build_blocks(self, perm: np.ndarray) -> None:
        """Pack the pass's flat (pair, edge) expansion into device blocks."""
        P, R_blk, B_blk = self.P, self.R_blk, self.B_blk
        n = len(perm)
        deg = self.deg[perm]
        d = np.maximum(deg, 1)
        rpn = P * d
        cum = np.cumsum(rpn)
        bounds = [0]
        while bounds[-1] < n:
            i = bounds[-1]
            base = int(cum[i - 1]) if i else 0
            j = int(np.searchsorted(cum, base + R_blk, side="right"))
            bounds.append(min(max(j, i + 1), i + B_blk, n))
        NB = len(bounds) - 1
        bounds = np.asarray(bounds, dtype=np.int64)
        total = int(cum[-1])
        owner = np.repeat(np.arange(n, dtype=np.int64), rpn)
        starts = cum - rpn
        off = np.arange(total, dtype=np.int64) - starts[owner]
        q = off // d[owner]
        eoff = off % d[owner]
        vo = perm[owner]
        has = deg[owner] > 0
        if len(self.inc_edges_np):
            src = np.minimum(self.xinc[vo] + eoff,
                             len(self.inc_edges_np) - 1)
            edges = np.where(has, self.inc_edges_np[src], self.E)
        else:
            edges = np.full(total, self.E, dtype=np.int64)
        blk_of = np.searchsorted(bounds, owner, side="right") - 1
        pair = (owner - bounds[blk_of]) * P + q
        rows_at = np.concatenate(([0], cum))[bounds]
        blk_edge = np.full((NB, R_blk), self.E, dtype=np.int64)
        # padding rows funnel into the last (slot, q) segment; their edge is
        # the dummy E (mu 0), so they add exact zeros wherever they land
        blk_pair = np.full((NB, R_blk), B_blk * P - 1, dtype=np.int64)
        blk_node = np.full((NB, B_blk), self.n, dtype=np.int64)
        blk_pos = np.full((NB, B_blk), self.n, dtype=np.int64)
        for b in range(NB):
            r0, r1 = int(rows_at[b]), int(rows_at[b + 1])
            blk_edge[b, :r1 - r0] = edges[r0:r1]
            blk_pair[b, :r1 - r0] = pair[r0:r1]
            i0, i1 = int(bounds[b]), int(bounds[b + 1])
            blk_node[b, :i1 - i0] = perm[i0:i1]
            blk_pos[b, :i1 - i0] = np.arange(i0, i1)
        self._bounds = bounds
        self._nb = NB
        self._blk_edge = self._up(blk_edge)
        self._blk_pair = self._up(blk_pair)
        self._blk_node = self._up(blk_node)
        self._blk_pos = self._up(blk_pos)

    # --------------------------------------------------------- host helpers
    def _boundary_start(self, rep: bool) -> np.ndarray:
        """Nodes that can hold an event at pass start (visit-time exact
        elsewhere: any other node must be dirtied first -- see module
        docstring)."""
        st = self.state
        flag = np.asarray(st.edge_lambda > 1)
        if len(self._owner):
            cnt = np.bincount(self._owner[flag[self.inc_edges_np]],
                              minlength=self.n)
            bnd = cnt > 0
        else:
            bnd = np.zeros(self.n, dtype=bool)
        if rep:
            bnd = bnd | (np.asarray(st.popcnt[st.masks]) > 1)
        return bnd

    def _fits_now(self) -> torch.Tensor:
        """(n+1, P) feasibility on the device; recomputes only the columns
        whose load changed and uploads only when one did."""
        st = self.state
        loads = np.asarray(st.loads, dtype=np.float64)
        if self._last_loads is None:
            changed = np.ones(self.P, dtype=bool)
        else:
            changed = loads != self._last_loads
        if changed.any():
            for p in np.flatnonzero(changed):
                self._fits[:self.n, p] = st.omega + loads[p] <= self.cap
            self._fits_t = self._up(self._fits)
            self._last_loads = loads.copy()
        return self._fits_t

    def _active_blocks(self, bnd_start: np.ndarray) -> np.ndarray:
        av = (bnd_start | self._dirty)[self._perm]
        counts = np.add.reduceat(av.astype(np.int64), self._bounds[:-1])
        return counts > 0

    def _mark_dirty(self, v: int) -> None:
        hg = self.state.hg
        self._dirty[hg.adj_nodes[hg.xadj[v]:hg.xadj[v + 1]]] = True
        self._dirty[v] = True

    def _call_find(self, rep: bool, b0: int, start_pos: int, resume_p: int,
                   maxrep: int, bnd_start: np.ndarray):
        # apply the newest queued mutation ahead of the scan; older queue
        # entries -- only possible after host-side phases between passes --
        # go out as standalone applies
        if self._pending:
            *older, newest = self._pending
            self._pending = older
            self.flush()
            self._apply_now(*newest)
        fits = self._fits_now()
        blocks = np.flatnonzero(self._active_blocks(bnd_start)[b0:]) + b0
        if len(blocks):
            self.finds += 1
        i, k = 0, 1
        while i < len(blocks):
            out = self._eval_blocks(blocks[i:i + k], rep, fits, start_pos,
                                    resume_p, maxrep)
            pos, kind, q = out.tolist()   # THE host sync of this chunk
            self.syncs += 1
            if pos < self.n:
                return pos, kind, q
            i += k
            k = min(2 * k, self._chunk_max)
        return self.n, 0, 0

    def _block_of(self, pos: int) -> int:
        return int(np.searchsorted(self._bounds, pos, side="right")) - 1

    # ------------------------------------------------------------ FM pass
    def run_fm(self, rng: np.random.Generator, passes: int) -> None:
        """Device-resident ``fm_refine`` sweep (decision-identical)."""
        st = self.state
        for _ in range(passes):
            perm = rng.permutation(self.n)
            if not self.fm_pass(perm):
                break
        return st.masks

    def fm_pass(self, perm: np.ndarray) -> bool:
        st = self.state
        self._perm = np.asarray(perm, dtype=np.int64)
        self._dirty[:] = False
        bnd = self._boundary_start(rep=False)
        self._build_blocks(self._perm)
        pos, improved = 0, False
        while pos < self.n:
            fpos, _, q = self._call_find(False, self._block_of(pos), pos, -1,
                                         0, bnd)
            if fpos >= self.n:
                self.pass_scans += 1
                break
            v = int(self._perm[fpos])
            st.apply(v, 1 << q)
            st.commit()
            self.commits += 1
            self._mark_dirty(v)
            improved = True
            pos = fpos + 1
        else:
            self.pass_scans += 1
        return improved

    # ----------------------------------------------------- replication pass
    def rep_pass(self, perm: np.ndarray, max_replicas: int | None) -> bool:
        """Device-resident add/drop node sweep of ``replicate_local_search``
        (the edge-guided phase stays on the host engine; its mutations reach
        the device through the engine hook)."""
        st = self.state
        self._perm = np.asarray(perm, dtype=np.int64)
        self._dirty[:] = False
        bnd = self._boundary_start(rep=True)
        self._build_blocks(self._perm)
        maxrep = self.P + 1 if max_replicas is None else int(max_replicas)
        pos, resume_p, improved = 0, -1, False
        while pos < self.n:
            fpos, kind, q = self._call_find(
                True, self._block_of(pos), pos, resume_p, maxrep, bnd)
            if fpos >= self.n:
                self.pass_scans += 1
                break
            v = int(self._perm[fpos])
            m = int(st.masks[v])
            if kind == 0:  # add replica q, then move on (host `continue`)
                st.apply(v, m | (1 << q))
                pos, resume_p = fpos + 1, -1
            else:          # drop replica q, resume same node at p = q + 1
                st.apply(v, m & ~(1 << q))
                pos, resume_p = fpos, q + 1
            st.commit()
            self.commits += 1
            self._mark_dirty(v)
            improved = True
        else:
            self.pass_scans += 1
        return improved

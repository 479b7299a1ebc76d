"""Device-resident refinement passes: whole FM / replication sweeps in torch.

The engine's state stays resident on the device across an entire
refinement pass: an int32 mirror of ``uncov`` (columns in popcount order),
the edge lambdas and the node masks.  The whole per-visit pipeline -- the
queued applies, row pricing by popcount-ordered masked min, integer cost
sums, winner selection -- is one ``front_find`` call: on the card one
launch of the hand-written kernel in ``csrc/front_find.cu``.  The host
reads back one (position, kind, processor) triple per committed move,
applies the move to the host engine (which queues it for the device
mirror), and re-enters the scan at the next position.

Correctness contract (property-tested against the numpy frontier path):

  * **Bit-identical decisions.**  The device pipeline is all-integer: when
    ``mu`` is integer-valued, cost deltas are exact int32, the host's
    float64 thresholds collapse to integer ones (``delta < -1e-12``  <=>
    ``delta <= -1``;  drop ``delta <= 1e-12``  <=>  ``delta <= 0``), and
    ``argmin``/``argmax`` pick the first extremum on both sides -- so the
    committed trajectory equals the numpy frontier path's, move for move.
    Integer sums are order-free, so the card's parallel sums are exact.
    Non-integer weights take the per-front path.
  * **Feasibility stays on the host.**  Capacity tests compare float64
    loads exactly as ``PartitionState.fits`` does; the host uploads the
    (n + 1, P) feasibility mask whenever a load changed, so no device
    float compare can flip a knife-edge decision.
  * **The scan.**  The pass's visit order is cut into blocks of whole
    nodes (at most ``R_blk`` (node, q, edge) rows and ``R_blk // P`` nodes
    each).  A block is active when one of its nodes was boundary at pass
    start or was dirtied by a committed move; the host knows which, and a
    find evaluates the active blocks from the current position on.  State
    does not change inside a find, so the first event over them is the
    first hit of a block-by-block scan.  On the card that is one launch
    over all of them; the plain version on the CPU takes them in chunks of
    1, 2, 4, ... blocks (capped at ``_CHUNK_BYTES`` of materialized rows),
    one read per chunk, stopping at the first chunk with an event.
  * **Counters.**  ``syncs`` counts blocking reads, ``finds`` the finds
    that read at least one chunk (a find with no active block left reads
    nothing), ``commits`` the committed moves and ``pass_scans`` the
    passes.  ``commits <= finds <= commits + pass_scans`` and
    ``syncs >= finds`` hold; on the card ``syncs == finds``.
  * **Queued applies.**  The engine hook *queues* mutations; the next find
    applies the whole queue ahead of its scan, in the same launch.  A find
    with no active block leaves the queue for the next one.  ``flush``
    applies it with no find (tests, detach-and-inspect), counted in
    ``apply_dispatches``: zero on the partitioning path.

The schedule side (``DeviceScheduleWindows``) keeps a BSP schedule's
per-superstep rows on the device and prices comm and compute re-timing
windows and compound node moves with plain int32 PyTorch ops (no
hand-written kernel), one host read per priced window; decisions stay on
the host (``list_sched._best_window_move``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import ops
from .front_find import FindInputs, front_find
from .gain import _NO_COVER

# Below this node count the per-front numpy path wins (device dispatch and
# block padding dominate); tests monkeypatch it to exercise the device path
# on small instances.
DEVICE_MIN_NODES = 4096

_R_BLK_MIN = 2048
_INT32_BUDGET = 2 ** 30  # headroom below int32 max for any partial sum
# cap on the int32 candidate rows one find chunk materializes
_CHUNK_BYTES = 256 << 20


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

    Columns of ``uncov`` are stored pre-permuted in popcount order (column
    0 = subset 0), so lambda pricing is a pure masked min with no per-call
    gather; the row a pin adds is computed from each column's subset
    (``_colsub``), so no contrib table goes to the device.  A dummy edge row
    E (mu 0, all-zero uncov) and a dummy node row n (infeasible everywhere)
    keep the JAX package's buffer shapes.
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
        # chunks of the plain version's find (the card scans in one launch)
        self._chunk_max = max(1, _CHUNK_BYTES // (self.R_blk * self.nsub * 4))
        # column permutation: subset 0 first, then popcount order
        self.colmap = np.concatenate(
            ([0], np.asarray(state._order, dtype=np.int64)))
        pc_p = np.concatenate(
            ([_NO_COVER], np.asarray(state._order_pc, dtype=np.int64)))
        self._pc = self._up(pc_p.astype(np.int32))
        self._colsub = self._up(self.colmap.astype(np.int32))
        mu_i = np.zeros(self.E + 1, dtype=np.int32)
        mu_i[:self.E] = np.rint(state.mu).astype(np.int32)
        self._mu = self._up(mu_i)
        self._xinc = self._up(self.xinc.astype(np.int32))
        self._inc_edges = self._up(self.inc_edges_np.astype(np.int32))
        self._owner = np.repeat(np.arange(self.n), self.deg)  # bnd scatter
        # mutation queue: host applies are *deferred*; the next find applies
        # the whole queue before its scan
        self._pending: list[tuple[int, int, int]] = []
        self._refresh_from_host()
        self._fits = np.zeros((self.n + 1, self.P), dtype=bool)
        self._fits_t = None
        self._last_loads = None
        self._dirty = np.zeros(self.n, dtype=bool)
        self._build_blocks(np.arange(self.n, dtype=np.int64))
        # instrumentation (sync = blocking device->host read)
        self.syncs = 0
        self.finds = 0
        self.commits = 0
        self.pass_scans = 0
        self.apply_dispatches = 0  # flushes of the queue with no find

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

    def flush(self) -> None:
        """Apply the whole queue now, with no scan and no read: on the card
        one launch of the find kernel, counted as ``front_apply``."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        front_find(self._inputs(), pending, np.zeros(0, dtype=np.int64),
                   rep=False, start_pos=self.n, resume_p=-1, maxrep=0,
                   count_as="front_apply")
        self.apply_dispatches += 1

    def _inputs(self) -> FindInputs:
        return FindInputs(
            uncov=self._uncov, lam=self._lam, masks=self._masks, mu=self._mu,
            colsub=self._colsub, pc=self._pc, xinc=self._xinc,
            inc_edges=self._inc_edges, perm=self._perm_t,
            bounds=self._bounds_t, bounds_host=self._bounds,
            fits=self._fits_now())

    # ------------------------------------------------------- block builder
    def _build_blocks(self, perm: np.ndarray) -> None:
        """Cut the visit order ``perm`` into blocks of whole nodes, at most
        ``R_blk`` (node, q, edge) rows and ``B_blk`` nodes each, and put the
        order and the block bounds on the device."""
        P, R_blk, B_blk = self.P, self.R_blk, self.B_blk
        self._perm = np.asarray(perm, dtype=np.int64)
        n = len(perm)
        cum = np.cumsum(P * np.maximum(self.deg[self._perm], 1))
        bounds = [0]
        while bounds[-1] < n:
            i = bounds[-1]
            base = int(cum[i - 1]) if i else 0
            j = int(np.searchsorted(cum, base + R_blk, side="right"))
            bounds.append(min(max(j, i + 1), i + B_blk, n))
        self._bounds = np.asarray(bounds, dtype=np.int64)
        self._nb = len(bounds) - 1
        self._perm_t = self._up(self._perm.astype(np.int32))
        self._bounds_t = self._up(self._bounds.astype(np.int32))

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
        blocks = np.flatnonzero(self._active_blocks(bnd_start)[b0:]) + b0
        if not len(blocks):
            return self.n, 0, 0      # nothing to scan: the queue waits
        self.finds += 1
        x = self._inputs()
        queue, self._pending = self._pending, []
        if ops.use_kernel(self._uncov):
            chunks = [blocks]        # one launch, one read
        else:
            sizes = [1]
            while sum(sizes) < len(blocks):
                sizes.append(min(2 * sizes[-1], self._chunk_max))
            chunks = np.split(blocks, np.cumsum(sizes)[:-1])
        for part in chunks:
            out = front_find(x, queue, part, rep=rep, start_pos=start_pos,
                             resume_p=resume_p, maxrep=maxrep)
            queue = []
            pos, kind, q = out.tolist()   # THE host sync of this chunk
            self.syncs += 1
            if pos < self.n:
                return pos, kind, q
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
        self._dirty[:] = False
        bnd = self._boundary_start(rep=False)
        self._build_blocks(perm)
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
        self._dirty[:] = False
        bnd = self._boundary_start(rep=True)
        self._build_blocks(perm)
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


# ==========================================================================
# Schedule side
# ==========================================================================

# Minimum touched-superstep count for the device node-move fold; below it
# the numpy front prices the move (tests lower it to reach the device path
# on small instances).
DEVICE_MIN_STEPS = 8


def schedule_device_supported(sched) -> bool:
    """Integer contract check: the int32 window programs are bit-identical
    to the float64 numpy fronts only for integral weights/parameters."""
    inst = sched.inst
    return (_integer_valued(inst.dag.mu) and _integer_valued(inst.dag.omega)
            and float(inst.L) == int(inst.L) and float(inst.g) == int(inst.g))


class DeviceScheduleWindows:
    """Device mirror of the schedule's per-superstep rows.

    Holds ``sent``/``recv``/``work`` (S, P), the top-2 triples and the step
    costs as one padded int32 tensor on ``device`` (one upload per
    refresh), refreshed lazily after each commit (``mark_dirty``).  The
    window pricers return the same float64 deltas as
    ``schedule_front.price_comm_moves`` / ``price_comp_moves`` /
    ``price_node_moves`` -- integer device arithmetic plus the host's exact
    float64 scalar terms -- so every decision matches the numpy fronts.
    The programs are plain int32 PyTorch ops; on CPU tensors the same code
    runs on the CPU.

    Counters: ``syncs`` the blocking device->host reads (one per priced
    window), ``refreshes`` the uploads of the rows, ``launches`` the window
    programs run, per program (``comm``, ``comp``, ``node``).
    """

    def __init__(self, sched, *, device: str | torch.device) -> None:
        self.device = torch.device(device)
        self.sched = sched
        self.P = sched.inst.P
        self.L = int(sched.inst.L)
        self.g = int(sched.inst.g)
        self._dirty = True
        self._arange: dict[int, torch.Tensor] = {}
        self.syncs = 0
        self.refreshes = 0
        self.launches = {"comm": 0, "comp": 0, "node": 0}

    def mark_dirty(self) -> None:
        self._dirty = True

    def _refresh(self) -> None:
        """Upload the rows: columns ``sent | recv | work`` (P each), the
        sent, recv and work top-2 triples (3 each) and the step cost."""
        s = self.sched
        S, P = s.S, self.P
        self.Sp = _pow2(S)
        rows = np.zeros((self.Sp, 3 * P + 10), dtype=np.int32)
        for i, ll in enumerate((s.sent, s.recv, s.work)):
            rows[:S, i * P:(i + 1) * P] = np.asarray(ll[:S])
        for i, tt in enumerate((s._stop, s._rtop, s._wtop)):
            rows[:S, 3 * P + 3 * i:3 * P + 3 * i + 3] = np.asarray(tt[:S])
        rows[:S, 3 * P + 9] = np.asarray(s._scost[:S])
        self._rows = torch.from_numpy(rows).to(self.device)
        self._dirty = False
        self.refreshes += 1

    def _gather(self, lo: int, Wp: int) -> torch.Tensor:
        """Rows ``lo .. lo + Wp - 1``, the index clamped into the padded
        table (as ``jnp.clip`` clamps it in the JAX program)."""
        ar = self._arange.get(Wp)
        if ar is None:
            ar = torch.arange(Wp, dtype=torch.int64, device=self.device)
            self._arange[Wp] = ar
        return self._rows[(ar + lo).clamp_(0, self.Sp - 1)]

    def _step_cost(self, w1: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return torch.where(h >= 1, w1 + self.L + self.g * h, w1)

    def _top(self, rows: torch.Tensor, i: int) -> tuple:
        o = 3 * self.P + 3 * i
        return rows[:, o], rows[:, o + 1], rows[:, o + 2]

    def _comm_window(self, lo: int, Wp: int, src: int, dst: int,
                     mu: int) -> torch.Tensor:
        """Step-cost deltas of adding ``mu`` to ``sent[t, src]`` and
        ``recv[t, dst]`` for t in the window, int32 (Wp,)."""
        P = self.P
        r = self._gather(lo, Wp)
        s1, s_arg, s2 = self._top(r, 0)
        r1, r_arg, r2 = self._top(r, 1)
        s_alt = torch.where(s_arg == src, s2, s1)
        s_new = r[:, src] + mu
        r_alt = torch.where(r_arg == dst, r2, r1)
        r_new = r[:, P + dst] + mu
        h = torch.maximum(torch.maximum(s_alt, s_new),
                          torch.maximum(r_alt, r_new))
        return self._step_cost(self._top(r, 2)[0], h) - r[:, 3 * P + 9]

    def _comp_window(self, lo: int, Wp: int, p: int,
                     om: int) -> torch.Tensor:
        """Step-cost deltas of adding ``om`` to ``work[t, p]`` for t in the
        window, int32 (Wp,)."""
        P = self.P
        r = self._gather(lo, Wp)
        w1, w_arg, w2 = self._top(r, 2)
        w_alt = torch.where(w_arg == p, w2, w1)
        w_new = r[:, 2 * P + p] + om
        h = torch.maximum(self._top(r, 0)[0], self._top(r, 1)[0])
        return (self._step_cost(torch.maximum(w_alt, w_new), h)
                - r[:, 3 * P + 9])

    def _read(self, out: torch.Tensor, n: int) -> np.ndarray:
        got = out[:n].cpu().numpy().astype(np.float64)  # THE host sync
        self.syncs += 1
        return got

    def price_comm_moves(self, v: int, dst: int, ts: np.ndarray) -> np.ndarray:
        """Device twin of ``schedule_front.price_comm_moves``."""
        if self._dirty:
            self._refresh()
        sched = self.sched
        src, s = sched.comms[(v, dst)]
        mu = sched.inst.dag.mu[v]
        d0 = sched._comm_step_delta(s, src, dst, -mu)
        ts = np.asarray(ts, dtype=np.int64)
        lo, W = int(ts[0]), len(ts)
        out = self._comm_window(lo, _pow2(W), int(src), int(dst), int(mu))
        self.launches["comm"] += 1
        deltas = d0 + self._read(out, W)
        deltas[ts == s] = 0.0
        return deltas

    def price_comp_moves(self, v: int, p: int, ts: np.ndarray) -> np.ndarray:
        """Device twin of ``schedule_front.price_comp_moves``."""
        if self._dirty:
            self._refresh()
        sched = self.sched
        s = sched.assign[v][p]
        om = sched.inst.dag.omega[v]
        w1_minus = sched._kind_max_if("work", s, p, -om)
        d_s = sched._step_cost(w1_minus, sched.h_of(s)) - sched._scost[s]
        ts = np.asarray(ts, dtype=np.int64)
        lo, W = int(ts[0]), len(ts)
        out = self._comp_window(lo, _pow2(W), int(p), int(om))
        self.launches["comp"] += 1
        deltas = d_s + self._read(out, W)
        deltas[ts == s] = 0.0
        return deltas

    def _node_fold(self, cells: torch.Tensor) -> torch.Tensor:
        """Fold the (Tp, P, P) work/sent/recv delta cells (candidate q x
        processor) of ``cells`` -- column 0 the touched step, then the
        three flattened matrices -- against the step rows: the summed
        step-cost delta per candidate, int32 (P,)."""
        P = self.P
        Tp = cells.shape[0]
        r = self._rows[cells[:, 0].long()]
        d = cells[:, 1:].view(Tp, 3, P, P)
        w1 = (r[:, None, 2 * P:3 * P] + d[:, 0]).amax(dim=2)
        s1 = (r[:, None, 0:P] + d[:, 1]).amax(dim=2)
        r1 = (r[:, None, P:2 * P] + d[:, 2]).amax(dim=2)
        step = self._step_cost(w1, torch.maximum(s1, r1))
        return (step - r[:, 3 * P + 9, None]).sum(dim=0, dtype=torch.int32)

    def price_node_moves(self, v: int) -> np.ndarray:
        """Device twin of ``schedule_front.price_node_moves``: the
        per-superstep (P x P) delta matrices fold on the device in one
        program.  Takes the numpy front when few supersteps are touched."""
        from ..core.frontier.schedule_front import price_node_moves
        sched = self.sched
        P = self.P
        (p, _), = sched.assign[v].items()
        cells = _node_move_cells(sched, v)
        if len(cells) < DEVICE_MIN_STEPS:
            return price_node_moves(sched, v)
        if self._dirty:
            self._refresh()
        steps = sorted(cells)
        # padded rows fold step 0 with zero deltas, which adds exactly 0
        packed = np.zeros((_pow2(len(steps)), 1 + 3 * P * P), dtype=np.int32)
        for i, t in enumerate(steps):
            packed[i, 0] = t
            packed[i, 1:] = np.concatenate([c.ravel() for c in cells[t]])
        out = self._node_fold(torch.from_numpy(packed).to(self.device))
        self.launches["node"] += 1
        deltas = self._read(out, P)
        deltas[p] = 0.0
        return deltas


def _node_move_cells(sched, v: int) -> dict:
    """Per-superstep (work, sent, recv) (P, P) int delta matrices of the
    compound node move -- the same cells ``price_node_moves`` accumulates,
    in the same fill order (int32; caller guarantees integral weights)."""
    P = sched.inst.P
    (p, s), = sched.assign[v].items()
    dag = sched.inst.dag
    mu, om = int(dag.mu[v]), int(dag.omega[v])
    allq = np.arange(P)
    cells: dict[int, list] = {}

    def at(t):
        got = cells.get(t)
        if got is None:
            got = [np.zeros((P, P), dtype=np.int32) for _ in range(3)]
            cells[t] = got
        return got

    for dst in sorted(sched.src_index.get((v, p), ())):
        _, t = sched.comms[(v, dst)]
        _, se, r = at(t)
        se[:, p] -= mu
        r[dst, dst] -= mu
        keep = allq != dst
        se[allq[keep], allq[keep]] += mu
    for q in range(P):
        c0 = sched.comms.get((v, q))
        if c0 is not None and c0[0] != p:
            src0, t0 = c0
            at(t0)[1][q, src0] -= mu
            at(t0)[2][q, q] -= mu
    w = at(s)[0]
    w[:, p] -= om
    w[allq, allq] += om
    uses_p = sched.uses_on(v, p)
    if uses_p:
        tf = min(uses_p) - 1
        at(tf)[1][allq, allq] += mu
        at(tf)[2][:, p] += mu
    return cells

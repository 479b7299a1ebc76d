"""The device partition pass's find: one launch per committed move.

``front_find`` applies the queued host mutations to the pass's device
buffers, then scans the active blocks in visit order and returns the first
event as an int32 ``(pos, kind, q)`` triple (``pos = n``: none).  On CUDA
tensors it is one cooperative launch of the hand-written kernel in
``csrc/front_find.cu``; on CPU tensors it is ``front_find_ref``, the plain
PyTorch version (``ops.use_kernel``).  Both update ``uncov``, ``lam`` and
``masks`` in place.

``FindInputs`` holds what a find reads: the buffers of
``front_pass.DevicePartitionPass`` (columns of ``uncov`` in popcount order,
``colsub`` the subset of each column, ``pc`` its popcount with the no-cover
sentinel at column 0), the incidence CSR, the pass's visit order and block
bounds (on the device, and ``bounds_host`` on the host, where the active
blocks are chosen), and the (n + 1, P) feasibility mask.

The work list of a launch is one int32 array: the Q queued mutations as
(v, old, new) triples, the NA active blocks in ascending order and the
NA + 1 prefix counts of their positions (``pack_work``).  ``front_find``
copies it to the card from a pinned staging buffer; ``launch`` takes it
already on the card (the smoke run times pure launches that way).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import ops
from .ref import front_dlam_ref, min_cover_ref

__all__ = ["FindInputs", "front_find", "front_find_ref", "launch",
           "pack_work", "upload_work"]

_BIG = int(np.iinfo(np.int32).max)
THREADS = 256                      # per CTA of the find (csrc kThreads)
_INT32 = (torch.int32,)


@dataclass
class FindInputs:
    uncov: torch.Tensor      # (E + 1, M) int32, updated by the apply
    lam: torch.Tensor        # (E + 1,) int32, updated by the apply
    masks: torch.Tensor      # (n + 1,) int32, updated by the apply
    mu: torch.Tensor         # (E + 1,) int32
    colsub: torch.Tensor     # (M,) int32: the subset of each column
    pc: torch.Tensor         # (M,) int32: popcounts, _NO_COVER at column 0
    xinc: torch.Tensor       # (n + 1,) int32
    inc_edges: torch.Tensor  # (xinc[n],) int32
    perm: torch.Tensor       # (n,) int32: the visit order
    bounds: torch.Tensor     # (NB + 1,) int32: first position of each block
    bounds_host: np.ndarray  # the same bounds on the host
    fits: torch.Tensor       # (n + 1, P) bool

    @property
    def n(self) -> int:
        return self.perm.shape[0]

    @property
    def P(self) -> int:
        return self.fits.shape[1]


def pack_work(queue, blocks: np.ndarray, bounds_host: np.ndarray) -> np.ndarray:
    """The int32 work list: queue triples, active blocks, prefix counts."""
    blocks = np.asarray(blocks, dtype=np.int64)
    if len(blocks) and (blocks.min() < 0 or blocks.max() >= len(bounds_host) - 1
                        or np.any(np.diff(blocks) <= 0)):
        raise ValueError("blocks must be ascending block indices")
    sizes = bounds_host[blocks + 1] - bounds_host[blocks]
    cum = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum(sizes, out=cum[1:])
    q = np.asarray(queue, dtype=np.int64).reshape(-1)
    if len(q) and (q[::3].min() < 0 or q[::3].max() >= bounds_host[-1]):
        raise ValueError("a queued mutation names no node of the pass")
    return np.concatenate((q, blocks, cum)).astype(np.int32)


# ------------------------------------------------------------ plain version
def _contrib_rows(m: torch.Tensor, colsub: torch.Tensor) -> torch.Tensor:
    """(k, M) int32: the uncov row a pin of each mask in ``m`` adds --
    1 where the mask misses the column's subset, all 0 for mask 0."""
    m = m.reshape(-1, 1)
    return (((m & colsub[None, :]) == 0) & (m != 0)).to(torch.int32)


def _apply_ref(x: FindInputs, queue) -> None:
    """The queued mutations one at a time: the contrib difference added to
    v's incident uncov rows, their lambdas recomputed, ``masks[v] = new``."""
    for v, old, new in queue:
        lo, hi = int(x.xinc[v]), int(x.xinc[v + 1])
        if hi > lo and old != new:
            e = x.inc_edges[lo:hi].long()   # distinct edges
            rows = _contrib_rows(torch.tensor([new, old], dtype=torch.int32,
                                              device=x.uncov.device),
                                 x.colsub)
            x.uncov[e] += rows[0] - rows[1]
            x.lam[e] = min_cover_ref(x.uncov[e], x.pc)
        x.masks[v] = new


def _first(ev: torch.Tensor) -> torch.Tensor:
    """1-element index of the first True of ``ev`` (0 where none)."""
    return ev.to(torch.int32).argmax().reshape(1)


def front_find_ref(x: FindInputs, queue, blocks: np.ndarray, *, rep: bool,
                   start_pos: int, resume_p: int,
                   maxrep: int) -> torch.Tensor:
    """Plain version of ``front_find``: apply ``queue``, then the first
    event over the positions ``>= start_pos`` of ``blocks`` (ascending), as
    an int32 (pos, kind, q) tensor; kind 0 is a move or an add, 1 a drop.

    Every candidate row ``uncov[e] - contrib[m] + contrib[c]`` is built in
    full and priced by ``front_dlam_ref``, the terms times ``mu`` summed per
    (node, q) with ``index_add_``; the selection is the JAX find program's.
    """
    _apply_ref(x, queue)
    dev, P, n = x.uncov.device, x.P, x.n
    bh = x.bounds_host
    if len(blocks) == 0:
        return torch.tensor([n, 0, 0], dtype=torch.int32, device=dev)
    pos = torch.from_numpy(np.concatenate(
        [np.arange(bh[b], bh[b + 1]) for b in blocks])).to(dev)
    nodes = x.perm[pos].long()
    m_old = x.masks[nodes]
    lo = x.xinc[nodes].long()
    deg = x.xinc[nodes + 1].long() - lo
    N = len(nodes)
    owner = torch.repeat_interleave(torch.arange(N, device=dev), deg)
    first_row = torch.cumsum(deg, 0) - deg
    off = torch.arange(len(owner), device=dev) - first_row[owner]
    edges = x.inc_edges[lo[owner] + off].long()
    m_row = m_old[owner]
    base = x.uncov[edges] - _contrib_rows(m_row, x.colsub)
    lam_old, mu = x.lam[edges], x.mu[edges]
    cols = []
    for q in range(P):
        cand = (m_row ^ (1 << q)) if rep else torch.full_like(m_row, 1 << q)
        terms = front_dlam_ref(base + _contrib_rows(cand, x.colsub), x.pc,
                               lam_old) * mu
        cols.append(torch.zeros(N, dtype=torch.int32, device=dev)
                    .index_add_(0, owner, terms))
    d = torch.stack(cols, dim=1)                         # (N, P)
    allq = torch.arange(P, device=dev, dtype=torch.int32)
    fits_n = x.fits[nodes]
    in_win = pos >= start_pos
    bit = ((m_old[:, None] >> allq) & 1) == 1
    if not rep:
        # the primary: the highest set bit (0 for mask 0)
        prim = torch.where(bit, allq, 0).amax(dim=1)
        feas = fits_n & (allq != prim[:, None])
        masked = torch.where(feas, d, _BIG)
        bestq = masked.argmin(dim=1)
        bestd = masked.gather(1, bestq[:, None])[:, 0]
        ev = (bestd <= -1) & in_win
        kind = torch.zeros_like(bestq)
        q = bestq
    else:
        kk = bit.sum(dim=1)
        feas_add = fits_n & ~bit & (kk < maxrep)[:, None]
        masked = torch.where(feas_add, d, _BIG)
        bestq = masked.argmin(dim=1)
        bestd = masked.gather(1, bestq[:, None])[:, 0]
        if resume_p >= 0:
            add_sup = pos == start_pos
        else:
            add_sup = torch.zeros_like(in_win)
        has_add = (bestd <= -1) & in_win & ~add_sup
        minp = torch.where(add_sup, resume_p, 0)
        elig_drop = (bit & (kk > 1)[:, None] & (d <= 0)
                     & (allq >= minp[:, None]) & in_win[:, None])
        dropp = elig_drop.to(torch.int32).argmax(dim=1)
        has_drop = elig_drop.gather(1, dropp[:, None])[:, 0]
        ev = has_add | has_drop
        kind = (~has_add).long()
        q = torch.where(has_add, bestq, dropp)
    sel = _first(ev)
    found = ev.take(sel)
    return torch.cat([torch.where(found, pos.take(sel), n),
                      torch.where(found, kind.take(sel), 0),
                      torch.where(found, q.take(sel), 0)]).to(torch.int32)


# ------------------------------------------------------------------- kernel
class _Staging:
    """A pinned host buffer and its device twin for the work list; an event
    marks when the last copy out of the host buffer finished."""

    def __init__(self, size: int, device: torch.device) -> None:
        self.host = torch.empty(size, dtype=torch.int32, pin_memory=True)
        self.host_np = self.host.numpy()
        self.dev = torch.empty(size, dtype=torch.int32, device=device)
        self.done = torch.cuda.Event()
        self.done.record()


_staging: dict[torch.device, _Staging] = {}


def _stage(device: torch.device, size: int) -> _Staging:
    st = _staging.get(device)
    if st is None or st.host.shape[0] < size:
        st = _Staging(max(1024, 1 << (size - 1).bit_length()), device)
        _staging[device] = st
    return st


def upload_work(work: np.ndarray, device: torch.device) -> torch.Tensor:
    """``work`` on the card through the pinned staging buffer, on the
    current stream (the returned view is reused by the next upload)."""
    st = _stage(device, len(work))
    st.done.synchronize()        # the previous copy has left the host buffer
    st.host_np[:len(work)] = work
    out = st.dev[:len(work)]
    out.copy_(st.host[:len(work)], non_blocking=True)
    st.done.record()
    return out


def _check(x: FindInputs, work: torch.Tensor) -> None:
    dev = x.uncov.device
    n, P = x.n, x.P
    if not 1 <= P <= 12 or x.uncov.dim() != 2:
        raise ValueError(f"front_find takes 1 <= P <= 12, got fits "
                         f"{tuple(x.fits.shape)}")
    E1, M = x.uncov.shape
    ops.check("uncov", x.uncov, (E1, 1 << P), _INT32, dev)
    for name, t, shape in (("lam", x.lam, (E1,)), ("masks", x.masks, (n + 1,)),
                           ("mu", x.mu, (E1,)), ("colsub", x.colsub, (M,)),
                           ("pc", x.pc, (M,)), ("xinc", x.xinc, (n + 1,)),
                           ("inc_edges", x.inc_edges, x.inc_edges.shape),
                           ("perm", x.perm, (n,)),
                           ("bounds", x.bounds, x.bounds.shape),
                           ("work", work, work.shape)):
        ops.check(name, t, shape, _INT32, dev)
    ops.check("fits", x.fits, (n + 1, P), (torch.bool,), dev)


def launch(x: FindInputs, work: torch.Tensor, Q: int, NA: int, *, rep: bool,
           start_pos: int, resume_p: int, maxrep: int,
           count_as: str = "front_find") -> torch.Tensor:
    """One launch of the kernel on a work list already on the card; returns
    the (3,) int32 triple, still on the card."""
    from ._build import load
    _check(x, work)
    if work.numel() != 3 * Q + 2 * NA + 1:
        raise ValueError(f"work holds {work.numel()} entries, not the "
                         f"3 * {Q} + 2 * {NA} + 1 of its queue and blocks")
    dev = x.uncov.device
    out = torch.empty(3, dtype=torch.int32, device=dev)
    scratch = torch.empty(2, dtype=torch.int64, device=dev)  # key, ticket
    edges_ptr = x.inc_edges.data_ptr() if x.inc_edges.numel() else 0
    with torch.cuda.device(dev):
        err = load("front_find").repro_front_find(
            x.uncov.data_ptr(), x.lam.data_ptr(), x.masks.data_ptr(),
            x.mu.data_ptr(), x.colsub.data_ptr(), x.pc.data_ptr(),
            x.fits.data_ptr(), x.xinc.data_ptr(), edges_ptr,
            x.perm.data_ptr(), x.bounds.data_ptr(), work.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), x.n, x.P, int(rep), Q, NA,
            start_pos, resume_p, maxrep,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"front_find launch failed: CUDA error {err}")
    ops.launches[count_as] += 1
    return out


def front_find(x: FindInputs, queue, blocks: np.ndarray, *, rep: bool,
               start_pos: int, resume_p: int, maxrep: int,
               count_as: str = "front_find") -> torch.Tensor:
    """Apply ``queue`` and find the first event over ``blocks``: the kernel
    for CUDA buffers (one launch, counted under ``count_as``), else
    ``front_find_ref``.  Returns the (3,) int32 triple on the buffers'
    device; reading it is the caller's one device->host read."""
    if ops.use_kernel(x.uncov):
        ops.no_backward("front_find", x.uncov, x.lam)
        work = upload_work(pack_work(queue, blocks, x.bounds_host),
                           x.uncov.device)
        return launch(x, work, len(queue), len(blocks), rep=rep,
                      start_pos=start_pos, resume_p=resume_p, maxrep=maxrep,
                      count_as=count_as)
    return front_find_ref(x, queue, blocks, rep=rep, start_pos=start_pos,
                          resume_p=resume_p, maxrep=maxrep)


def find_grid(P: int, rep: bool, device: torch.device) -> int:
    """The cooperative grid of the find for (P, rep) on ``device``, in CTAs
    of ``THREADS`` threads."""
    from ._build import load
    with torch.cuda.device(device):
        grid = load("front_find").repro_front_find_grid(P, int(rep))
    if grid <= 0:
        raise RuntimeError(f"the find for P={P} cannot run cooperatively")
    return grid


def empty_launch(grid: int, block: int, device: torch.device,
                 cooperative: bool = False) -> None:
    """An empty kernel on ``grid`` CTAs of ``block`` threads (a cooperative
    launch if asked): the launch-latency floor that the smoke run prints
    beside a kernel of the same grid, the find's or another source's."""
    from ._build import load
    with torch.cuda.device(device):
        err = load("front_find").repro_empty_launch(
            grid, block, int(cooperative),
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"empty launch failed: CUDA error {err}")

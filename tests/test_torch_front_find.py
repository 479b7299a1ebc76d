"""The device pass's find (``repro_torch.kernels.front_find``) on the CPU.

``front_find_ref``, the plain version of the fused find kernel, is held
against an independent block-by-block scan written here in numpy (the
queued applies, then each position's candidate rows priced one by one);
the port's single find (``DevicePartitionPass._call_find``) against the JAX
package's (``_make_find`` / ``_call_find``, the Pallas kernel in interpret
mode) on the same state, visit order and start positions.  Every value is
an integer, so every comparison is exact.  The CUDA kernel is held against
``front_find_ref`` in ``test_torch_cuda.py``.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs tiny ops here: extra threads per pytest worker only contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core.frontier import device_pass as j_device_pass  # noqa: E402
from repro.core.hypergraph import Hypergraph as JHypergraph  # noqa: E402
from repro.core.partition import PartitionState as JState  # noqa: E402
from repro.core.partition.cost import capacity  # noqa: E402
from repro.kernels import front_pass as jfp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.hypergraph import Hypergraph  # noqa: E402
from repro_torch.core.frontier import device_pass  # noqa: E402
from repro_torch.core.partition import PartitionState  # noqa: E402
from repro_torch.kernels import front_find, front_pass  # noqa: E402

CPU = "cpu"


@contextlib.contextmanager
def small_device_floors(r_blk_min=16):
    """Device path for tiny instances, cut into many small row blocks, on
    both packages."""
    saved = [(m, a, getattr(m, a)) for m in (jfp, front_pass)
             for a in ("DEVICE_MIN_NODES", "_R_BLK_MIN")]
    for m in (jfp, front_pass):
        m.DEVICE_MIN_NODES = 1
        m._R_BLK_MIN = r_blk_min
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def random_edges(rng, n, m, isolated=5):
    """m edges of 2-5 distinct pins over the first n - isolated nodes."""
    live = n - isolated
    return [tuple(sorted(rng.choice(live, size=int(rng.integers(2, 6)),
                                    replace=False).tolist()))
            for _ in range(m)]


def random_masks(rng, n, P, rep):
    if rep:
        return rng.integers(1, 1 << P, size=n).astype(np.int64)
    return (1 << rng.integers(0, P, size=n)).astype(np.int64)


# ------------------------------------------------- the numpy block scan
def numpy_find(x, queue, blocks, *, rep, start_pos, resume_p, maxrep):
    """Apply ``queue`` and scan ``blocks`` position by position, pricing
    each candidate row alone: the first event and the buffers after."""
    uncov = x.uncov.numpy().astype(np.int64)
    lam = x.lam.numpy().astype(np.int64)
    masks = x.masks.numpy().astype(np.int64)
    colsub, pc = x.colsub.numpy(), x.pc.numpy()
    xinc, inc = x.xinc.numpy(), x.inc_edges.numpy()
    perm, bounds, fits = x.perm.numpy(), x.bounds_host, x.fits.numpy()
    P, n = fits.shape[1], len(perm)

    def contrib(m):
        return np.array([int(m != 0 and (m & s) == 0) for s in colsub])

    def lam_of(row):
        zero = row == 0
        return int(pc[zero].min()) if zero.any() else 127

    for v, old, new in queue:
        if old != new:
            for e in inc[xinc[v]:xinc[v + 1]]:
                uncov[e] += contrib(new) - contrib(old)
                lam[e] = lam_of(uncov[e])
        masks[v] = new
    after = (uncov, lam, masks)
    for b in blocks:
        for pos in range(bounds[b], bounds[b + 1]):
            if pos < start_pos:
                continue
            v = perm[pos]
            m = int(masks[v])
            d = [0] * P
            for e in inc[xinc[v]:xinc[v + 1]]:
                base = uncov[e] - contrib(m)
                for q in range(P):
                    cand = m ^ (1 << q) if rep else 1 << q
                    lq = lam_of(base + contrib(cand))
                    d[q] += int(mu_of(x, e)) * (max(lq - 1, 0)
                                                - max(int(lam[e]) - 1, 0))
            hit = select(d, m, fits[v], pos, rep=rep, start_pos=start_pos,
                         resume_p=resume_p, maxrep=maxrep)
            if hit is not None:
                return (pos,) + hit, after
    return (n, 0, 0), after


def mu_of(x, e):
    return x.mu[e].item()


def select(d, m, fits, pos, *, rep, start_pos, resume_p, maxrep):
    """(kind, q) of the node's event, or None: the device pass's rules
    written out per processor."""
    P = len(d)
    bits = [(m >> q) & 1 for q in range(P)]
    if not rep:
        prim = m.bit_length() - 1 if m else 0
        feas = [q for q in range(P) if fits[q] and q != prim]
        if feas:
            q = min(feas, key=lambda q: (d[q], q))
            if d[q] <= -1:
                return 0, q
        return None
    kk = sum(bits)
    add_sup = resume_p >= 0 and pos == start_pos
    feas = [q for q in range(P) if fits[q] and not bits[q] and kk < maxrep]
    if feas and not add_sup:
        q = min(feas, key=lambda q: (d[q], q))
        if d[q] <= -1:
            return 0, q
    minp = resume_p if add_sup else 0
    for q in range(P):
        if bits[q] and kk > 1 and d[q] <= 0 and q >= minp:
            return 1, q
    return None


# ------------------------------------------------------------- the states
def port_pass(hg, P, masks, seed):
    """The port's device pass on the CPU over ``hg``, blocks cut for a
    seeded visit order."""
    st = PartitionState(hg, P, masks=masks.copy())
    with small_device_floors():
        dev = device_pass(st, 1e9, backend="torch", device=CPU)
    assert dev is not None
    dev._build_blocks(np.random.default_rng(seed).permutation(hg.n))
    return st, dev


def queue_moves(st, rng, P, rep, count):
    """``count`` committed host moves, queued by the engine hook: node v,
    a node sharing v's first edge, v again, then random nodes."""
    e0 = st.hg.edges[0]
    nodes = [e0[0], e0[1], e0[0]] + rng.integers(0, st.hg.n, 8).tolist()
    for v in nodes[:count]:
        cur = int(st.masks[v])
        if not rep:                      # to the next processor
            new = 1 << (cur.bit_length() % P)
        else:                            # a replica added, or one dropped
            unset = [q for q in range(P) if not (cur >> q) & 1]
            q = int(rng.choice(unset)) if unset else int(rng.integers(0, P))
            new = cur | (1 << q) if unset else cur & ~(1 << q)
        st.apply(int(v), new)
        st.commit()


FIND_CASES = [
    # (mode, resume_p, maxrep, queued moves, start at the middle)
    ("fm", -1, None, 0, False),
    ("fm", -1, None, 1, True),
    ("fm", -1, None, 3, False),
    ("rep", -1, None, 0, False),
    ("rep", 1, None, 1, True),
    ("rep", 2, 2, 3, True),
    ("rep", -1, 2, 3, False),
]


@pytest.mark.parametrize("seed", [3, 29])
@pytest.mark.parametrize("mode,resume_p,maxrep,moves,mid", FIND_CASES)
def test_front_find_ref_matches_numpy_block_scan(mode, resume_p, maxrep,
                                                 moves, mid, seed):
    """Equal triples and equal uncov, lambda and mask buffers after the
    apply; the applied buffers also equal the host engine's."""
    rng = np.random.default_rng(seed)
    P, n, rep = 4, 60, mode == "rep"
    hg = Hypergraph(n=n, edges=random_edges(rng, n, 90), omega=np.ones(n),
                    mu=rng.integers(1, 6, size=90).astype(float))
    st, dev = port_pass(hg, P, random_masks(rng, n, P, rep), seed)
    try:
        queue_moves(st, rng, P, rep, moves)
        queue, dev._pending = list(dev._pending), []
        assert len(queue) == moves
        x = dev._inputs()
        fits = rng.random((n + 1, P)) < 0.75
        fits[n] = False
        x.fits = torch.from_numpy(fits)
        blocks = np.flatnonzero(rng.random(dev._nb) < 0.8)
        start = int(dev._bounds[blocks[len(blocks) // 2]]) + 1 if mid else 0
        kw = dict(rep=rep, start_pos=start, resume_p=resume_p,
                  maxrep=P + 1 if maxrep is None else maxrep)
        want, (uncov, lam, masks) = numpy_find(x, queue, blocks, **kw)
        got = front_find.front_find_ref(x, queue, blocks, **kw).tolist()
        assert got == list(want)
        assert np.array_equal(x.uncov.numpy(), uncov)
        assert np.array_equal(x.lam.numpy(), lam)
        assert np.array_equal(x.masks.numpy(), masks)
        assert np.array_equal(x.uncov.numpy()[:dev.E],
                              st.uncov[:, dev.colmap])
        assert np.array_equal(x.masks.numpy()[:n], st.masks)
    finally:
        dev.detach()


@pytest.mark.parametrize("case", ["ties", "empty", "apply_only"])
def test_front_find_ref_edge_cases(case):
    """Ties go to the lowest processor and the first position; an empty
    active list finds nothing; with no block the queue is applied alone."""
    hg = Hypergraph(n=4, edges=[(0, 1), (0, 2), (1, 3)], omega=np.ones(4),
                    mu=np.ones(3))
    st, dev = port_pass(hg, 4, np.array([1, 2, 4, 2]), 0)
    try:
        dev._build_blocks(np.arange(4))
        x = dev._inputs()
        x.fits = torch.ones_like(x.fits)
        x.fits[4] = False
        blocks = np.arange(dev._nb)
        kw = dict(rep=False, start_pos=0, resume_p=-1, maxrep=5)
        queue = []
        if case == "empty":
            blocks = blocks[:0]
        if case == "apply_only":
            blocks, queue = blocks[:0], [(3, 2, 8)]
        want, after = numpy_find(x, queue, blocks, **kw)
        got = front_find.front_find_ref(x, queue, blocks, **kw).tolist()
        assert got == list(want)
        for t, a in zip((x.uncov, x.lam, x.masks), after):
            assert np.array_equal(t.numpy(), a)
        if case == "ties":       # moving node 0 to 1 or 2 saves the same
            assert got == [0, 0, 1]
        else:
            assert got == [4, 0, 0]
        if case == "apply_only":
            assert int(x.masks[3]) == 8
    finally:
        dev.detach()


# ------------------------------------------------ against the JAX package
@pytest.mark.parametrize("mode,moves", [("fm", 0), ("fm", 2), ("rep", 1),
                                        ("rep", 3)])
def test_single_find_matches_jax_find(mode, moves):
    """One find at a time on the same state, visit order, queue and start
    positions: the port's ``_call_find`` (the plain version on the CPU)
    against the JAX package's find program (Pallas in interpret mode),
    equal triples and equal device buffers after the first."""
    rng = np.random.default_rng(41 + moves)
    P, n, rep = 4, 120, mode == "rep"
    m = 180
    edges = random_edges(rng, n, m)
    omega = np.ones(n)
    mu = rng.integers(1, 6, size=m).astype(float)
    jhg = JHypergraph(n=n, edges=edges, omega=omega, mu=mu)
    hg = convert.hypergraph_from_arrays(n, jhg.xpins, jhg.pins, omega, mu)
    masks = random_masks(rng, n, P, rep)
    cap = capacity(jhg, P, 0.6) + 1e-9
    sta = JState(jhg, P, masks=masks.copy())
    stb = PartitionState(hg, P, masks=masks.copy())
    jops.force("pallas")
    try:
        # the Pallas kernel takes rows in tiles of 512: blocks of 512 rows
        with small_device_floors(r_blk_min=512):
            da = j_device_pass(sta, cap, backend="jax")
            db = device_pass(stb, cap, backend="torch", device=CPU)
        perm = rng.permutation(n)
        for d in (da, db):
            d._perm = perm
            d._dirty[:] = False
            d._build_blocks(perm)
        moves_rng = [np.random.default_rng(7), np.random.default_rng(7)]
        for st, r in zip((sta, stb), moves_rng):
            queue_moves(st, r, P, rep, moves)
        bnd = db._boundary_start(rep)
        assert np.array_equal(bnd, da._boundary_start(rep))
        fn = da._find_rep if rep else da._find_fm
        for i, start in enumerate((0, n // 3, 2 * n // 3)):
            resume = 1 if rep and i == 1 else -1
            args = (db._block_of(start), start, resume, P + 1, bnd)
            got = db._call_find(rep, *args)
            want = da._call_find(fn, *args)
            assert got == tuple(want)
            if i == 0:
                for name in ("_uncov", "_lam", "_masks"):
                    assert np.array_equal(getattr(db, name).numpy(),
                                          np.asarray(getattr(da, name))), name
        assert db._nb > 2 and db.syncs >= db.finds > 0
    finally:
        jops.force(None)
        da.detach()
        db.detach()

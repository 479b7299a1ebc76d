"""The port's device-resident refinement (``repro_torch.kernels.front_pass``)
against the JAX package's (``repro.kernels.front_pass``).

Both packages get the same numpy instance and the same initial masks; the
JAX side runs its device pass (``frontier="jax"``), the port its own
(``frontier="torch"``, ``device="cpu"``, so the plain PyTorch versions of
the kernels).  The contract is bit-identity: equal masks, equal cost, and
the same committed moves.  The size floors are lowered on both modules so
that small instances take the device path.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs tiny ops here: extra threads per pytest worker only contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core.frontier import device_pass as j_device_pass  # noqa: E402
from repro.core.hypergraph import Hypergraph  # noqa: E402
from repro.core.partition import PartitionState as JState  # noqa: E402
from repro.core.partition import heuristic as jh  # noqa: E402
from repro.core.partition.cost import capacity  # noqa: E402
from repro.datagen import spmv_dataset  # noqa: E402
from repro.kernels import front_pass as jfp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.frontier import device_pass  # noqa: E402
from repro_torch.core.partition import PartitionState  # noqa: E402
from repro_torch.core.partition import heuristic as th  # noqa: E402
from repro_torch.kernels import front_pass  # noqa: E402

CPU = "cpu"


# ----------------------------------------------------------------- helpers

def int_hypergraph(rng, n=None, m=None):
    """Random hypergraph with integer weights (the device contract)."""
    n = n or int(rng.integers(8, 40))
    m = m or int(rng.integers(5, 60))
    edges = [tuple(rng.choice(n, size=int(rng.integers(2, min(6, n) + 1)),
                              replace=False)) for _ in range(m)]
    return Hypergraph(n=n, edges=edges,
                      omega=rng.integers(1, 5, size=n).astype(float),
                      mu=rng.integers(1, 6, size=m).astype(float))


def port(hg):
    """The reference instance carried across to the port."""
    return convert.hypergraph_from_arrays(hg.n, hg.xpins, hg.pins, hg.omega,
                                          hg.mu, name=hg.name)


@contextlib.contextmanager
def small_device_floors(r_blk_min=None):
    """Drop the node floor on both packages so tiny instances take the
    device path; ``r_blk_min`` also shrinks the row block so a pass spans
    many blocks (and the port's find many chunks)."""
    saved = [(m, a, getattr(m, a)) for m in (jfp, front_pass)
             for a in ("DEVICE_MIN_NODES", "_R_BLK_MIN")]
    for m in (jfp, front_pass):
        m.DEVICE_MIN_NODES = 1
        if r_blk_min is not None:
            m._R_BLK_MIN = r_blk_min
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


@contextlib.contextmanager
def count_finds():
    """Count the port's ``front_find`` calls from the device pass (on CPU
    tensors the wrapper launches nothing, so the launch counter stays 0)."""
    calls = []
    real = front_pass.front_find

    def spy(*a, **kw):
        calls.append(len(a[2]))
        return real(*a, **kw)

    front_pass.front_find = spy
    try:
        yield calls
    finally:
        front_pass.front_find = real


def _fm_pair(hg, P, eps, seed):
    m0 = jh.greedy_initial(hg, P, eps, np.random.default_rng(seed + 1000))
    ma, mb = m0.copy(), m0.copy()
    sta = JState(hg, P, masks=ma)
    thg = port(hg)
    stb = PartitionState(thg, P, masks=mb)
    jh.fm_refine(hg, ma, P, eps, np.random.default_rng(seed), state=sta,
                 frontier="jax")
    with count_finds() as calls:
        th.fm_refine(thg, mb, P, eps, np.random.default_rng(seed), state=stb,
                     frontier="torch", device=CPU)
    assert calls, "the port's device pass did not run"
    assert stb.device is None          # detached even on the device path
    return (ma, sta), (mb, stb)


# ------------------------------------------------- partition bit-identity

@pytest.mark.parametrize("seed", [0, 17, 404, 2025, 7777, 9001])
def test_fm_device_bit_identical(seed):
    """Whole-pass device FM: port == reference, masks and cost exact."""
    rng = np.random.default_rng(seed)
    hg = int_hypergraph(rng)
    P = int(rng.integers(2, 6))
    with small_device_floors():
        (ma, sta), (mb, stb) = _fm_pair(hg, P, 0.3, seed)
    assert np.array_equal(ma, mb)
    assert sta.cost == stb.cost


@pytest.mark.parametrize("max_replicas", [None, 2])
@pytest.mark.parametrize("seed", [1, 58, 913, 4242])
def test_rep_device_bit_identical(seed, max_replicas):
    """Device replication sweep (add/drop with the resume protocol),
    including the host edge-guided phase reaching the device through the
    engine hook: port == reference."""
    rng = np.random.default_rng(seed)
    hg = int_hypergraph(rng)
    P = int(rng.integers(2, 6))
    m0 = jh.greedy_initial(hg, P, 0.3, np.random.default_rng(seed + 1000))
    with small_device_floors(), count_finds() as calls:
        ra = jh.replicate_local_search(hg, m0.copy(), P, 0.3, seed=seed,
                                       max_replicas=max_replicas,
                                       frontier="jax")
        rb = th.replicate_local_search(port(hg), m0.copy(), P, 0.3,
                                       seed=seed, max_replicas=max_replicas,
                                       frontier="torch", device=CPU)
    assert calls
    assert np.array_equal(ra.masks, rb.masks)
    assert ra.cost == rb.cost


@pytest.mark.parametrize("mode", ["fm", "rep"])
def test_many_blocks_chunked_find_matches_block_scan(mode):
    """Small row blocks: a pass spans many blocks, the reference scans them
    one by one and the port evaluates them in doubling chunks; the first
    hit, and so every decision and counter, must agree."""
    hg = spmv_dataset("rn", count=1)[0]
    P = 4
    m0 = jh.greedy_initial(hg, P, 0.3, np.random.default_rng(5))
    cap = capacity(hg, P, 0.3) + 1e-9
    with small_device_floors(r_blk_min=16):
        sta = JState(hg, P, masks=m0.copy())
        stb = PartitionState(port(hg), P, masks=m0.copy())
        da = j_device_pass(sta, cap, backend="jax")
        db = device_pass(stb, cap, backend="torch", device=CPU)
        try:
            for p in range(4):
                perm = np.random.default_rng(p).permutation(hg.n)
                if mode == "fm":
                    ia, ib = da.fm_pass(perm), db.fm_pass(perm)
                else:
                    ia, ib = da.rep_pass(perm, None), db.rep_pass(perm, None)
                assert ia == ib
                assert db._nb > 4
        finally:
            da.detach()
            db.detach()
    assert np.array_equal(sta.masks, stb.masks) and sta.cost == stb.cost
    assert (da.commits, da.pass_scans) == (db.commits, db.pass_scans)
    assert db.syncs > db.finds       # some find read more than one chunk


def test_shipped_spmv_instance_bit_identical():
    """The port reproduces the reference on a real row-net SpMV
    hypergraph, not just synthetic randoms."""
    hg = spmv_dataset("rn", count=1)[0]
    with small_device_floors():
        (ma, sta), (mb, stb) = _fm_pair(hg, 4, 0.3, seed=7)
        assert np.array_equal(ma, mb) and sta.cost == stb.cost
        ra = jh.replicate_local_search(hg, ma.copy(), 4, 0.3, seed=7,
                                       frontier="jax")
        rb = th.replicate_local_search(port(hg), ma.copy(), 4, 0.3, seed=7,
                                       frontier="torch", device=CPU)
    assert np.array_equal(ra.masks, rb.masks) and ra.cost == rb.cost


def test_device_mirror_tracks_engine_hook():
    """Host-engine apply/undo keep the port's device uncov/lambda/mask
    buffers in lockstep without a refresh."""
    rng = np.random.default_rng(11)
    hg = port(int_hypergraph(rng, n=30, m=50))
    m0 = jh.greedy_initial(hg, 4, 0.3, np.random.default_rng(11))
    st_ = PartitionState(hg, 4, masks=m0.copy())
    cap = capacity(hg, 4, 0.3) + 1e-9
    with small_device_floors():
        dev = device_pass(st_, cap, backend="torch", device=CPU)
    assert dev is not None
    try:
        for v in range(0, 12):
            st_.apply(v, int(st_.masks[v]) | (1 << (v % 4)))
            if v % 3 == 0:
                st_.undo()
            else:
                st_.commit()
        # hook mutations are queued for the next find; flush forces them
        # down so the buffers can be inspected without a find
        assert len(dev._pending) > 0
        dev.flush()
        assert dev.apply_dispatches > 0 and not dev._pending
        got_uncov = dev._uncov.numpy()[:dev.E]
        assert np.array_equal(got_uncov, st_.uncov[:, dev.colmap])
        assert np.array_equal(dev._masks.numpy()[:hg.n], st_.masks)
        # device lambda = engine lambda, except 1 (not 0) on pinless rows
        want_lam = np.where(st_.uncov[:, 0] == 0, 1, st_.edge_lambda)
        assert np.array_equal(dev._lam.numpy()[:dev.E], want_lam)
    finally:
        dev.detach()
    assert st_.device is None


def test_sync_accounting_bound():
    """commits <= finds <= commits + pass_scans, syncs >= finds, and pure
    sweeps never pay a standalone apply; commits and pass scans equal the
    reference's, move for move."""
    rng = np.random.default_rng(7)
    hgj = int_hypergraph(rng, n=40, m=80)
    hg = port(hgj)
    m0 = jh.greedy_initial(hgj, 4, 0.3, np.random.default_rng(77))
    cap = capacity(hgj, 4, 0.3) + 1e-9

    def bounds(dev):
        assert dev.finds > 0 and dev.commits > 0
        assert dev.commits <= dev.finds <= dev.commits + dev.pass_scans
        assert dev.syncs >= dev.finds
        assert dev.apply_dispatches == 0

    with small_device_floors():
        st_ = PartitionState(hg, 4, masks=m0.copy())
        dev = device_pass(st_, cap, backend="torch", device=CPU)
        sj = JState(hgj, 4, masks=m0.copy())
        devj = j_device_pass(sj, cap, backend="jax")
        try:
            dev.run_fm(np.random.default_rng(7), 6)
            devj.run_fm(np.random.default_rng(7), 6)
        finally:
            dev.detach()
            devj.detach()
        bounds(dev)
        assert (dev.commits, dev.pass_scans) == (devj.commits,
                                                 devj.pass_scans)
        assert np.array_equal(st_.masks, sj.masks)
        # replication sweeps obey the same bounds
        st2 = PartitionState(hg, 4, masks=m0.copy())
        dev2 = device_pass(st2, cap, backend="torch", device=CPU)
        try:
            for p in range(4):
                if not dev2.rep_pass(np.random.default_rng(p).permutation(
                        hg.n), None):
                    break
        finally:
            dev2.detach()
        bounds(dev2)


def test_find_ties_go_to_lowest_processor_and_first_node():
    """Node 0 (on processor 0) shares one edge with node 1 (processor 1)
    and one with node 2 (processor 2): moving it to 1 or to 2 saves the
    same; the find takes processor 1, and node 0 as the first eligible
    position of the visit order."""
    hg = Hypergraph(n=4, edges=[(0, 1), (0, 2), (1, 3)],
                    omega=np.ones(4), mu=np.ones(3))
    masks = np.array([1, 2, 4, 2], dtype=np.int64)
    st_ = PartitionState(port(hg), 4, masks=masks)
    cap = capacity(hg, 4, 3.0) + 1e-9          # every move fits
    with small_device_floors():
        dev = device_pass(st_, cap, backend="torch", device=CPU)
    try:
        dev._perm = np.arange(4, dtype=np.int64)
        dev._build_blocks(dev._perm)
        bnd = dev._boundary_start(rep=False)
        assert dev._call_find(False, 0, 0, -1, 0, bnd) == (0, 0, 1)
        # from position 1 on: node 1 gains nothing (moving it to processor
        # 0 closes edge (0, 1) but cuts edge (1, 3)), so node 2 moves to 0
        assert dev._call_find(False, 0, 1, -1, 0, bnd) == (2, 0, 0)
    finally:
        dev.detach()


def test_attach_guards():
    """Attach declines float weights, unassigned nodes, sub-floor sizes and
    non-torch backends -- the host path keeps working untouched."""
    rng = np.random.default_rng(3)
    hgj = int_hypergraph(rng, n=30, m=40)
    hg = port(hgj)
    m0 = jh.greedy_initial(hgj, 4, 0.3, rng)
    cap = capacity(hgj, 4, 0.3) + 1e-9

    st_ = PartitionState(hg, 4, masks=m0.copy())
    assert device_pass(st_, cap, backend="numpy") is None
    assert front_pass.attach(st_, cap, device=CPU) is None  # below floor

    hg_f = convert.hypergraph_from_arrays(hg.n, hg.xpins, hg.pins, hg.omega,
                                          hg.mu + 0.5)      # non-integer mu
    st_f = PartitionState(hg_f, 4, masks=m0.copy())
    m_un = m0.copy()
    m_un[0] = 0                                             # unassigned node
    st_u = PartitionState(hg, 4, masks=m_un)
    with small_device_floors():
        assert device_pass(st_f, cap, backend="torch", device=CPU) is None
        assert device_pass(st_u, cap, backend="torch", device=CPU) is None
        dev = device_pass(st_, cap, backend="torch", device=CPU)
        assert dev is not None
        # a second mirror on an attached state is refused
        assert device_pass(st_, cap, backend="torch", device=CPU) is None
        dev.detach()
    assert st_.device is None and st_f.device is None and st_u.device is None

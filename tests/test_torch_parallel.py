"""The port's shared-memory worker pool (``core/partition/parallel.py``)
against the JAX package's, on the same instances.

Sharded heavy-pin matching and the scheduling V-cycle's sharded pair
generation are byte-identical to serial and to the reference, under
``fork`` and under ``spawn``; sharded refinement never worsens the cost
and reconciles to the reference's masks; segments never leak, and a
broken pool falls back to the serial path.  The workers run the numpy
frontier only (``tests/test_torch_no_jax.py`` checks what they import).
"""
import multiprocessing as mp
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core.partition import PartitionState as JState  # noqa: E402
from repro.core.partition import parallel as jpar  # noqa: E402
from repro.core.partition.heuristic import (  # noqa: E402
    partition_heuristic as j_heuristic,
    partition_with_replication as j_pwr)
from repro.core.partition.multilevel import (  # noqa: E402
    _match_pref as j_match_pref)
from repro.core.schedule import multilevel as jsml  # noqa: E402
from repro.datagen import large_row_net, large_sptrsv_dag  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.partition import PartitionState  # noqa: E402
from repro_torch.core.partition import parallel as par  # noqa: E402
from repro_torch.core.partition.heuristic import (  # noqa: E402
    partition_heuristic, partition_with_replication)
from repro_torch.core.partition.multilevel import (  # noqa: E402
    _match_pref, heavy_pin_matching)
from repro_torch.core.partition.parallel import (  # noqa: E402
    ParallelContext, parallel_refine, plan_shards)
from repro_torch.core.schedule import (  # noqa: E402
    BspInstance, MultilevelScheduleOptions, multilevel_schedule)
from repro_torch.core.schedule import multilevel as tsml  # noqa: E402
from repro_torch.core.schedule.list_sched import dag_levels  # noqa: E402

METHODS = ["fork", "spawn"]


@pytest.fixture
def shm():
    if not par.shm_available():
        pytest.skip("POSIX shared memory unavailable")


def method_or_skip(method):
    if method not in mp.get_all_start_methods():
        pytest.skip(f"{method} start method unavailable")


def port(hg):
    return convert.hypergraph_from_arrays(hg.n, hg.xpins, hg.pins, hg.omega,
                                          hg.mu, name=hg.name)


def port_dag(jd):
    return convert.dag_from_arrays(jd.n, jd.edge_src, jd.edge_dst, jd.omega,
                                   jd.mu, name=jd.name)


def test_match_pref_shards_bit_identical():
    """Per-range scores concatenate into the serial ``pref``, which equals
    the reference's."""
    jhg = large_row_net(1200, seed=1)
    hg = port(jhg)
    serial = _match_pref(hg, 24)
    assert np.array_equal(serial, j_match_pref(jhg, 24))
    for W in (2, 3, 7):
        b = plan_shards(hg, W)
        parts = [_match_pref(hg, 24, int(b[i]), int(b[i + 1]))
                 for i in range(W) if b[i + 1] > b[i]]
        assert np.array_equal(np.concatenate(parts), serial)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("method", METHODS)
def test_pooled_matching_bit_identical(shm, method, W):
    method_or_skip(method)
    hg = port(large_row_net(1200, seed=1))
    with ParallelContext(W, start_method=method, min_nodes=64) as ctx:
        cm_p, nc_p = heavy_pin_matching(hg, 50.0, np.random.default_rng(7),
                                        ctx=ctx)
        assert not ctx.failed
    cm_s, nc_s = heavy_pin_matching(hg, 50.0, np.random.default_rng(7))
    assert nc_p == nc_s and cm_p.tobytes() == cm_s.tobytes()


@pytest.mark.parametrize("kind", ["fm", "rep"])
@pytest.mark.parametrize("W", [1, 2])
def test_parallel_refine_cost_not_worse(shm, kind, W):
    """Reconciled sharded refinement never worsens the cost and leaves a
    state that passes the engine's invariant check; W = 1 is the serial
    leg of the same entry point."""
    hg = port(large_row_net(1200, seed=1))
    res = partition_heuristic(hg, 4, 0.1, seed=0, frontier="numpy")
    st = PartitionState(hg, 4, masks=res.masks.copy())
    c0 = st.cost
    with ParallelContext(W, min_nodes=64) as ctx:
        stats = parallel_refine(hg, st, 4, 0.1, ctx, kind, 2, seed=3)
        assert not ctx.failed
    assert st.cost <= c0 + 1e-9
    st.check()
    if W > 1:
        assert stats["workers"] == W and not stats["serial_fallback"]


@pytest.mark.parametrize("method", METHODS)
def test_parallel_refine_matches_reference(shm, method):
    """Same shards, same seeds: the port's pool reconciles to the
    reference pool's masks and cost."""
    method_or_skip(method)
    jhg = large_row_net(1200, seed=1)
    hg = port(jhg)
    res = j_heuristic(jhg, 4, 0.1, seed=0, frontier="numpy")
    jst = JState(jhg, 4, masks=res.masks.copy())
    st = PartitionState(hg, 4, masks=res.masks.copy())
    with jpar.ParallelContext(2, start_method=method, min_nodes=64) as ctx:
        jpar.parallel_refine(jhg, jst, 4, 0.1, ctx, "rep", 2, seed=3)
    with ParallelContext(2, start_method=method, min_nodes=64) as ctx:
        parallel_refine(hg, st, 4, 0.1, ctx, "rep", 2, seed=3)
        assert not ctx.failed
    assert np.array_equal(st.masks, jst.masks) and st.cost == jst.cost


def test_crash_cleanup_no_leaked_segments(shm):
    from multiprocessing import shared_memory
    hg = port(large_row_net(600, seed=1))
    ctx = ParallelContext(2, min_nodes=64)
    ctx.export_hg(hg)
    with pytest.raises(Exception):
        ctx.run(par._crash_task, [(None,), (None,)])
    names = list(ctx.reg.created)
    assert names and all(nm.startswith("repro_torch_") for nm in names)
    ctx.close()
    for nm in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=nm).close()


def test_pool_failure_falls_back_serial(shm):
    """After a worker death the context is failed and every call site
    takes its serial path: the matching stays byte-identical."""
    hg = port(large_row_net(1200, seed=1))
    res = partition_heuristic(hg, 4, 0.1, seed=0, frontier="numpy")
    st = PartitionState(hg, 4, masks=res.masks.copy())
    c0 = st.cost
    with ParallelContext(2, min_nodes=64) as ctx:
        with pytest.raises(Exception):
            ctx.run(par._crash_task, [(None,)])
        stats = parallel_refine(hg, st, 4, 0.1, ctx, "rep", 2, seed=3)
        assert ctx.failed            # the broken pool raised inside
        cm_p, _ = heavy_pin_matching(hg, 50.0, np.random.default_rng(7),
                                     ctx=ctx)
    assert stats["serial_fallback"]
    assert st.cost <= c0 + 1e-9
    st.check()
    cm_s, _ = heavy_pin_matching(hg, 50.0, np.random.default_rng(7))
    assert np.array_equal(cm_p, cm_s)


def test_state_usable_after_context_close(shm):
    hg = port(large_row_net(1200, seed=1))
    res = partition_heuristic(hg, 4, 0.1, seed=0, frontier="numpy")
    st = PartitionState(hg, 4, masks=res.masks.copy())
    ctx = ParallelContext(2, min_nodes=64)
    parallel_refine(hg, st, 4, 0.1, ctx, "fm", 1, seed=0)
    ctx.close()
    st.check()
    st.apply(0, int(st.masks[0]))
    st.undo()


def test_vcycle_with_workers_matches_reference(shm, monkeypatch):
    """``partition_with_replication(multilevel=True, workers=2)`` with the
    pool's floor lowered: the same masks and costs as the reference's
    pooled V-cycle, and replication pays."""
    monkeypatch.setattr(jpar, "PARALLEL_MIN_NODES", 256)
    monkeypatch.setattr(par, "PARALLEL_MIN_NODES", 256)
    jhg = large_row_net(2000, seed=2)
    a = j_pwr(jhg, 4, 0.1, multilevel=True, workers=2, seed=0,
              frontier="numpy")
    b = partition_with_replication(port(jhg), 4, 0.1, multilevel=True,
                                   workers=2, seed=0, frontier="numpy")
    for x, y in zip(a, b):
        assert np.array_equal(x.masks, y.masks) and x.cost == y.cost
    assert b[1].cost <= b[0].cost


def test_dag_pickle_drops_lazy_caches():
    d = port_dag(large_sptrsv_dag(300, seed=1))
    d.topo_order()
    d2 = pickle.loads(pickle.dumps(d))
    assert d2._csr is None and d2._topo is None
    assert np.array_equal(d2.edge_src, d.edge_src)
    assert d2.topo_order() == d.topo_order()


def _pair_fixture(n=6000, seed=3):
    jd = large_sptrsv_dag(n, seed=seed)
    dag = port_dag(jd)
    level = np.asarray(dag_levels(dag), dtype=np.int64)
    xch = np.zeros(dag.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dag.edge_src, minlength=dag.n), out=xch[1:])
    return jd, dag, xch, level


def test_sched_pair_parts_shards_bit_identical():
    """Shard blocks of the scheduling V-cycle's pair generator concatenate
    into the serial arrays, which equal the reference's."""
    jd, dag, xch, level = _pair_fixture()
    mu = np.asarray(dag.mu, dtype=np.float64)
    serial = tsml._pair_parts(xch, dag.edge_dst, dag.xpar, dag.par_arr, mu,
                              level, 16, 0, dag.n)
    want = jsml._pair_parts(xch, jd.edge_dst, jd.xpar, jd.par_arr, mu,
                            level, 16, 0, jd.n)
    for k in range(6):
        assert np.array_equal(serial[k], want[k])
    for W in (2, 3, 5):
        bounds = np.linspace(0, dag.n, W + 1).astype(np.int64)
        blocks = [tsml._pair_parts(xch, dag.edge_dst, dag.xpar, dag.par_arr,
                                   mu, level, 16, int(bounds[i]),
                                   int(bounds[i + 1])) for i in range(W)]
        for k in range(6):
            assert np.array_equal(np.concatenate([b[k] for b in blocks]),
                                  serial[k]), (W, k)


@pytest.mark.parametrize("method", METHODS)
def test_pooled_same_level_matching_bit_identical(shm, method):
    method_or_skip(method)
    jd, dag, _, level = _pair_fixture()
    cap = float(dag.omega.sum())
    cm_s, nc_s = tsml.same_level_matching(dag, level, cap,
                                          np.random.default_rng(5))
    cm_j, nc_j = jsml.same_level_matching(jd, level, cap,
                                          np.random.default_rng(5))
    with ParallelContext(2, start_method=method, min_nodes=64) as ctx:
        cm_p, nc_p = tsml.same_level_matching(dag, level, cap,
                                              np.random.default_rng(5),
                                              ctx=ctx)
        assert not ctx.failed
    assert nc_p == nc_s == nc_j
    assert cm_p.tobytes() == cm_s.tobytes() == cm_j.tobytes()


def test_multilevel_schedule_workers_bit_identical(shm):
    """``multilevel_schedule(workers=2)`` equals the serial V-cycle."""
    dag = port_dag(large_sptrsv_dag(5000, seed=1))
    inst = BspInstance(dag, 4, 2.0, 10.0)
    opts = MultilevelScheduleOptions(coarsest_n=512)
    s1 = multilevel_schedule(inst, opts=opts, seed=0, backend="numpy")
    s2 = multilevel_schedule(inst, opts=opts, seed=0, workers=2,
                             backend="numpy")
    assert s1.current_cost() == s2.current_cost()
    assert s1.assign == s2.assign and s1.comms == s2.comms

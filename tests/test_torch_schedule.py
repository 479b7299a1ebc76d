"""The scheduling side: the port's ``Dag``, DAG generators, BSP engine,
list scheduling, hill climbing, replication heuristics, schedule V-cycle
and exact search, against the JAX package's on the same instances.

Every instance here has integer weights, so the two packages make the
same decisions and the schedules are equal, not close: cost, comm plan
and assignment rows.  The port's torch window pricers run on
``device="cpu"`` where a pass takes a backend.  The reference's known
float-weight engine fault is pinned as it is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core import schedule as js  # noqa: E402
from repro.core.hypergraph import Dag as JDag  # noqa: E402
from repro.core.schedule import reference as jref  # noqa: E402
from repro.datagen import dags as jdags  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import schedule as ts  # noqa: E402
from repro_torch.core.hypergraph import Dag  # noqa: E402
from repro_torch.core.schedule import reference as tref  # noqa: E402
from repro_torch.datagen import dags as tdags  # noqa: E402
from repro_torch.kernels import front_pass  # noqa: E402

GENERATORS = [
    ("spmv_dag", dict(n_rows=60, seed=1)),
    ("iterated_matmul_dag", dict(n=20, iters=4, seed=2)),
    ("cg_dag", dict(n=16, iters=4, seed=3)),
    ("knn_dag", dict(n=30, k=4, iters=3, seed=4)),
    ("sptrsv_dag", dict(n=800, band=32, seed=5)),
    ("psdd_dag", dict(n_leaves=200, depth=14, seed=6)),
    ("large_sptrsv_dag", dict(n=4000, band=48, seed=7)),
    ("large_psdd_dag", dict(n_leaves=1000, depth=16, seed=8)),
]
DATASETS = ["tiny_dataset", "sptrsv_dataset", "psdd_dataset", "hdb_dataset"]


def same_dag(a, b):
    assert (a.n, a.name) == (b.n, b.name)
    assert np.array_equal(a.edge_src, b.edge_src)
    assert np.array_equal(a.edge_dst, b.edge_dst)
    assert np.array_equal(a.omega, b.omega)
    assert np.array_equal(a.mu, b.mu)
    assert a.topo_order() == b.topo_order()


def snap(s):
    return (s.current_cost(), sorted(s.comms.items()),
            [sorted(a.items()) for a in s.assign])


def pair(jd, P=4, g=4.0, L=20.0):
    """One instance in both packages."""
    td = convert.dag_from_arrays(jd.n, jd.edge_src, jd.edge_dst, jd.omega,
                                 jd.mu, name=jd.name)
    return (js.BspInstance(jd, P=P, g=g, L=L),
            ts.BspInstance(td, P=P, g=g, L=L))


def cases():
    """The shipped dataset cases of the reference's schedule tests."""
    out = [("tiny", i) for i in range(8)]
    out += [("sptrsv", i) for i in range(5)]
    out += [("psdd", i) for i in range(5)]
    return out


def dataset_dag(kind, i):
    return getattr(jdags, f"{kind}_dataset")()[i]


# ------------------------------------------------------------------ datagen
@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generators_match_reference(name, kw):
    same_dag(getattr(jdags, name)(**kw), getattr(tdags, name)(**kw))


@pytest.mark.parametrize("name", DATASETS)
def test_datasets_match_reference(name):
    want, got = getattr(jdags, name)(), getattr(tdags, name)()
    assert len(want) == len(got)
    for a, b in zip(want, got):
        same_dag(a, b)


def test_dag_constructors_and_contract_match_reference():
    jd = jdags.sptrsv_dag(n=300, band=16, seed=1)
    d = Dag(n=jd.n, edge_list=list(jd.edge_list), omega=jd.omega, mu=jd.mu,
            name=jd.name)
    same_dag(jd, d)
    level = np.asarray(js.list_sched.dag_levels(jd), dtype=np.int64)
    cmap = np.searchsorted(np.unique(level), level)   # one node per level
    same_dag(jd.contract(cmap), d.contract(cmap))
    with pytest.raises(ValueError):
        d.contract(np.array([0, 1] * (d.n // 2) + [0] * (d.n % 2)))


def test_dag_from_arrays_rejects_bad_input():
    with pytest.raises(ValueError, match="range"):
        convert.dag_from_arrays(3, [0, 1], [1, 3], np.ones(3), np.ones(3))
    with pytest.raises(ValueError, match="cycle"):
        convert.dag_from_arrays(3, [0, 1, 2], [1, 2, 0], np.ones(3),
                                np.ones(3))
    with pytest.raises(ValueError, match="omega"):
        convert.dag_from_arrays(3, [0], [1], np.ones(2), np.ones(3))


# ---------------------------------------------------- list scheduling + HC
@pytest.mark.parametrize("kind,i", cases())
def test_bspg_and_hill_climb_match_reference(kind, i):
    ji, ti = pair(dataset_dag(kind, i))
    a, b = js.bspg_schedule(ji, seed=0), ts.bspg_schedule(ti, seed=0)
    assert snap(a) == snap(b)
    c = b.copy()
    js.hill_climb(a, seed=0)
    ts.hill_climb(b, seed=0, backend="numpy")
    ts.hill_climb(c, seed=0, backend="torch", device="cpu")
    assert snap(a) == snap(b) == snap(c)
    assert b.validate() == []


# ------------------------------------------------------ replication moves
@pytest.mark.parametrize("kind,i", cases())
def test_replication_heuristics_match_reference(kind, i):
    """``basic_heuristic`` and ``advanced_heuristic`` from the hill-climbed
    list schedule, and ``best_replicated_schedule``."""
    ji, ti = pair(dataset_dag(kind, i))
    a = js.hill_climb(js.bspg_schedule(ji, seed=0), seed=0)
    b = ts.hill_climb(ts.bspg_schedule(ti, seed=0), seed=0, backend="numpy")
    assert snap(js.basic_heuristic(a.copy())) == snap(
        ts.basic_heuristic(b.copy()))
    assert snap(js.advanced_heuristic(a)) == snap(ts.advanced_heuristic(b))
    want = js.best_replicated_schedule(ji, seed=0)
    got = ts.best_replicated_schedule(ti, seed=0, backend="torch",
                                      device="cpu")
    assert snap(want) == snap(got)
    assert got.validate() == []


def test_advanced_options_match_reference():
    """Each move family alone, and the first-improvement comparators."""
    ji, ti = pair(dataset_dag("sptrsv", 1), P=8)
    base_j = js.hill_climb(js.bspg_schedule(ji, seed=0), seed=0)
    base_t = ts.hill_climb(ts.bspg_schedule(ti, seed=0), seed=0,
                           backend="numpy")
    for kw in (dict(batch_replication=False), dict(superstep_merging=False),
               dict(superstep_replication=False), dict(use_fronts=False),
               dict(superstep_splitting=True)):
        a = js.advanced_heuristic(base_j.copy(), js.AdvancedOptions(**kw))
        b = ts.advanced_heuristic(base_t.copy(), ts.AdvancedOptions(**kw))
        assert snap(a) == snap(b), kw


def test_reference_oracle_matches_engine():
    """The port's copy-per-trial oracle reaches the engine's final costs,
    as the reference's does."""
    ji, ti = pair(dataset_dag("sptrsv", 0), P=8)
    t_hc = ts.hill_climb(ts.bspg_schedule(ti, seed=0), seed=0,
                         backend="numpy")
    o_hc = tref.hill_climb(tref.bspg_schedule(ti, seed=0), seed=0)
    j_hc = jref.hill_climb(jref.bspg_schedule(ji, seed=0), seed=0)
    assert t_hc.current_cost() == o_hc.current_cost() == j_hc.current_cost()
    t_adv = ts.advanced_heuristic(t_hc.copy())
    o_adv = tref.advanced_heuristic(o_hc.copy())
    assert t_adv.current_cost() == o_adv.current_cost()


# ------------------------------------------------------------ the V-cycle
@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("make,kw", [
    ("sptrsv_dag", dict(n=2000, band=32, seed=0)),
    ("psdd_dag", dict(n_leaves=500, depth=12, seed=1)),
])
def test_multilevel_schedule_matches_reference(backend, make, kw):
    """A real V-cycle (n above ``coarsest_n``): the schedule and every
    level's cost row equal the reference's."""
    ji, ti = pair(getattr(jdags, make)(**kw), P=8)
    sj, st = [], []
    want = js.multilevel_schedule(ji, seed=0, stats=sj)
    dev = {} if backend == "numpy" else {"device": "cpu"}
    saved = front_pass.DEVICE_MIN_STEPS
    front_pass.DEVICE_MIN_STEPS = 1
    try:
        got = ts.multilevel_schedule(ti, seed=0, stats=st, backend=backend,
                                     **dev)
    finally:
        front_pass.DEVICE_MIN_STEPS = saved
    assert len(sj) >= 2 and st == sj
    assert snap(want) == snap(got)
    assert got.validate() == []


def test_multilevel_fallthrough_matches_flat():
    ji, ti = pair(jdags.sptrsv_dag(n=900, band=24, seed=0))
    flat = ts.best_replicated_schedule(ti, seed=0, backend="numpy")
    mlv = ts.best_replicated_schedule(ti, seed=0, multilevel=True,
                                      backend="numpy")
    want = js.best_replicated_schedule(ji, seed=0, multilevel=True)
    assert snap(flat) == snap(mlv) == snap(want)


# ------------------------------------------------------------ exact search
@pytest.mark.parametrize("edges,P,g,L", [
    ([(0, 3), (1, 3), (1, 4), (2, 4), (3, 5), (4, 6), (5, 7), (6, 7),
      (3, 8), (4, 9)], 2, 4.0, 5.0),
    ([(k, k + 1) for k in range(5)], 2, 2.0, 1.0),
])
def test_exact_schedule_matches_reference(edges, P, g, L):
    """The exact search on the reference's exact-test DAGs: the same
    optimum, the same schedule, the same search."""
    n = 1 + max(max(e) for e in edges)
    ji, ti = pair(JDag(n=n, edge_list=edges), P=P, g=g, L=L)
    a = js.exact_schedule(ji, max_supersteps=3, time_limit=30)
    b = ts.exact_schedule(ti, max_supersteps=3, time_limit=30)
    assert b.assignments_optimal and a.assignments_optimal
    assert a.cost == b.cost and a.explored == b.explored
    assert snap(a.schedule) == snap(b.schedule)


# ------------------------------------------------- the reference's fault
def _drift_case(dag_cls, inst_cls, sched_cls):
    """``tests/test_schedule_engine.py``'s property example seed=7781,
    weighted=True, replayed with one package's classes."""
    seed = 7781
    rng = np.random.default_rng(seed)
    n = int(rng.integers(12, 40))
    r2 = np.random.default_rng(seed)
    edges = []
    for v in range(8, n):
        for u in r2.choice(v, size=min(3, v), replace=False):
            if r2.random() < 0.5:
                edges.append((int(u), v))
    omega = r2.uniform(0.5, 4.0, size=n)
    mu = r2.uniform(0.5, 3.0, size=n)
    inst = inst_cls(dag_cls(n=n, edge_list=edges, omega=omega, mu=mu),
                    P=int(rng.integers(2, 6)), g=float(rng.integers(1, 6)),
                    L=float(rng.integers(0, 25)))
    S = 6
    sched = sched_cls(inst, S)
    for v in range(n):
        sched.add_comp(v, int(rng.integers(inst.P)), int(rng.integers(S)))
    for _ in range(n // 2):
        v = int(rng.integers(n))
        src = next(iter(sched.assign[v]))
        dst = int(rng.integers(inst.P))
        if dst != src and (v, dst) not in sched.comms:
            sched.add_comm(v, src, dst, int(rng.integers(S)))
    for _ in range(40):
        _random_op(sched, rng)
    return sched


def _random_op(sched, rng):
    P, S = sched.inst.P, sched.S
    for _ in range(20):
        kind = int(rng.integers(5))
        v = int(rng.integers(sched.inst.dag.n))
        if kind == 0:
            free = [p for p in range(P) if p not in sched.assign[v]]
            if not free:
                continue
            p, s = int(rng.choice(free)), int(rng.integers(S))
            sched.add_comp(v, p, s)
            return
        if kind == 1 and len(sched.assign[v]) > 1:
            sched.remove_comp(v, int(rng.choice(list(sched.assign[v]))))
            return
        if kind == 2:
            if not sched.assign[v]:
                continue
            src = int(rng.choice(list(sched.assign[v])))
            dst = int(rng.integers(P))
            if dst == src or (v, dst) in sched.comms:
                continue
            sched.add_comm(v, src, dst, int(rng.integers(S)))
            return
        if kind == 3 and sched.comms:
            keys = sorted(sched.comms.keys())
            v, dst = keys[int(rng.integers(len(keys)))]
            sched.remove_comm(v, dst)
            return
        if kind == 4 and sched.comms:
            keys = sorted(sched.comms.keys())
            v, dst = keys[int(rng.integers(len(keys)))]
            sched.move_comm(v, dst, int(rng.integers(S)))
            return


def test_float_weight_fault_is_copied_faithfully():
    """The reference engine's top-2 maxima drift under float weights
    (ROADMAP, faults in the reference, a).  The port keeps the copy as it
    is: the same mutations raise the same error in both packages."""
    a = _drift_case(JDag, js.BspInstance, js.Schedule)
    b = _drift_case(Dag, ts.BspInstance, ts.Schedule)
    with pytest.raises(AssertionError, match="top2 drifted") as ea:
        a.check()
    with pytest.raises(AssertionError, match="top2 drifted") as eb:
        b.check()
    assert str(ea.value) == str(eb.value)


# -------------------------------------------------------------- devices
def test_schedule_entries_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ti = pair(jdags.sptrsv_dag(n=600, band=24, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.best_replicated_schedule(ti, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.multilevel_schedule(ti, seed=0)
    got = ts.best_replicated_schedule(ti, seed=0, device="cpu")
    assert snap(got) == snap(ts.best_replicated_schedule(ti, seed=0,
                                                         backend="numpy"))

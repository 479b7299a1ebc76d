"""The schedule side's device window pricers (``DeviceScheduleWindows``):
the port's torch programs, run here on CPU tensors, against the JAX
package's jitted programs (``backend="jax"`` on the CPU) and the numpy
fronts.

Each pricer must return the same float64 deltas, and whole passes --
``rebalance_comms``, ``comp_rebalance_pass``, ``node_move_pass`` and
``hill_climb`` -- must leave bit-identical schedules, on integer weights
(the device contract).  The floors are lowered so that small DAGs reach
the device programs.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core.frontier import schedule_front as jsf  # noqa: E402
from repro.core.hypergraph import Dag as JDag  # noqa: E402
from repro.core.schedule import BspInstance as JInst  # noqa: E402
from repro.core.schedule import bspg_schedule as j_bspg  # noqa: E402
from repro.core.schedule import list_sched as jls  # noqa: E402
from repro.datagen import tiny_dataset  # noqa: E402
from repro.kernels import front_pass as jfp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.frontier import device_windows  # noqa: E402
from repro_torch.core.frontier import schedule_front as tsf  # noqa: E402
from repro_torch.core.schedule import BspInstance, bspg_schedule  # noqa: E402
from repro_torch.core.schedule import list_sched as tls  # noqa: E402
from repro_torch.kernels import front_pass  # noqa: E402


def dags(n, seed, fanin=3, p_edge=0.5, n_src=8, weighted=False):
    """One random DAG as the JAX package's ``Dag`` and the port's."""
    rng = np.random.default_rng(seed)
    edges = []
    for v in range(n_src, n):
        for u in rng.choice(v, size=min(fanin, v), replace=False):
            if rng.random() < p_edge:
                edges.append((int(u), v))
    if weighted:
        omega, mu = rng.uniform(0.5, 4.0, size=n), rng.uniform(0.5, 3.0,
                                                               size=n)
    else:
        omega = rng.integers(1, 5, size=n).astype(float)
        mu = rng.integers(1, 4, size=n).astype(float)
    jd = JDag(n=n, edge_list=edges, omega=omega, mu=mu)
    return jd, port_dag(jd)


def port_dag(jd):
    return convert.dag_from_arrays(jd.n, jd.edge_src, jd.edge_dst, jd.omega,
                                   jd.mu, name=jd.name)


@contextlib.contextmanager
def small_floors():
    """Drop the node-move floor on both packages (and the JAX package's
    window floor) so small DAGs take the device programs."""
    saved = (jfp.DEVICE_MIN_WINDOW, jfp.DEVICE_MIN_STEPS,
             front_pass.DEVICE_MIN_STEPS)
    jfp.DEVICE_MIN_WINDOW = jfp.DEVICE_MIN_STEPS = 1
    front_pass.DEVICE_MIN_STEPS = 1
    try:
        yield
    finally:
        (jfp.DEVICE_MIN_WINDOW, jfp.DEVICE_MIN_STEPS,
         front_pass.DEVICE_MIN_STEPS) = saved


def snap(s):
    """Full observable schedule state: cost, comm plan, assignment rows."""
    return (s.current_cost(), sorted(s.comms.items()),
            [sorted(a.items()) for a in s.assign])


def schedules(jd, td, P, seed, g=2.0, L=4.0):
    """The same list schedule in both packages (equal by construction)."""
    sj = j_bspg(JInst(dag=jd, P=P, g=g, L=L), seed=seed)
    st = bspg_schedule(BspInstance(dag=td, P=P, g=g, L=L), seed=seed)
    assert snap(sj) == snap(st)
    return sj, st


@pytest.mark.parametrize("seed", range(4))
def test_pricers_equal_reference_and_numpy(seed):
    """Every comm window, compute window and node move of a schedule,
    priced by the port's programs, equals the JAX package's programs and
    the numpy fronts, delta for delta."""
    rng = np.random.default_rng(seed)
    n, P = int(rng.integers(40, 110)), int(rng.integers(2, 6))
    jd, td = dags(n, seed)
    sj, st = schedules(jd, td, P, seed)
    with small_floors():
        wj = jsf.device_windows(sj, "jax")
        wt = device_windows(st, "torch", "cpu")
        assert wj is not None and wt is not None
        n_comm = n_comp = n_node = 0
        for (v, dst) in sorted(st.comms):
            lo, hi = tls._comm_window(st, v, dst)
            if hi < lo:
                continue
            ts = np.arange(lo, hi + 1)
            got = wt.price_comm_moves(v, dst, ts)
            assert np.array_equal(got, wj.price_comm_moves(v, dst, ts))
            assert np.array_equal(got, tsf.price_comm_moves(st, v, dst, ts))
            n_comm += 1
        for v in range(n):
            if len(st.assign[v]) != 1:
                continue
            (p, _), = st.assign[v].items()
            if (v, p) in st.comms:
                continue
            lo, hi = tls._comp_window(st, v, p)
            if hi >= lo:
                ts = np.arange(lo, hi + 1)
                got = wt.price_comp_moves(v, p, ts)
                assert np.array_equal(got, wj.price_comp_moves(v, p, ts))
                assert np.array_equal(got,
                                      tsf.price_comp_moves(st, v, p, ts))
                n_comp += 1
            got = wt.price_node_moves(v)
            assert np.array_equal(got, wj.price_node_moves(v))
            assert np.array_equal(got, tsf.price_node_moves(st, v))
            n_node += 1
    assert n_comm and n_comp and n_node
    assert wt.launches == {"comm": n_comm, "comp": n_comp, "node": n_node}
    assert wt.syncs == wj.syncs == n_comm + n_comp + n_node
    assert wt.refreshes == 1          # nothing committed: one upload


@pytest.mark.parametrize("seed", range(4))
def test_hill_climb_bit_identical(seed):
    """A whole ``hill_climb`` through the port's device windows leaves the
    schedule the JAX package's device windows and the numpy fronts leave."""
    rng = np.random.default_rng(seed)
    n, P = int(rng.integers(40, 110)), int(rng.integers(2, 6))
    jd, td = dags(n, seed)
    sj, st = schedules(jd, td, P, seed)
    sn = st.copy()
    made = []
    real = front_pass.DeviceScheduleWindows

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    front_pass.DeviceScheduleWindows = Spy
    try:
        with small_floors():
            jls.hill_climb(sj, seed=seed, backend="jax")
            tls.hill_climb(st, seed=seed, backend="torch", device="cpu")
    finally:
        front_pass.DeviceScheduleWindows = real
    tls.hill_climb(sn, seed=seed, backend="numpy")
    assert snap(st) == snap(sj) == snap(sn)
    syncs = sum(w.syncs for w in made)
    assert syncs == sum(sum(w.launches.values()) for w in made)
    assert all(w.refreshes <= max(w.syncs, 1) for w in made)


@pytest.mark.parametrize("which", ["rebalance_comms", "node_move_pass",
                                   "comp_rebalance_pass"])
def test_single_passes_bit_identical(which):
    jd, td = dags(80, 5)
    sj, st = schedules(jd, td, 4, 5)
    sn = st.copy()
    with small_floors():
        getattr(jls, which)(sj, backend="jax")
        getattr(tls, which)(st, backend="torch", device="cpu")
    getattr(tls, which)(sn, backend="numpy")
    assert snap(st) == snap(sj) == snap(sn)


def test_shipped_tiny_dag_bit_identical():
    jd = tiny_dataset()[0]
    td = port_dag(jd)
    sj, st = schedules(jd, td, 4, 0)
    with small_floors():
        jls.hill_climb(sj, seed=0, backend="jax")
        tls.hill_climb(st, seed=0, backend="torch", device="cpu")
    assert snap(st) == snap(sj)


def test_float_weights_fall_back():
    """Float-weight DAGs never attach; the torch backend then prices on
    the host and takes the numpy path's decisions."""
    _, td = dags(60, 3, weighted=True)
    inst = BspInstance(dag=td, P=4, g=2.0, L=4.0)
    sa, sb = bspg_schedule(inst, seed=0), bspg_schedule(inst, seed=0)
    assert device_windows(sa, "torch", "cpu") is None
    assert device_windows(sa, "numpy", "cpu") is None
    with small_floors():
        tls.hill_climb(sa, seed=0, backend="torch", device="cpu")
    tls.hill_climb(sb, seed=0, backend="numpy")
    assert snap(sa) == snap(sb)


def test_non_integer_bsp_parameters_fall_back():
    _, td = dags(40, 1)
    s = bspg_schedule(BspInstance(dag=td, P=3, g=2.5, L=4.0), seed=0)
    assert device_windows(s, "torch", "cpu") is None


def test_defaults_raise_without_cuda(monkeypatch):
    """The default backend is torch on ``device="cuda"``: without a CUDA
    device the schedule passes raise, and the host path and an explicit
    CPU device stay available."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, td = dags(40, 2)
    inst = BspInstance(dag=td, P=3, g=2.0, L=4.0)
    s = bspg_schedule(inst, seed=0)
    for fn in (tls.hill_climb, tls.rebalance_comms, tls.comp_rebalance_pass,
               tls.node_move_pass):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(s.copy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tls.baseline_schedule(inst)
    a = tls.hill_climb(s.copy(), backend="numpy")
    b = tls.hill_climb(s.copy(), device="cpu")
    assert snap(a) == snap(b)

"""The partition V-cycle (``core/partition/multilevel.py``): the port
against the JAX package on the same instances.

The reference runs ``frontier="numpy"``.  The port runs ``"numpy"`` and
``"torch"`` on ``device="cpu"``, with the floors lowered so that the
finer levels of these small instances take the device-resident pass and
the coarser ones price their large fronts with ``min_cover_lambdas``, as
the large instances do on the card.  Masks, costs and the per-level cost
rows must be equal.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core.hypergraph import Hypergraph as JHypergraph  # noqa: E402
from repro.core.partition import multilevel as jml  # noqa: E402
from repro.core.partition.heuristic import (  # noqa: E402
    partition_with_replication as j_pwr)
from repro.datagen import large_row_net, spmv_dataset  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.frontier import partition_front as tpf  # noqa: E402
from repro_torch.core.partition import multilevel as tml  # noqa: E402
from repro_torch.core.partition.cost import is_valid  # noqa: E402
from repro_torch.core.partition.heuristic import (  # noqa: E402
    partition_with_replication as t_pwr)
from repro_torch.kernels import front_pass, gain  # noqa: E402


def port(hg):
    return convert.hypergraph_from_arrays(hg.n, hg.xpins, hg.pins, hg.omega,
                                          hg.mu, name=hg.name)


class Spy:
    """Lowers the port's device floors and records the device passes the
    run attaches (with their level's node count) and the row counts of
    the fronts ``min_cover_lambdas`` prices."""

    def __init__(self, nodes: int = 512, rows: int = 256) -> None:
        self.nodes, self.rows = nodes, rows
        self.passes: list = []
        self.fronts: list = []

    @contextlib.contextmanager
    def on(self):
        saved = (front_pass.DEVICE_MIN_NODES, tpf._DEVICE_MIN_ROWS,
                 front_pass.attach, gain.min_cover_lambdas)
        real_attach, real_lam = front_pass.attach, gain.min_cover_lambdas

        def attach(*a, **kw):
            dev = real_attach(*a, **kw)
            if dev is not None:
                self.passes.append(dev)
            return dev

        def lam(rows, *a, **kw):
            self.fronts.append(rows.shape[0])
            return real_lam(rows, *a, **kw)

        front_pass.DEVICE_MIN_NODES, tpf._DEVICE_MIN_ROWS = (self.nodes,
                                                             self.rows)
        front_pass.attach, gain.min_cover_lambdas = attach, lam
        try:
            yield self
        finally:
            (front_pass.DEVICE_MIN_NODES, tpf._DEVICE_MIN_ROWS,
             front_pass.attach, gain.min_cover_lambdas) = saved

    def check(self) -> None:
        """Passes attached at the finer levels and were released; fronts
        reached the min-cover reduction; the counter bounds held."""
        assert self.passes and self.fronts
        assert min(d.n for d in self.passes) >= self.nodes
        for d in self.passes:
            assert d.state.device is None          # released after its stop
            assert d.commits <= d.finds <= d.commits + d.pass_scans
            assert d.syncs >= d.finds and d.apply_dispatches == 0


def run_port(fn, frontier, *a, **kw):
    if frontier == "numpy":
        return fn(*a, frontier="numpy", **kw), None
    spy = Spy()
    with spy.on():
        out = fn(*a, frontier="torch", device="cpu", **kw)
    return out, spy


CASES = [(1536, 4, 0.1), (2048, 4, 0.05)]


@pytest.mark.parametrize("frontier", ["numpy", "torch"])
@pytest.mark.parametrize("n,P,eps", CASES)
def test_replicated_vcycle_matches_reference(n, P, eps, frontier):
    """``partition_with_replication(multilevel=True)``: base and
    replicated masks and costs equal to the reference's."""
    hg = large_row_net(n, seed=1)
    want = j_pwr(hg, P, eps, seed=0, multilevel=True, frontier="numpy")
    got, spy = run_port(t_pwr, frontier, port(hg), P, eps, seed=0,
                        multilevel=True)
    for a, b in zip(want, got):
        assert np.array_equal(a.masks, b.masks) and a.cost == b.cost
    assert got[1].cost < got[0].cost
    assert is_valid(port(hg), got[1].masks, P, eps)
    if spy is not None:
        spy.check()


@pytest.mark.parametrize("frontier", ["numpy", "torch"])
def test_vcycle_levels_match_reference(frontier):
    """``multilevel_partition``: masks, cost and every level's projected
    and refined cost equal to the reference's."""
    hg = large_row_net(2048, seed=3)
    sj, st = [], []
    want = jml.multilevel_partition(hg, 4, 0.1, seed=0, stats=sj,
                                    frontier="numpy")
    got, spy = run_port(tml.multilevel_partition, frontier, port(hg), 4, 0.1,
                        seed=0, stats=st)
    assert len(sj) >= 2 and st == sj
    assert np.array_equal(want.masks, got.masks) and want.cost == got.cost
    for row in st:
        assert row["cost_refined"] <= row["cost_projected"] + 1e-9
    if spy is not None:
        spy.check()


def test_shipped_spmv_datasets_match_reference():
    """The datasets sit below the coarsest level: the V-cycle is the flat
    heuristic there, in both packages."""
    for hg in spmv_dataset("rn", count=2, seed=0):
        a = jml.multilevel_partition(hg, 4, 0.1, seed=0, frontier="numpy")
        b = tml.multilevel_partition(port(hg), 4, 0.1, seed=0,
                                     device="cpu")
        assert np.array_equal(a.masks, b.masks) and a.cost == b.cost


def test_dup_mode_matches_reference():
    hg = large_row_net(1536, seed=4)
    _, a = jml.partition_with_replication_multilevel(hg, 4, 0.1, mode="dup",
                                                     seed=0,
                                                     frontier="numpy")
    _, b = tml.partition_with_replication_multilevel(port(hg), 4, 0.1,
                                                     mode="dup", seed=0,
                                                     frontier="numpy")
    assert np.array_equal(a.masks, b.masks) and a.cost == b.cost
    assert is_valid(port(hg), b.masks, 4, 0.1, max_replicas=2)


def test_immediate_stagnation_matches_reference():
    """Every edge above the scoring cap: no coarse level, both drivers
    fall through to the flat path."""
    rng = np.random.default_rng(0)
    n = 480
    edges = [tuple(rng.choice(n, size=30, replace=False)) for _ in range(90)]
    hg = JHypergraph(n=n, edges=edges)
    a = jml.multilevel_partition(hg, 4, 0.05, seed=0, frontier="numpy")
    b = tml.multilevel_partition(port(hg), 4, 0.05, seed=0,
                                 frontier="numpy")
    assert np.array_equal(a.masks, b.masks) and a.cost == b.cost
    ja = jml.partition_with_replication_multilevel(hg, 4, 0.05, seed=0,
                                                   frontier="numpy")
    tb = tml.partition_with_replication_multilevel(port(hg), 4, 0.05,
                                                   seed=0, frontier="numpy")
    for x, y in zip(ja, tb):
        assert np.array_equal(x.masks, y.masks) and x.cost == y.cost


def test_exact_small_instance_path_precedes_vcycle():
    hg = JHypergraph(n=10, edges=[(0, 1, 2), (3, 4), (5, 6, 7), (8, 9),
                                  (1, 5)])
    a = j_pwr(hg, 2, 0.3, seed=0, multilevel=True)
    b = t_pwr(port(hg), 2, 0.3, seed=0, multilevel=True, device="cpu")
    assert [r.cost for r in a] == [r.cost for r in b]


def test_heavy_pin_matching_matches_reference():
    hg = large_row_net(1200, seed=1)
    a = jml.heavy_pin_matching(hg, 50.0, np.random.default_rng(7))
    b = tml.heavy_pin_matching(port(hg), 50.0, np.random.default_rng(7))
    assert a[1] == b[1] and np.array_equal(a[0], b[0])


def test_vcycle_defaults_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hg = port(large_row_net(600, seed=1))
    for call in (lambda: tml.multilevel_partition(hg, 4, 0.1),
                 lambda: tml.partition_with_replication_multilevel(hg, 4,
                                                                   0.1),
                 lambda: t_pwr(hg, 4, 0.1, multilevel=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

"""``partition_with_replication`` end to end: the port against the JAX
package on the same numpy instances.

The reference runs ``frontier="jax"``, the port ``frontier="torch"`` on
``device="cpu"``; base and replicated results must be equal, masks and
cost.  Floors are lowered so that the small instances here take the same
paths the large ones take on the card: the device-resident pass for
integer weights, the per-front ``min_cover_lambdas`` for float weights.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs tiny ops here: extra threads per pytest worker only contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro.core.frontier import partition_front as jpf  # noqa: E402
from repro.core.hypergraph import Hypergraph  # noqa: E402
from repro.core.partition import heuristic as jh  # noqa: E402
from repro.datagen import large_row_net, moe_dataset  # noqa: E402
from repro.kernels import front_pass as jfp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.frontier import partition_front as tpf  # noqa: E402
from repro_torch.core.partition import heuristic as th  # noqa: E402
from repro_torch.datagen import large_row_net as t_large_row_net  # noqa: E402
from repro_torch.datagen import moe_dataset as t_moe_dataset  # noqa: E402
from repro_torch.kernels import front_pass, gain  # noqa: E402


def port(hg):
    return convert.hypergraph_from_arrays(hg.n, hg.xpins, hg.pins, hg.omega,
                                          hg.mu, name=hg.name)


@contextlib.contextmanager
def floors(nodes=1, rows=None):
    """Lower the device-pass node floor and, with ``rows``, the per-front
    row floor, on both packages."""
    saved = (jfp.DEVICE_MIN_NODES, front_pass.DEVICE_MIN_NODES,
             jpf._JAX_MIN_ROWS, tpf._DEVICE_MIN_ROWS)
    jfp.DEVICE_MIN_NODES = front_pass.DEVICE_MIN_NODES = nodes
    if rows is not None:
        jpf._JAX_MIN_ROWS = tpf._DEVICE_MIN_ROWS = rows
    try:
        yield
    finally:
        (jfp.DEVICE_MIN_NODES, front_pass.DEVICE_MIN_NODES,
         jpf._JAX_MIN_ROWS, tpf._DEVICE_MIN_ROWS) = saved


def assert_same(a, b):
    for ra, rb in zip(a, b):
        assert np.array_equal(ra.masks, rb.masks)
        assert ra.cost == rb.cost


@pytest.mark.parametrize("P", [4, 8])
def test_large_row_net_device_pass_matches_reference(P):
    hg = large_row_net(1024, seed=1024)
    with floors():
        a = jh.partition_with_replication(hg, P, 0.05, frontier="jax")
        b = th.partition_with_replication(port(hg), P, 0.05,
                                          frontier="torch", device="cpu")
    assert_same(a, b)
    assert b[1].cost < b[0].cost          # replication paid off


def test_moe_per_front_path_matches_reference():
    """Float mu: the device pass declines, the fronts go through
    ``min_cover_lambdas`` (floor lowered to reach it at this size)."""
    hg = moe_dataset("moe8", n_layers=1, kappa0=1500, n_experts=48)[0]
    assert not np.all(hg.mu == np.rint(hg.mu))
    calls = []
    real = gain.min_cover_lambdas

    def spy(rows, *a, **kw):
        calls.append(rows.shape[0])
        return real(rows, *a, **kw)

    gain.min_cover_lambdas = spy
    try:
        with floors(rows=256):
            a = jh.partition_with_replication(hg, 8, 0.05, frontier="jax")
            b = th.partition_with_replication(port(hg), 8, 0.05,
                                              frontier="torch", device="cpu")
    finally:
        gain.min_cover_lambdas = real
    assert calls and max(calls) >= 256
    assert_same(a, b)


def test_port_datagen_matches_reference():
    """The port's copies of the generators build the same instances."""
    for a, b in ((large_row_net(512, seed=3), t_large_row_net(512, seed=3)),
                 (moe_dataset("moe8", n_layers=1, kappa0=300,
                              n_experts=32)[0],
                  t_moe_dataset("moe8", n_layers=1, kappa0=300,
                                n_experts=32)[0])):
        assert a.n == b.n
        assert np.array_equal(a.xpins, b.xpins)
        assert np.array_equal(a.pins, b.pins)
        assert np.array_equal(a.omega, b.omega)
        assert np.array_equal(a.mu, b.mu)


def test_exact_branch_matches_reference():
    """n <= 24: both packages solve exactly, with and without replication."""
    rng = np.random.default_rng(5)
    n = 10
    edges = [tuple(rng.choice(n, size=int(rng.integers(2, 4)),
                              replace=False)) for _ in range(14)]
    hg = Hypergraph(n=n, edges=edges, mu=rng.integers(1, 4, size=14))
    a = jh.partition_with_replication(hg, 3, 0.2, frontier="jax")
    b = th.partition_with_replication(port(hg), 3, 0.2, device="cpu")
    assert_same(a, b)


def test_beyond_engine_tables_matches_reference():
    """P > 12: the scalar reference path, in both packages."""
    hg = large_row_net(40, seed=2, dense_len=8)
    a = jh.partition_with_replication(hg, 13, 0.5, frontier="jax")
    b = th.partition_with_replication(port(hg), 13, 0.5, device="cpu")
    assert_same(a, b)


def test_defaults_raise_without_cuda(monkeypatch):
    """With the default frontier and device, a process without a CUDA
    device raises rather than running on the CPU; the host path and an
    explicit CPU device stay available."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hg = port(large_row_net(64, seed=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.partition_with_replication(hg, 4, 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.fm_refine(hg, np.ones(hg.n, dtype=np.int64), 4, 0.1,
                     np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.replicate_local_search(hg, np.ones(hg.n, dtype=np.int64), 4, 0.1)
    base, _ = th.partition_with_replication(hg, 4, 0.1, frontier="numpy")
    base_cpu, _ = th.partition_with_replication(hg, 4, 0.1, device="cpu")
    assert np.array_equal(base.masks, base_cpu.masks)


def test_multilevel_not_ported_yet():
    """``multilevel=True`` no longer raises: the V-cycle is ported
    (``tests/test_torch_multilevel.py``).  At or below its coarsest size
    it is the flat heuristic, so both entry points give the reference's
    results here."""
    hg = large_row_net(64, seed=1)
    a = jh.partition_with_replication(hg, 4, 0.1, multilevel=True,
                                      frontier="numpy")
    b = th.partition_with_replication(port(hg), 4, 0.1, multilevel=True,
                                      device="cpu")
    assert_same(a, b)


@pytest.mark.parametrize("xpins,pins,why", [
    ([0, 2, 5], [0, 1, 2, 3], "CSR"),            # offsets past the pins
    ([0, 2, 4], [0, 1, 3, 9], "range"),          # pin id >= n
    ([0, 2, 4], [1, 0, 2, 3], "sorted"),         # unsorted edge
    ([0, 2, 4], [0, 1, 2, 2], "sorted"),         # repeated pin
])
def test_convert_rejects_malformed_csr(xpins, pins, why):
    with pytest.raises(ValueError, match=why):
        convert.hypergraph_from_arrays(4, xpins, pins, np.ones(4),
                                       np.ones(2))

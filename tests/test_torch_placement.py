"""The port's expert placement (``repro_torch.core.placement``) against the
JAX package's, on the CPU.

Placement is numpy over the partition engine, whose decisions the port
keeps bit for bit (``tests/test_torch_partition.py``), so plans, costs,
local fractions and the online controller's epochs are equal, not close.
The port's partitioner runs its kernels' plain versions here
(``device="cpu"``) or the host path (``frontier="numpy"``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from benchmarks import serving as jserving  # noqa: E402
from repro.core.placement import expert_placement as jep  # noqa: E402
from repro.core.placement import online as jonline  # noqa: E402
from repro.datagen.moe_traces import synthetic_trace  # noqa: E402
from repro_torch.core.placement import (  # noqa: E402
    SMOKE, OnlineController, drift_replay, evaluate_plan,
    plan_expert_placement, plan_masks, plan_to_masks, replay_cost)
from repro_torch.models import moe  # noqa: E402


def _trace(n_experts=32, top_k=4, n=3000, seed=0):
    t = synthetic_trace(n_experts=n_experts, n_tokens=n, top_k=top_k,
                        seed=seed)
    return np.sort(np.asarray(t), axis=1)


@pytest.mark.parametrize("kw", [{"device": "cpu"}, {"frontier": "numpy"}])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_expert_placement_matches_jax(n_shards, kw):
    trace = _trace()
    got = plan_expert_placement(trace, 32, n_shards, kappa0=400, **kw)
    want = jep.plan_expert_placement(trace, 32, n_shards, kappa0=400)
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    assert dataclasses.asdict(got.baseline_plan) == dataclasses.asdict(
        want.baseline_plan)
    for f in ("lambda_cost_no_repl", "lambda_cost_repl",
              "local_fraction_no_repl", "local_fraction_repl"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.lambda_cost_repl <= got.lambda_cost_no_repl


def test_evaluate_plan_and_masks_match_jax():
    trace, held_out = _trace(seed=1), _trace(seed=2)
    res = plan_expert_placement(trace, 32, 4, kappa0=400, device="cpu")
    jres = jep.plan_expert_placement(trace, 32, 4, kappa0=400)
    for plan, jplan in ((res.plan, jres.plan),
                        (res.baseline_plan, jres.baseline_plan)):
        assert evaluate_plan(plan, held_out, kappa0=400) == \
            jep.evaluate_plan(jplan, held_out, kappa0=400)
        masks = plan_masks(plan)
        assert np.array_equal(masks, jep.plan_masks(jplan))
        assert np.array_equal(plan_to_masks(plan), masks)
        assert replay_cost(masks, held_out, 4) == \
            jonline.replay_cost(masks, held_out, 4)
    rr = moe.round_robin_plan(32, 4)
    assert np.array_equal(plan_masks(rr), 1 << (np.arange(32) % 4))


def test_online_controller_epochs_match_jax():
    """The controller's epoch reports on a short drifting stream."""
    from repro.datagen.moe_traces import drifting_trace
    kw = dict(kappa0=200, warmup_epochs=2, bytes_per_expert=3 << 20)
    ctrl = OnlineController(32, 4, 10, device="cpu", **kw)
    jctrl = jonline.OnlineController(32, 4, 10, **kw)
    for chunk in drifting_trace(n_experts=32, tokens_per_epoch=1500,
                                n_epochs=5, top_k=4, drift_rate=2.0,
                                seed=3):
        a, b = ctrl.step(chunk), jctrl.step(chunk)
        for f in ("epoch", "cost_keep", "cost_new", "committed",
                  "migration_bytes", "containment"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.plan is None) == (b.plan is None)
        if a.plan is not None:
            assert dataclasses.asdict(a.plan) == dataclasses.asdict(b.plan)
    assert ctrl.acc.edges == jctrl.acc.edges


@pytest.mark.parametrize("drift,totals,commits", [
    (0.8, (149578.0, 114247.0, 103685.0), 2),
    (0.0, None, 0)])
def test_smoke_drift_replay_matches_jax(drift, totals, commits):
    """The serving benchmark's SMOKE replay through the port's controller
    gives the JAX package's figures exactly; stationary traffic migrates
    nothing."""
    got = drift_replay(**SMOKE, drift_rate=drift, device="cpu")
    want = jserving.drift_replay(**SMOKE, drift_rate=drift)
    names = ("static_round_robin", "static_replicated", "online_replicated")
    costs = tuple(got["policies"][n]["comm_cost"] for n in names)
    assert costs == tuple(want["policies"][n]["comm_cost"] for n in names)
    if totals is not None:
        assert costs == totals
    on, jon = (got["policies"]["online_replicated"],
               want["policies"]["online_replicated"])
    assert on["commits"] == jon["commits"] == commits
    assert on["migration_bytes"] == jon["migration_bytes"]
    if commits == 0:
        assert on["migration_bytes"] == 0
    for a, b in zip(got["per_epoch"], want["per_epoch"]):
        for f in ("round_robin", "static", "online", "committed",
                  "migration_bytes"):
            assert a[f] == b[f], (a["epoch"], f)


def test_placement_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_expert_placement(_trace(), 32, 2, kappa0=400)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlineController(32, 2, 20)

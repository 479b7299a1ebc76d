"""Serving replay: the online replicated placement against static ones
(the JAX package's ``benchmarks/serving.py::drift_replay``).

Synthetic router traffic with a drifting topic mixture
(``datagen.moe_traces.drifting_trace``) goes through three placement
policies, each epoch scored with the exact per-token (lambda_e - 1)
communication cost (``online.replay_cost``):

  * ``static_round_robin``  -- expert e on shard e % P, never replicated;
  * ``static_replicated``   -- the controller's bootstrap plan, then frozen;
  * ``online_replicated``   -- the ``OnlineController``: the same bootstrap
                               plan, then drift-gated re-placement.

``SMOKE`` is the benchmark's small configuration.
"""
from __future__ import annotations

import numpy as np
import torch

from ...datagen.moe_traces import drifting_trace
from ...models.moe import round_robin_plan
from .expert_placement import plan_masks
from .online import OnlineController, replay_cost

SMOKE = {"n_experts": 64, "n_shards": 8, "slots_per_shard": 12,
         "tokens_per_epoch": 3000, "n_epochs": 12, "kappa0": 400}


def _valid(masks: np.ndarray, n_shards: int, slots_per_shard: int) -> bool:
    """Every expert placed, every shard within its slot budget."""
    masks = np.asarray(masks, dtype=np.int64)
    if (masks <= 0).any() or (masks >> n_shards).any():
        return False
    bits = (masks[:, None] >> np.arange(n_shards)) & 1
    return bool((bits.sum(axis=0) <= slots_per_shard).all())


def drift_replay(n_experts: int, n_shards: int, slots_per_shard: int,
                 tokens_per_epoch: int, n_epochs: int, kappa0: int,
                 drift_rate: float, seed: int = 7, *,
                 frontier: str | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """One scenario: replay ``n_epochs`` epochs and score the three
    policies.  Returns each policy's total ``comm_cost`` and migration
    bytes, the online policy's commits, and the per-epoch costs."""
    ctrl = OnlineController(n_experts, n_shards, slots_per_shard,
                            kappa0=kappa0, seed=0, frontier=frontier,
                            device=device)
    rr_masks = plan_masks(round_robin_plan(n_experts, n_shards))
    static_masks = None
    cost = {"static_round_robin": 0.0, "static_replicated": 0.0,
            "online_replicated": 0.0}
    per_epoch = []
    chunks = drifting_trace(n_experts=n_experts,
                            tokens_per_epoch=tokens_per_epoch,
                            n_epochs=n_epochs, drift_rate=drift_rate,
                            seed=seed)
    for epoch, chunk in enumerate(chunks):
        # the plan in effect DURING this epoch is the one the controller
        # emitted at the end of the previous epoch (round-robin in warmup)
        online_masks = (plan_masks(ctrl.plan) if ctrl.plan is not None
                        else rr_masks)
        serving_static = (static_masks if static_masks is not None
                          else rr_masks)
        rep = ctrl.step(chunk)
        if static_masks is None and rep.plan is not None:
            static_masks = plan_masks(rep.plan)   # freeze the bootstrap plan
        for masks in (static_masks, None if rep.plan is None
                      else plan_masks(rep.plan)):
            if masks is not None and not _valid(masks, n_shards,
                                                slots_per_shard):
                raise AssertionError(f"epoch {epoch}: invalid placement")
        c_rr = replay_cost(rr_masks, chunk, n_shards)
        c_st = replay_cost(serving_static, chunk, n_shards)
        c_on = replay_cost(online_masks, chunk, n_shards)
        cost["static_round_robin"] += c_rr
        cost["static_replicated"] += c_st
        cost["online_replicated"] += c_on
        per_epoch.append({
            "epoch": epoch, "round_robin": c_rr, "static": c_st,
            "online": c_on, "committed": rep.committed,
            "migration_bytes": rep.migration_bytes})
    return {
        "policies": {
            "static_round_robin": {"comm_cost": cost["static_round_robin"],
                                   "migration_bytes": 0},
            "static_replicated": {"comm_cost": cost["static_replicated"],
                                  "migration_bytes": 0},
            "online_replicated": {"comm_cost": cost["online_replicated"],
                                  "migration_bytes":
                                      ctrl.total_migration_bytes,
                                  "commits": ctrl.n_commits},
        },
        "per_epoch": per_epoch,
    }

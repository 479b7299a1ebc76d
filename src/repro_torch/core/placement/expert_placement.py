"""Replication-aware expert placement: paper -> runtime bridge (the JAX
package's ``core/placement/expert_placement.py`` over the port's engine).

Pipeline (exactly the paper's moe-8 construction, §B.1, fed by a live
router trace instead of the published profiles):

  1. ``Model.route_trace`` yields (T, k) expert choices per MoE layer;
  2. ``trace_to_moe8`` turns them into a co-activation hypergraph
     (hyperedge = frequent k-tuple, weight = normalized frequency);
  3. hypergraph partitioning *with replication* (ILP-semantics heuristic,
     balance eps = spare expert-slot memory per device) assigns each expert
     a set of EP shards;
  4. the masks become a ``PlacementPlan`` whose local-fraction statically
     sizes the MoE all_to_all buffers.

``evaluate_plan`` reports the paper's (lambda_e - 1) cost for a plan, so
the communication reduction can be stated in the paper's own metric.
``frontier``/``device`` choose the partitioner's gain-pricing path, as in
``core.partition``: the CUDA kernels by default, ``device="cpu"`` for
their plain versions or ``frontier="numpy"`` for the host path, all
decision-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..hypergraph import Hypergraph
from ..partition import (partition_cost, partition_heuristic,
                         replicate_local_search)
from ...datagen.moe_traces import trace_to_moe8
from ...models.moe import PlacementPlan, plan_from_masks, round_robin_plan


@dataclasses.dataclass
class PlacementResult:
    plan: PlacementPlan
    baseline_plan: PlacementPlan
    lambda_cost_no_repl: float
    lambda_cost_repl: float
    local_fraction_no_repl: float
    local_fraction_repl: float


def plan_expert_placement(
    trace: np.ndarray,          # (T, k) expert ids from the router
    n_experts: int,
    n_shards: int,
    eps: float = 0.25,          # spare HBM expert slots per shard
    kappa0: int = 1000,
    seed: int = 0,
    max_replicas: int | None = None,
    *,
    frontier: str | None = None,
    device: str | torch.device = "cuda",
) -> PlacementResult:
    hg_full, freq = _hypergraph_in_expert_space(trace, kappa0, n_experts)

    base = partition_heuristic(hg_full, n_shards, eps, seed=seed,
                               frontier=frontier, device=device)
    rep = replicate_local_search(hg_full, base.masks.copy(), n_shards, eps,
                                 max_replicas=max_replicas, seed=seed,
                                 frontier=frontier, device=device)

    base_plan = plan_from_masks(base.masks, n_experts, n_shards,
                                expert_freq=freq)
    plan = plan_from_masks(rep.masks, n_experts, n_shards, expert_freq=freq)
    return PlacementResult(
        plan=plan,
        baseline_plan=base_plan,
        lambda_cost_no_repl=float(base.cost),
        lambda_cost_repl=float(rep.cost),
        local_fraction_no_repl=base_plan.local_fraction,
        local_fraction_repl=plan.local_fraction,
    )


def _hypergraph_in_expert_space(trace: np.ndarray, kappa0: int,
                                n_experts: int):
    """moe-8 hypergraph on the FULL expert id space (experts outside the
    frequent tuples become singleton-free nodes that the balance constraint
    still has to place), plus per-expert frequency.  Rides the same
    selection/weighting path as the paper construction in ``moe_traces``."""
    hg = trace_to_moe8(trace, kappa0=kappa0, name="moe8_full",
                       n=n_experts, drop_isolated=False)
    freq = np.bincount(trace.reshape(-1), minlength=n_experts).astype(float)
    return hg, freq


def plan_masks(plan: PlacementPlan) -> np.ndarray:
    """Per-expert shard bitmasks of a plan (expert e lives on shard p iff
    bit p of masks[e] is set) -- the engine's native placement encoding."""
    local = np.asarray(plan.local_slot)            # (P, n_experts)
    bits = np.int64(1) << np.arange(plan.n_shards, dtype=np.int64)
    return ((local >= 0).astype(np.int64) * bits[:, None]).sum(axis=0)


def evaluate_plan(plan: PlacementPlan, trace: np.ndarray, kappa0: int = 1000,
                  hg: Hypergraph | None = None) -> dict:
    """(lambda_e - 1) cost of a plan on a (held-out) trace.

    Pass a prebuilt ``hg`` (full-expert-space, e.g. from
    ``_hypergraph_in_expert_space``) to score several plans against the
    same traffic without rebuilding the hypergraph per call.
    """
    n_experts = plan.n_experts
    if hg is None:
        hg, _ = _hypergraph_in_expert_space(trace, kappa0, n_experts)
    masks = plan_masks(plan)
    cost = partition_cost(hg, masks, plan.n_shards)
    return {"lambda_cost": float(cost),
            "local_fraction": plan.local_fraction,
            "replicated_experts": int(np.count_nonzero(
                masks & (masks - 1)))}

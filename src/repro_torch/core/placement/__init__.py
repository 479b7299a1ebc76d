from .expert_placement import (PlacementResult, evaluate_plan,
                               plan_expert_placement, plan_masks)
from .online import (CoActivationAccumulator, EpochReport, HypergraphDelta,
                     OnlineController, plan_to_masks, replay_cost)
from .remat_policy import RematDecision, plan_remat
from .replay import SMOKE, drift_replay

__all__ = ["PlacementResult", "evaluate_plan", "plan_expert_placement",
           "plan_masks", "CoActivationAccumulator", "EpochReport",
           "HypergraphDelta", "OnlineController", "plan_to_masks",
           "replay_cost", "RematDecision", "plan_remat", "SMOKE",
           "drift_replay"]

from .expert_placement import (PlacementResult, evaluate_plan,
                               plan_expert_placement, plan_masks)
from .online import (CoActivationAccumulator, EpochReport, HypergraphDelta,
                     OnlineController, plan_to_masks, replay_cost)
from .replay import SMOKE, drift_replay

__all__ = ["PlacementResult", "evaluate_plan", "plan_expert_placement",
           "plan_masks", "CoActivationAccumulator", "EpochReport",
           "HypergraphDelta", "OnlineController", "plan_to_masks",
           "replay_cost", "SMOKE", "drift_replay"]

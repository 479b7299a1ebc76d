from .bsp import EPS, BspInstance, Schedule
from .engine import ScheduleState
from .exact import ExactScheduleResult, exact_schedule
from .list_sched import (baseline_schedule, bspg_schedule, derive_comms,
                         hill_climb, rebalance_comms)
from .multilevel import MultilevelScheduleOptions, multilevel_schedule
from .replication import (AdvancedOptions, advanced_heuristic,
                          best_replicated_schedule,
                          basic_heuristic, batch_replication_pass,
                          superstep_merge_pass, superstep_replication_pass,
                          superstep_split_pass)

__all__ = [
    "EPS", "BspInstance", "Schedule", "ScheduleState",
    "ExactScheduleResult", "exact_schedule",
    "baseline_schedule", "bspg_schedule", "derive_comms", "hill_climb",
    "rebalance_comms", "AdvancedOptions", "advanced_heuristic",
    "basic_heuristic", "batch_replication_pass", "best_replicated_schedule",
    "MultilevelScheduleOptions", "multilevel_schedule",
    "superstep_merge_pass",
    "superstep_replication_pass",
    "superstep_split_pass",
]

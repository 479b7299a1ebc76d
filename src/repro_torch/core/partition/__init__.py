from .cost import (capacity, edge_cost, edge_lambdas, is_balanced, is_valid,
                   loads, min_cover, partition_cost)
from .engine import PartitionState
from .exact import ExactResult, exact_partition
from .heuristic import (HeuristicResult, fm_refine, greedy_initial,
                        partition_heuristic, partition_with_replication,
                        replicate_local_search)
from .multilevel import (MultilevelOptions, multilevel_partition,
                         partition_with_replication_multilevel)
from .parallel import (ParallelContext, ShmRegistry, parallel_refine,
                       plan_shards, shm_available)

__all__ = [
    "capacity", "edge_cost", "edge_lambdas", "is_balanced", "is_valid",
    "loads", "min_cover", "partition_cost", "PartitionState", "ExactResult",
    "exact_partition", "HeuristicResult", "fm_refine", "greedy_initial",
    "partition_heuristic", "partition_with_replication",
    "replicate_local_search", "MultilevelOptions", "multilevel_partition",
    "partition_with_replication_multilevel", "ParallelContext",
    "ShmRegistry", "parallel_refine", "plan_shards", "shm_available",
]

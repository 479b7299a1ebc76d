from .moe_traces import (drifting_trace, moe_dataset, synthetic_trace,
                         trace_to_moe2, trace_to_moe8)
from .spmv import (fine_grained_hypergraph, large_row_net,
                   row_net_hypergraph, spmv_dataset, synthetic_sparse_matrix)

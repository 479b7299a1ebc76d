from .dags import (cg_dag, hdb_dataset, iterated_matmul_dag, knn_dag,
                   large_psdd_dag, large_sptrsv_dag, psdd_dag, psdd_dataset,
                   spmv_dag, sptrsv_dag, sptrsv_dataset, tiny_dataset)
from .moe_traces import (drifting_trace, moe_dataset, synthetic_trace,
                         trace_to_moe2, trace_to_moe8)
from .spmv import (fine_grained_hypergraph, large_row_net,
                   row_net_hypergraph, spmv_dataset, synthetic_sparse_matrix)

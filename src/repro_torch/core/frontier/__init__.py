"""Frontier-pricing layer: batched candidate-front evaluation.

  * ``partition_front`` -- ragged batched gain evaluation over the CSR
    arrays of a ``PartitionState`` (a NumPy backend, and a torch backend
    through ``repro_torch.kernels.gain``), plus the ``GainCache`` that
    makes FM / replication passes output-sensitive (only nodes whose gain
    changed are repriced);
  * ``schedule_front`` -- batched node-move pricing, superstep-replication
    and -merge front enumeration and pure pricing against flat
    per-superstep load arrays of a ``ScheduleState``, and the
    device-resident window pricers (``device_windows``).

Pricing is *bit-equal* to the scalar engine deltas
(``PartitionState.delta_masks`` / ``ScheduleState.delta_node_move``), so
the heuristics' decisions do not depend on the backend.
"""
from .partition_front import (GainCache, add_replica_candidates,
                              connected_add_candidates, connected_targets,
                              device_pass, fm_move_candidates, get_backend,
                              lookahead_window, move_candidates,
                              price_mask_front, refresh_boundary_window,
                              set_backend)
from .schedule_front import (apply_sm_mutations, apply_sr_mutations,
                             commit_superstep_merge,
                             commit_superstep_replication,
                             commit_superstep_split, device_windows,
                             node_move_targets, price_comm_moves,
                             price_comp_moves, price_node_moves,
                             price_superstep_merge,
                             price_superstep_replication,
                             price_superstep_split, sm_front, split_front,
                             sr_front)

__all__ = [
    "GainCache", "add_replica_candidates", "connected_add_candidates",
    "connected_targets", "device_pass", "fm_move_candidates", "get_backend",
    "lookahead_window", "move_candidates", "price_mask_front",
    "refresh_boundary_window", "set_backend",
    "apply_sm_mutations", "apply_sr_mutations", "commit_superstep_merge",
    "commit_superstep_replication", "commit_superstep_split",
    "device_windows", "node_move_targets",
    "price_comm_moves", "price_comp_moves", "price_node_moves",
    "price_superstep_merge", "price_superstep_replication",
    "price_superstep_split", "sm_front", "split_front", "sr_front",
]

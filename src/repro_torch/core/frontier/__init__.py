"""Frontier-pricing layer: batched candidate-front evaluation.

``partition_front`` -- ragged batched gain evaluation over the CSR arrays
of a ``PartitionState`` (a NumPy backend, and a torch backend through
``repro_torch.kernels.gain``), plus the ``GainCache`` that makes FM /
replication passes output-sensitive (only nodes whose gain changed are
repriced).  Pricing is *bit-equal* to the scalar engine deltas
(``PartitionState.delta_masks``), so the heuristics' decisions do not
depend on the backend.
"""
from .partition_front import (GainCache, add_replica_candidates,
                              connected_add_candidates, connected_targets,
                              device_pass, fm_move_candidates, get_backend,
                              lookahead_window, move_candidates,
                              price_mask_front, refresh_boundary_window,
                              set_backend)

__all__ = [
    "GainCache", "add_replica_candidates",
    "connected_add_candidates", "connected_targets", "device_pass",
    "fm_move_candidates", "get_backend", "lookahead_window",
    "move_candidates", "price_mask_front", "refresh_boundary_window",
    "set_backend",
]

"""Collective bytes of a traced step, and the dry run's cost summary.

The JAX package parses the compiled HLO text for its collectives.  The
port has no HLO: ``CollectiveCounter``, a ``TorchDispatchMode``, sees the
``torch.ops._c10d_functional`` collectives that the program calls while
it is held (the functional collectives of ``torch.distributed``, which
DTensor and ``_functional_collectives`` use) and sums each one's result
buffer, per kind -- the quantity that ``collective_bytes_from_text``
takes from an HLO line's result type, per participant.  The kinds keep
the HLO names: ``all_gather_into_tensor`` counts as all-gather,
``all_reduce`` as all-reduce, ``reduce_scatter_tensor`` as reduce-scatter,
``all_to_all_single`` (which ``permute_tensor`` also calls) as
all-to-all, and the point-to-point receives (``irecv``,
``batch_p2p_ops``) as collective-permute; the ``_coalesced`` forms count
once with all their results.  ``wait_tensor`` moves nothing.

The port's distributed path (``parallel.sharding``) calls exactly these
functional collectives, so under a mesh the counter sees every byte a
rank moves: the psums of the tensor-parallel products and their
backwards (all-reduces of the activations), the all-gathers of the
leaves a family reads whole (and their backward reduce-scatters), the
MoE layers' all_to_alls and psums, the gradient all-reduces.  A psum
over an axis of one rank calls nothing, so counts nothing; an all-gather
over a group of one is called, and counted.  On the meta device (the
dry run) the same calls are counted at their results' sizes.

``summarize_cost`` is the JAX package's, key for key: the dry run hands
it its counts under XLA's names (``flops``, ``bytes accessed``).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_KIND_OF = {"all_gather_into_tensor": "all-gather",
            "all_gather_into_tensor_coalesced": "all-gather",
            "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "reduce_scatter_tensor_coalesced": "reduce-scatter",
            "all_to_all_single": "all-to-all",
            "irecv": "collective-permute",
            "batch_p2p_ops": "collective-permute"}


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives called while held; ``result()``
    returns ``collective_bytes_from_text``'s dict: ``per_kind_bytes``,
    ``counts`` (both keyed by the HLO kinds) and ``total_bytes``."""

    def __init__(self):
        super().__init__()
        self.per_kind = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            kind = _KIND_OF.get(func._opname)
            if kind is not None:
                self.per_kind[kind] += sum(
                    t.numel() * t.element_size() for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
                self.counts[kind] += 1
        return out

    def result(self) -> dict:
        return {"per_kind_bytes": dict(self.per_kind),
                "counts": dict(self.counts),
                "total_bytes": int(sum(self.per_kind.values()))}


def summarize_cost(cost) -> dict:
    """cost_analysis() returns a dict (or list of dicts) of named scalars."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    out = {}
    for key in ("flops", "bytes accessed", "transcendentals",
                "optimal_seconds"):
        if key in cost:
            out[key.replace(" ", "_")] = float(cost[key])
    # per-memory-space bytes where present
    for k, v in cost.items():
        if k.startswith("bytes accessed") and k != "bytes accessed":
            out[k.replace(" ", "_").replace("'", "")] = float(v)
    return out

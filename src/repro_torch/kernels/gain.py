"""Batched min-cover (gain) kernels: the torch backend of the frontier.

The frontier layer's hot reduction is: given ``uncov`` rows (one per
(candidate, edge) pair, ``2^P`` processor-subset columns), find each row's
minimum-popcount subset with zero uncovered pins -- ``lambda_e`` under the
candidate mask.  ``engine._lambda_from_rows`` does it on the host; here
``min_cover`` runs as a hand-written CUDA kernel (``csrc/gain.cu``) on CUDA
tensors and as the plain PyTorch version of ``ref`` on CPU tensors
(``ops.use_kernel``).  ``front_dlam``, the cost delta of each row, is the
plain version alone: the device pass prices its candidate rows inside the
fused find (``front_find``).

Because the subsets with ``uncov == 0`` always include the full processor
set (every assigned pin is covered by *some* processor), the first zero in
popcount order equals the minimum popcount over all zeros -- which is the
masked-min formulation the kernels use, avoiding a gather.

Columns come in popcount order with the empty subset first, ``M = 2^P``
of them, and ``pc[0]`` is the ``_NO_COVER`` sentinel.  Lambdas are small
integers, so this backend feeds bit-identical values into the frontier's
float64 NumPy cost reduction: backend choice cannot change a single
heuristic decision.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ops
from .ref import _NO_COVER, front_dlam_ref, min_cover_ref

__all__ = ["_NO_COVER", "front_dlam", "min_cover", "min_cover_lambdas"]

_INT32 = (torch.int32,)


def _launch(rows_perm: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    from ._build import load
    if rows_perm.dim() != 2:
        raise ValueError(f"rows_perm must be (R, M), got {tuple(rows_perm.shape)}")
    R, M = rows_perm.shape
    dev = rows_perm.device
    ops.check("rows_perm", rows_perm, (R, M), _INT32, dev)
    ops.check("pc", pc, (M,), _INT32, dev)
    out = torch.empty(R, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = load("gain").repro_min_cover(
            rows_perm.data_ptr(), pc.data_ptr(), out.data_ptr(), R, M,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"min_cover_lambdas launch failed: CUDA error {err}")
    ops.launches["min_cover_lambdas"] += 1
    return out


def min_cover(rows_perm: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """(R,) int32 masked-min lambda per row of an (R, M) int32 tensor."""
    if ops.use_kernel(rows_perm):
        ops.no_backward("min_cover_lambdas", rows_perm, pc)
        return _launch(rows_perm, pc)
    return min_cover_ref(rows_perm, pc)


def front_dlam(rows_perm: torch.Tensor, pc: torch.Tensor,
               lam_old: torch.Tensor) -> torch.Tensor:
    """Per-row integer cost deltas for a candidate front.

    ``rows_perm`` is an (R, M) int32 tensor of candidate uncov rows in
    popcount-column order (column 0 = subset 0), ``pc`` the (M,) popcounts
    with a ``_NO_COVER`` sentinel at column 0, ``lam_old`` the (R,) current
    edge lambdas.  Returns the (R,) int32 ``relu(lam_new-1)-relu(lam_old-1)``
    terms.  CPU tensors only: on the card the device pass prices its rows
    inside the fused find (``front_find``), and no kernel takes this role
    alone.
    """
    if ops.use_kernel(rows_perm):
        raise ValueError("front_dlam has no kernel of its own: a CUDA tensor "
                         "goes through front_find.front_find")
    return front_dlam_ref(rows_perm, pc, lam_old)


def min_cover_lambdas(rows: np.ndarray, order: np.ndarray,
                      order_pc: np.ndarray, *,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """Min-cover size per uncov row (torch path of ``price_mask_front``).

    Drop-in for ``engine._lambda_from_rows``: ``rows`` is (R, 2^P) with
    column 0 the assigned-pin count, ``order``/``order_pc`` the engine's
    popcount-ordered non-empty subsets and their popcounts.  The rows go to
    ``device`` with column 0 first and ``pc[0] = _NO_COVER``; rows with no
    assigned pin get lambda 0 (handled host-side, so the kernel is a pure
    masked min).
    """
    R = rows.shape[0]
    if R == 0:
        return np.zeros(0, dtype=np.int16)
    colmap = np.concatenate(([0], np.asarray(order, dtype=np.int64)))
    pc = np.concatenate(([_NO_COVER], np.asarray(order_pc, dtype=np.int64)))
    rows_perm = torch.from_numpy(
        np.ascontiguousarray(rows[:, colmap], dtype=np.int32)).to(device)
    pc_t = torch.from_numpy(pc.astype(np.int32)).to(device)
    lam = min_cover(rows_perm, pc_t).cpu().numpy().astype(np.int16)
    lam[rows[:, 0] == 0] = 0
    return lam

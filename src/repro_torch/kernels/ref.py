"""Plain PyTorch versions of the CUDA kernels.

They define what each kernel computes.  A wrapper in ``gain`` takes them
for tensors that lie on the CPU (the tests), and the smoke run on the card
holds each kernel against them on the same inputs.
"""
from __future__ import annotations

import torch

_NO_COVER = 127  # > any popcount for P <= 12; also pc[0], the empty subset


def min_cover_ref(rows_perm: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """(R,) int32 masked min: per row, the least ``pc[c]`` over the columns
    where ``rows_perm[r, c] == 0``, or ``_NO_COVER`` if there is none."""
    return torch.where(rows_perm == 0, pc[None, :],
                       _NO_COVER).amin(dim=1).to(torch.int32)


def front_dlam_ref(rows_perm: torch.Tensor, pc: torch.Tensor,
                   lam_old: torch.Tensor) -> torch.Tensor:
    """(R,) int32 ``relu(lam_new - 1) - relu(lam_old - 1)`` with ``lam_new``
    the masked min of ``min_cover_ref``."""
    lam = min_cover_ref(rows_perm, pc)
    return (lam - 1).clamp_min(0) - (lam_old - 1).clamp_min(0)

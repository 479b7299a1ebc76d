"""Kernel dispatch by the device of the input tensor, and launch counts.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the
plain PyTorch version (``ref``); there is no fallback from one to the
other.  ``force`` overrides the choice for tests only: ``"cuda"`` sends
every call to the kernel (a CPU tensor then raises), ``"ref"`` every call
to the plain version.

``launches`` counts, per kernel, the launches its wrapper made; a run sets
the counts to 0 with ``reset_launches`` and reads them afterwards to show
which kernels its path went through.  ``min_cover_apply`` counts the
min-cover kernel's launches from the device pass's applies (the reference
does that step in plain jnp), ``min_cover_lambdas`` those that price a front.
"""
from __future__ import annotations

import torch

_FORCE: str | None = None  # None = by device, 'cuda' | 'ref'

launches: dict[str, int] = {"front_dlam": 0, "min_cover_lambdas": 0,
                             "min_cover_apply": 0}


def force(which: str | None) -> None:
    if which not in (None, "cuda", "ref"):
        raise ValueError(f"force({which!r}): expected None, 'cuda' or 'ref'")
    global _FORCE
    _FORCE = which


def use_kernel(t: torch.Tensor) -> bool:
    if _FORCE is not None:
        return _FORCE == "cuda"
    return t.is_cuda


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0

"""Grouped matmul of the MoE expert FFN on the card: the wrapper of
``csrc/moe_gmm.cu``.

The kernel replaces the JAX package's Pallas ``grouped_matmul``: rows in
the block-aligned layout of the dispatch buffers, ``y[g*C + r] = x[g*C + r]
@ w[g]``, accumulated in f32.  It takes any capacity ``C`` (the TPU
kernel wanted ``C`` a multiple of its row block): decode gives C = 1 and
takes a path that streams the weights, prefill a tiled one (tensor cores
in bf16).
``ops.grouped_matmul_aligned`` dispatches here for CUDA tensors;
``ref.grouped_matmul_aligned_ref`` is the plain version.
"""
from __future__ import annotations

import torch

from . import ops

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 65535          # grid.y and grid.z of a launch
_ROWS_PER_TILE = {True: 4, False: 128}   # C <= 16 (decode path), else


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """x (G * capacity, D) and w (G, D, F) on one CUDA device, contiguous,
    both f32 or both bf16.  Returns (G * capacity, F) in x's dtype."""
    from ._build import load
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError("x must be (G * capacity, D) and w (G, D, F)")
    G, D, F = w.shape
    C = int(capacity)
    if C < 1 or D < 1 or F < 1:
        raise ValueError(f"capacity, D and F must be >= 1, got {C}, {D}, {F}")
    dev = x.device
    ops.check("x", x, (G * C, D), _DTYPES, dev)
    ops.check("w", w, (G, D, F), (x.dtype,), dev)
    if G > _MAX_GRID or -(-C // _ROWS_PER_TILE[C <= 16]) > _MAX_GRID:
        raise ValueError(f"{G} groups of capacity {C}: over the grid limit")
    out = torch.empty((G * C, F), dtype=x.dtype, device=dev)
    fn = load("moe_gmm").repro_grouped_matmul
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), G, C, D, F,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"grouped_matmul launch failed: CUDA error {err}")
    ops.launches["grouped_matmul"] += 1
    return out

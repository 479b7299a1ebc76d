"""Grouped matmul of the MoE expert FFN on the card: the wrappers of the
three grouped-matmul kernels and the choice between them.

The kernels replace the JAX package's Pallas ``grouped_matmul``: rows in
the block-aligned layout of the dispatch buffers, ``y[g*C + r] = x[g*C + r]
@ w[g]``, accumulated in f32.  They take any capacity ``C`` (the TPU
kernel wanted ``C`` a multiple of its row block), and an optional
``fills`` (G,) int32: rows ``r >= fills[g]`` of group g come out as exact
zeros and cost no product, the rows the dispatch pads a slot with.
``ops.grouped_matmul_aligned`` dispatches here for CUDA tensors;
``ref.grouped_matmul_aligned_ref`` is the plain version.  Routes, chosen
by ``route`` from the dtype and the shapes alone:

- ``gmv`` (``csrc/moe_gmm.cu``): ``C <= DECODE_ROWS``, f32 or bf16 --
  decode, bound by the weight bytes; a slot with no live row reads none;
- ``gmm_tc`` (``csrc/moe_gmm_tc.cu``): bf16, ``C > DECODE_ROWS``, D and F
  multiples of 8 (TMA's 16-byte strides) -- wgmma on the tensor cores,
  tiles by TMA, dead row tiles skipped;
- ``general`` (``csrc/moe_gmm.cu``): the rest (f32 prefill, ragged D or
  F) on the tensor cores -- mma.sync, 3xTF32 for f32 (near f32 accuracy),
  tiles by cp.async where D and F allow 16-byte pieces; dead row tiles
  skipped.

A kernel that fails to build or launch raises; no route falls back to
another or to the plain version.

Training: ``grouped_matmul_train`` runs the forward above through
``_GroupedMatmul``, an autograd Function whose backward is
``grouped_matmul_bwd`` (dX and dW, fill-aware, no atomics), for f32 or
bf16 with D and F multiples of 8, and raises for any other call that needs
a gradient.  Backward routes, chosen by ``bwd_route`` from the dtype and
the shapes alone:

- ``tc`` (``csrc/moe_gmm_bwd_tc.cu``): bf16 -- ``gmm_tc``'s wgmma tile and
  persistent walk, tiles by TMA, with the operand layouts of the two
  gradients;
- ``general`` (``csrc/moe_gmm_bwd.cu``): f32 -- mma.sync in 3xTF32.

``ref.grouped_matmul_aligned_bwd_ref`` is their plain version.

On meta tensors (``ops``: the dry run) ``grouped_matmul`` and
``grouped_matmul_bwd`` check the call, choose its route and allocate its
outputs, launch nothing, and count the FLOPs and bytes of its bound
(``gmm_cost``) in ``ops.meta_cost``.  The fills lie on the device, so on
meta every row counts as live: the most the call could need.
"""
from __future__ import annotations

import torch

from . import ops
from .flash_attention import sm_count

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 65535          # grid.y and grid.z of a launch
DECODE_ROWS = 16           # the largest capacity of the ``gmv`` route
_GMV_ROWS = 4              # rows per block of ``gmv`` (at most)
_GENERAL_TILE = 128        # rows per block of ``general``
_TC_TILE = (128, 256)      # the output tile of ``gmm_tc``
_BWD_TILE = 128            # the output tiles of ``moe_gmm_bwd.cu``, square


def route(dtype, C: int, D: int, F: int) -> str:
    """The kernel a grouped product of these shapes goes to (see the module
    docstring); a pure function of the dtype and the shapes."""
    if C <= DECODE_ROWS:
        return "gmv"
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        return "gmm_tc"
    return "general"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gmm_cost(esize: int, G: int, C: int, D: int, F: int, fills: bool,
             part: str = "fwd") -> tuple[int, int]:
    """(FLOPs, bytes) of the bound of one grouped product (``part`` "fwd")
    or of one of its gradients ("dx", "dw"), every row live: 2 C D F FLOPs
    a group; the forward reads x and w and writes y once, dX reads dy and
    w and writes dx once, dW reads x and dy and writes dw once; the int32
    fills once where given."""
    rows = G * C
    flops = 2 * rows * D * F
    nbytes = {"fwd": rows * D + G * D * F + rows * F,
              "dx": rows * F + G * D * F + rows * D,
              "dw": rows * (D + F) + G * D * F}[part] * esize
    return flops, nbytes + (4 * G if fills else 0)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, capacity: int,
                   fills: torch.Tensor | None = None) -> torch.Tensor:
    """x (G * capacity, D) and w (G, D, F) on one CUDA device, contiguous,
    both f32 or both bf16; ``fills`` None or (G,) int32 on the same
    device.  Returns (G * capacity, F) in x's dtype.

    Counts as ``grouped_matmul`` and once in ``ops.gmm_route_launches``
    under its route."""
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
    if fills is not None:
        ops.check("fills", fills, (G,), (torch.int32,), dev)
    which = route(x.dtype, C, D, F)
    if which == "gmm_tc":
        tiles = G * _cdiv(C, _TC_TILE[0]) * _cdiv(F, _TC_TILE[1])
        if tiles >= 2 ** 31:
            raise ValueError(f"{tiles} output tiles: over the index range")
        if any(t.data_ptr() % 16 for t in (x, w)):
            raise ValueError("route gmm_tc needs 16-byte aligned x and w")
    else:
        rows = _GMV_ROWS if which == "gmv" else _GENERAL_TILE
        if G > _MAX_GRID or _cdiv(C, rows) > _MAX_GRID:
            raise ValueError(f"{G} groups of capacity {C}: over the grid "
                             "limit")
    out = torch.empty((G * C, F), dtype=x.dtype, device=dev)
    if dev.type == "meta":
        ops.add_meta_cost("grouped_matmul", *gmm_cost(
            x.element_size(), G, C, D, F, fills is not None))
        return out
    fp = None if fills is None else fills.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if which == "gmm_tc":
            ctas = min(tiles, sm_count(dev.index))
            err = load("moe_gmm_tc").repro_grouped_matmul_tc(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), fp, G, C, D, F,
                ctas, stream)
        else:
            fn = load("moe_gmm").repro_grouped_matmul
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), fp, G, C, D,
                     F, int(x.dtype == torch.bfloat16), int(which == "gmv"),
                     stream)
    if err:
        raise RuntimeError(f"grouped_matmul ({which}) launch failed: CUDA "
                           f"error {err}")
    ops.launches["grouped_matmul"] += 1
    ops.gmm_route_launches[which] += 1
    return out


def bwd_route(dtype, D: int, F: int) -> str:
    """The backward kernel a grouped product of these shapes goes to (see
    the module docstring): ``"tc"`` for bf16, ``"general"`` for f32; a pure
    function of the dtype and the shapes.  Raises for a product that
    neither takes: another dtype, or D or F not a multiple of 8."""
    if dtype not in _DTYPES:
        raise RuntimeError(f"grouped_matmul in {dtype} has no backward "
                           "kernel")
    if D % 8 or F % 8:
        raise RuntimeError(f"grouped_matmul with D = {D}, F = {F} has no "
                           "backward kernel: it takes multiples of 8")
    return "tc" if dtype == torch.bfloat16 else "general"


def _check_bwd(x: torch.Tensor, w: torch.Tensor) -> str:
    """``bwd_route`` of a product of these tensors (raising where no
    backward kernel takes it)."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError("x must be (G * capacity, D) and w (G, D, F)")
    return bwd_route(x.dtype, *w.shape[1:])


def grouped_matmul_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                       capacity: int, fills: torch.Tensor | None = None,
                       need_dx: bool = True, need_dw: bool = True
                       ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(dx, dw) of ``grouped_matmul``: x (G * capacity, D), w (G, D, F),
    dy (G * capacity, F), contiguous and 16-byte aligned on one CUDA
    device, all f32 or all bf16, D and F multiples of 8; ``fills`` None or
    (G,) int32.  Launches only the products asked for (the other comes
    back None).  Counts once as ``grouped_matmul_bwd`` and once in
    ``ops.bwd_route_launches`` under its route."""
    which = _check_bwd(x, w)
    dx, dw = _bwd_launch(which, x, w, dy, int(capacity), fills, need_dx,
                         need_dw)
    if x.is_meta:
        G, D, F = w.shape
        costs = [gmm_cost(x.element_size(), G, int(capacity), D, F,
                          fills is not None, part)
                 for part, need in (("dx", need_dx), ("dw", need_dw))
                 if need]
        ops.add_meta_cost("grouped_matmul_bwd", sum(c[0] for c in costs),
                          sum(c[1] for c in costs))
        return dx, dw
    ops.launches["grouped_matmul_bwd"] += 1
    ops.bwd_route_launches[f"gmm_{which}"] += 1
    return dx, dw


def _bwd_launch(which: str, x, w, dy, C: int, fills, need_dx: bool,
                need_dw: bool):
    """Check the tensors and launch route ``which``'s backward kernels."""
    from ._build import load
    G, D, F = w.shape
    if C < 1 or (which == "general" and (
            G > _MAX_GRID or _cdiv(max(C, D), _BWD_TILE) > _MAX_GRID)):
        raise ValueError(f"{G} groups of capacity {C}, D = {D}: over the "
                         "grid limit")
    dev = x.device
    ops.check("x", x, (G * C, D), _DTYPES, dev)
    ops.check("w", w, (G, D, F), (x.dtype,), dev)
    ops.check("dy", dy, (G * C, F), (x.dtype,), dev)
    if fills is not None:
        ops.check("fills", fills, (G,), (torch.int32,), dev)
    if any(t.data_ptr() % 16 for t in (x, w, dy)):
        raise ValueError("the grouped-matmul backward needs 16-byte aligned "
                         "x, w and dy")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if dev.type == "meta":
        return dx, dw
    ptrs = (x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            None if dx is None else dx.data_ptr(),
            None if dw is None else dw.data_ptr(),
            None if fills is None else fills.data_ptr(), G, C, D, F)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if which == "tc":
            err = load("moe_gmm_bwd_tc").repro_grouped_matmul_bwd_tc(
                *ptrs, sm_count(dev.index), stream)
        else:
            err = load("moe_gmm_bwd").repro_grouped_matmul_bwd(*ptrs, 0,
                                                               stream)
    if err:
        raise RuntimeError(f"grouped_matmul backward ({which}) launch "
                           f"failed: CUDA error {err}")
    return dx, dw


class _GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` forward (its route unchanged),
    ``grouped_matmul_bwd`` backward; saves x, w and the fills."""

    @staticmethod
    def forward(ctx, x, w, capacity: int, fills):
        ctx.save_for_backward(x, w, fills)
        ctx.capacity = capacity
        return grouped_matmul(x, w, capacity, fills)

    @staticmethod
    def backward(ctx, dy):
        x, w, fills = ctx.saved_tensors
        dx, dw = grouped_matmul_bwd(x, w, dy.contiguous(), ctx.capacity,
                                    fills, ctx.needs_input_grad[0],
                                    ctx.needs_input_grad[1])
        return dx, dw, None, None


def grouped_matmul_train(x: torch.Tensor, w: torch.Tensor, capacity: int,
                         fills: torch.Tensor | None = None) -> torch.Tensor:
    """``grouped_matmul`` with a gradient: raises before anything runs
    where the backward kernel does not take the product (``_check_bwd``)."""
    _check_bwd(x, w)
    return _GroupedMatmul.apply(x, w, capacity, fills)

"""AdamW's update of one leaf on the card: the wrapper of ``csrc/adamw.cu``.

The kernel replaces no TPU kernel: the JAX package's per-leaf update
(``src/repro/optim/adamw.py``) is jnp that XLA fuses into one pass, and
this is that pass, one launch a leaf.  It reads the gradient (bf16 or
f32), m (f32, or bf16 under ``compress_moments``), v and the f32 master,
and writes m, v, the master and the parameter.  The step's scalars --
clip scale, lr, 1 - b1^t, 1 - b2^t -- come in as a device tensor
(``scalars``, 4 f32), never as host floats, so that a CUDA graph's replay
uses each step's values.  ``optim.adamw.apply_updates`` launches it for
every leaf on the card; its plain version is that module's per-leaf loop
(``optim.adamw.update_leaf``), which the CPU runs.

On meta tensors (``ops``: the dry run) ``fused_update`` checks the call,
launches nothing and counts its bytes (``adamw_cost``) in
``ops.meta_cost``.
"""
from __future__ import annotations

import torch

from . import ops

_FLOATS = (torch.float32, torch.bfloat16)


def adamw_cost(g: torch.Tensor, m: torch.Tensor, p: torch.Tensor
               ) -> tuple[int, int]:
    """(FLOPs, bytes) of the update's bound: no tensor-core work, and each
    of g, m, v and the master read once, m, v, the master and the
    parameter written once."""
    n = p.numel()
    return 0, n * (g.element_size() + 2 * m.element_size() + 16
                   + p.element_size())


def fused_update(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 master: torch.Tensor, p: torch.Tensor,
                 scalars: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One AdamW step of a leaf, in place: ``m``, ``v``, ``master`` and
    the parameter ``p`` (its values; a view is written through).  ``g`` and
    ``p`` bf16 or f32, ``m`` f32 or bf16, ``v`` and ``master`` f32, all of
    one shape on one device (m, v and the master contiguous); ``scalars``
    (4,) f32 on that device: clip scale, lr, 1 - b1^t, 1 - b2^t.  Counts as
    ``adamw``."""
    dev = p.device
    shape = tuple(p.shape)
    for name, t, dtypes in (("g", g, _FLOATS), ("m", m, _FLOATS),
                            ("v", v, (torch.float32,)),
                            ("master", master, (torch.float32,)),
                            ("p", p, _FLOATS)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("m", m), ("v", v), ("master", master)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(scalars.shape) != (4,) or scalars.dtype != torch.float32 \
            or scalars.device != dev:
        raise ValueError(f"scalars must be (4,) f32 on {dev}")
    if dev.type == "meta":
        ops.add_meta_cost("adamw", *adamw_cost(g, m, p))
        return
    out = p if p.is_contiguous() else torch.empty_like(
        p, memory_format=torch.contiguous_format)
    _launch(g.contiguous(), m, v, master, out, scalars,
            (b1, 1 - b1, b2, 1 - b2, eps, weight_decay))
    if out is not p:
        p.copy_(out)
    ops.launches["adamw"] += 1


def _launch(g, m, v, master, p, scalars, consts: tuple) -> None:
    """``csrc/adamw.cu`` on contiguous CUDA tensors, on the current
    stream."""
    from ._build import load
    if not g.is_cuda:
        raise ValueError(f"the AdamW kernel takes CUDA tensors, got "
                         f"{g.device}")
    fn = load("adamw").repro_adamw
    bf16 = [int(t.dtype == torch.bfloat16) for t in (g, m, p)]
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 master.data_ptr(), p.data_ptr(), scalars.data_ptr(),
                 p.numel(), *bf16, *consts,
                 torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"adamw launch failed: CUDA error {err}")

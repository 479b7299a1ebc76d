"""AdamW with a cosine schedule and global-norm clipping: the JAX package's
``optim/adamw.py`` on tensors, updating in place.

The state holds the step (an int32 scalar on the parameters' device), an
f32 master copy of every parameter and the moments ``m`` (bf16 with
``compress_moments``, else f32) and ``v`` (f32), each a dict keyed like
the parameters.  ``apply_updates`` follows the reference's formula exactly
-- clip by the global norm, decoupled weight decay on the master, the
parameters cast from the master -- in f32 on the device: the norm, the
clip scale and the schedule as tensors on the device, then each leaf's
update, on the card one launch of the fused kernel a leaf
(``kernels.adamw``, whose scalars it reads from the device), on the CPU
``update_leaf``, its plain version (a leaf's f32 temporaries at a time).
Not ``torch.optim.AdamW``, whose update differs (it decays the parameter,
not an f32 master, and clips nothing).  Under a mesh ``train.step`` hands
it each rank's blocks (under ZeRO their data slices) and the global
gradient norm.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import adamw as fused
from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_moments: bool = False


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32: linear warm-up,
    then a cosine decay to 0 at ``total_steps``."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def init_state(cfg: AdamWConfig, params: dict) -> dict:
    """Step 0, the f32 master copy and zero moments of ``params`` (a dict
    of tensors), on their devices, each contiguous."""
    mdt = torch.bfloat16 if cfg.compress_moments else torch.float32
    dev = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": {n: p.detach().float().clone(
            memory_format=torch.contiguous_format)
            for n, p in params.items()},
        "m": {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
    }


@torch.no_grad()
def update_leaf(cfg: AdamWConfig, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, master: torch.Tensor, p: torch.Tensor,
                scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
                b2c: torch.Tensor) -> None:
    """One leaf's update in place, eager elementwise operations: the
    fused kernel's plain version (``kernels.adamw``), in its order."""
    g = g.float() * scale
    # m.float() is m itself in f32: updated in place either way
    m_new = m.float().mul_(cfg.b1).add_((1 - cfg.b1) * g)
    if m_new is not m:
        m.copy_(m_new)               # bf16 moment, rounded once
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    delta = (m_new / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
        + cfg.weight_decay * master
    master.sub_(lr * delta)
    p.copy_(master)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, state: dict, grads: dict,
                  params: dict, gnorm: torch.Tensor | None = None) -> dict:
    """One AdamW step from ``grads`` (a dict keyed like ``params``): the
    state's step, master and moments and the parameters are updated in
    place, with no read back to the host.  ``gnorm``, the global gradient
    norm, defaults to that of ``grads``.  Returns {"grad_norm", "lr"} (f32
    scalars on the device, unclipped norm)."""
    state["step"].add_(1)
    step = state["step"]
    if gnorm is None:
        gnorm = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(grads[n], dtype=torch.float32)
            for n in params]))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    sf = step.float()
    b1c = 1 - torch.pow(cfg.b1, sf)
    b2c = 1 - torch.pow(cfg.b2, sf)
    scalars = None
    for n, p in params.items():
        m, v, master = state["m"][n], state["v"][n], state["master"][n]
        if not ops.use_kernel(p):
            update_leaf(cfg, grads[n], m, v, master, p, scale, lr, b1c, b2c)
            continue
        if scalars is None:
            scalars = torch.stack([scale, lr, b1c, b2c])
        fused.fused_update(grads[n], m, v, master, p, scalars, cfg.b1,
                           cfg.b2, cfg.eps, cfg.weight_decay)
    return {"grad_norm": gnorm, "lr": lr}

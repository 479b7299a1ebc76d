"""The training step on one device: loss, gradients and the AdamW update.

The twin of the JAX package's ``train/step.py::build_train_step`` without
its meshes and shardings (the distributed path comes later).  The model
(``models.model.Model``) holds the parameters; the training state is
``{"params": {name: parameter}, "opt": adamw state}``, ``params`` being
the model's own parameters, which the step updates in place.  A state
whose ``params`` are other tensors (a checkpoint restored, a state carried
across from the JAX package) is copied into the model at the next step.

On a CUDA device the forward passes run the attention and scan kernels and
the backward passes their backward kernels (``kernels.ops``); the model's
``remat`` recomputes each layer in the backward pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.model import Model
from ..optim import adamw


def batch_to(batch: dict, device) -> dict:
    """A data batch (numpy arrays or tensors) as tensors on ``device``:
    token ids int64, float inputs f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


@dataclasses.dataclass
class TrainStep:
    cfg: ModelConfig
    opt_cfg: adamw.AdamWConfig
    device: torch.device
    model: Model | None = None

    def init_state(self, seed: int = 0) -> dict:
        """A fresh model drawn from ``torch.Generator(device)`` seeded with
        ``seed`` (none on the meta device, whose draws make no numbers),
        gradients on, and AdamW's initial state."""
        self.model = None     # the old weights go before the new are drawn
        gen = (None if self.device.type == "meta"
               else torch.Generator(device=self.device).manual_seed(seed))
        self.model = Model(self.cfg, device=self.device,
                           generator=gen).requires_grad_(True)
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": adamw.init_state(self.opt_cfg,
                                                          params)}

    def _bind(self, params: dict) -> dict:
        """The model's parameters, holding ``params``' values."""
        if self.model is None:
            self.init_state(0)
        own = dict(self.model.named_parameters())
        if own.keys() != params.keys():
            raise ValueError("the state's parameters are not the model's: "
                             f"{sorted(set(own) ^ set(params))[:4]}")
        with torch.no_grad():
            for name, p in own.items():
                if params[name] is not p:
                    p.copy_(params[name])
        return own

    def grads(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """The loss and its gradients on ``batch`` (``batch_to`` form):
        returns (the model's parameters, each ``.grad`` set -- zeros where
        the loss does not reach it -- and the loss metrics)."""
        params = self._bind(state["params"])
        for p in params.values():
            p.grad = None
        loss, metrics = self.model.loss(batch)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return params, {k: v.detach() for k, v in metrics.items()}

    def update(self, state: dict, params: dict) -> dict:
        """AdamW from the parameters' ``.grad`` (then dropped), in place;
        returns its metrics."""
        out = adamw.apply_updates(self.opt_cfg, state["opt"],
                                  {n: p.grad for n, p in params.items()},
                                  params)
        for p in params.values():
            p.grad = None
        return out

    def step_fn(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One step on ``batch``: ``grads`` then ``update``.  Returns (the
        state, updated in place, and the metrics: ``loss``, ``ce``,
        ``aux``, ``grad_norm``, ``lr``, as 0-d tensors)."""
        params, metrics = self.grads(state, batch)
        metrics.update(self.update(state, params))
        return {"params": params, "opt": state["opt"]}, metrics


def build_train_step(cfg: ModelConfig,
                     opt_cfg: adamw.AdamWConfig | None = None, *,
                     device: str | torch.device = "cuda") -> TrainStep:
    """The step of ``cfg`` on ``device`` (default CUDA, which raises
    without a card); its model is drawn by ``init_state`` (or seed 0 at the
    first step)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_train_step on device 'cuda', but no CUDA "
                           "device is available; pass device='cpu' for the "
                           "plain PyTorch versions")
    return TrainStep(cfg, opt_cfg or adamw.AdamWConfig(), dev)

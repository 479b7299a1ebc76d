"""Assigned input shapes and abstract input specs for the dry run.

The JAX package's ``configs/shapes.py``, kept apart so that the port
imports nothing of that package.  Shapes (per assignment):

    train_4k      seq_len=4096    global_batch=256   (train_step)
    prefill_32k   seq_len=32768   global_batch=32    (prefill)
    decode_32k    seq_len=32768   global_batch=128   (decode: 1 new token,
                                                      KV cache of seq_len)
    long_500k     seq_len=524288  global_batch=1     (long-context decode)

Applicability: ``long_500k`` requires sub-quadratic attention -> only
SSM/hybrid archs; encoder-only archs have no decode.

``input_specs`` returns tensors on the ``meta`` device where the JAX
package returns ``ShapeDtypeStruct``s: the same keys, shapes and dtypes,
and no memory behind them.  It and ``cell_is_applicable`` also take a
``Shape`` that is not in ``SHAPES`` (the dry run of another batch).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def _shape(shape: str | Shape) -> Shape:
    """A ``Shape`` as it stands, or the one of ``SHAPES`` by name."""
    return shape if isinstance(shape, Shape) else SHAPES[shape]


def cell_is_applicable(cfg: ModelConfig,
                       shape_name: str | Shape) -> tuple[bool, str]:
    shape = _shape(shape_name)
    shape_name = shape.name
    encoder_only = all(not s.causal for s in cfg.segments)
    if encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k needs sub-quadratic attention (skip for full-attention archs)"
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str | Shape,
                batch_override: int | None = None) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    shape = _shape(shape_name)
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def sds(size, dtype):
        return torch.empty(size, dtype=dtype, device="meta")
    if shape.kind in ("train", "prefill"):
        out = {}
        if cfg.frame_input:
            out["frames"] = sds((B, S, cfg.d_model), dt)
        else:
            out["tokens"] = sds((B, S), i32)
        if shape.kind == "train":
            out["labels"] = sds((B, S), i32)
        if cfg.n_image_tokens:
            out["image_embeds"] = sds((B, cfg.n_image_tokens, cfg.d_model), dt)
        return out
    # decode: one new token with a cache of seq_len
    out = {"tokens": sds((B, 1), i32)}
    return out

"""Assigned architectures (exact configs from the task pool) + reductions.

A copy of the JAX package's ``configs/registry.py``: every entry and
``reduce_config``, with the same values.  Every entry is selectable via
``--arch <id>`` in the launchers; the port's model serves the dense,
hybrid and mamba ones (``models/model.py``).
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, Segment

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------
# LM-family transformers (10 archs)
# --------------------------------------------------------------------------

# [audio] encoder-only, wav2vec2/HuBERT arch [arXiv:2106.07447]
register(ModelConfig(
    name="hubert-xlarge", family="audio",
    d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504,
    segments=(Segment("dense", 48, attn="gqa", causal=False),),
    frame_input=True, rope_theta=1e4,
))

# [dense] llama-arch GQA [arXiv:2403.04652]
register(ModelConfig(
    name="yi-34b", family="dense",
    d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
    segments=(Segment("dense", 60),),
    rope_theta=5e6,
))

# [dense] llama-arch [arXiv:2401.14196]
register(ModelConfig(
    name="deepseek-coder-33b", family="dense",
    d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256,
    segments=(Segment("dense", 62),),
    rope_theta=1e5,
))

# [dense] llama-arch small [hf:HuggingFaceTB/SmolLM-135M]
register(ModelConfig(
    name="smollm-135m", family="dense",
    d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152,
    segments=(Segment("dense", 30),),
    tie_embeddings=True,
    strategy="dp_seq",   # tiny model: batch+sequence parallel, replicated params
))

# [dense] llama-arch MHA [arXiv:2401.02954]
register(ModelConfig(
    name="deepseek-7b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008, vocab=102400,
    segments=(Segment("dense", 30),),
))

# [moe] 64 experts top-8, expert d_ff=1024, no shared [arXiv:2409.02060]
register(ModelConfig(
    name="olmoe-1b-7b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    segments=(Segment("moe", 16),),
    n_experts=64, top_k=8, moe_d_ff=1024, n_shared_experts=0,
))

# [moe] MLA + 1 shared + 256 routed top-8 + MTP [arXiv:2412.19437]
# assigned d_ff=2048 is the routed-expert dim; the first 3 layers are dense
# with d_ff=18432 as in the released model.
register(ModelConfig(
    name="deepseek-v3-671b", family="moe",
    d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280,
    segments=(Segment("dense", 3, attn="mla"),
              Segment("moe", 58, attn="mla")),
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mtp_depth=1, mtp_loss_weight=0.1,
))

# [vlm] cross-attn image layers every 5th layer (8 of 40)
# [hf:meta-llama/Llama-3.2-11B-Vision]; vision frontend is a STUB
# (precomputed patch embeddings from input_specs).
register(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
    segments=(Segment("vision_group", 8, sub_layers=5, cross_attn=True),),
    n_image_tokens=1024, rope_theta=5e5,
))

# [ssm] mamba1, attn-free [arXiv:2410.05355]
register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024,
    segments=(Segment("mamba", 64, attn="none"),),
    ssm_state=16, d_conv=4, ssm_expand=2,
))

# [hybrid] parallel attn+mamba heads [arXiv:2411.13676]; SWA 1024 with
# full-attention first/middle/last layers (Hymba's global/local pattern);
# meta tokens not modeled (DESIGN.md §4).
register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
    segments=(Segment("hybrid", 1, sliding_window=0),
              Segment("hybrid", 15, sliding_window=1024),
              Segment("hybrid", 1, sliding_window=0),
              Segment("hybrid", 14, sliding_window=1024),
              Segment("hybrid", 1, sliding_window=0)),
    ssm_state=16, d_conv=4, ssm_expand=2,
))


# --------------------------------------------------------------------------
# Reductions for CPU smoke tests
# --------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig, layers_per_segment: int = 1) -> ModelConfig:
    """Small same-family config: few layers, narrow dims, tiny vocab."""
    heads = max(2, min(4, cfg.n_heads)) if cfg.n_heads else 0
    kv = heads if cfg.n_kv_heads == cfg.n_heads else max(1, heads // 2)
    if cfg.n_heads == 0:
        heads = kv = 0
    segs = tuple(dataclasses.replace(
        s, n_layers=min(s.n_layers, layers_per_segment),
        sliding_window=min(s.sliding_window, 16) if s.sliding_window else 0,
        sub_layers=min(s.sub_layers, 3)) for s in cfg.segments)
    return cfg.with_(
        d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=96 if cfg.d_ff else 0, vocab=128, segments=segs,
        n_experts=8 if cfg.n_experts else 0,
        top_k=2 if cfg.n_experts else 0,
        moe_d_ff=32 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        q_lora_rank=24 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=4 if cfg.ssm_state else 0,
        dt_rank=8 if cfg.ssm_state else 0,
        n_image_tokens=8 if cfg.n_image_tokens else 0,
        mtp_depth=min(cfg.mtp_depth, 1),
        remat="none",
    )

"""Unified model configuration covering all assigned architectures.

A copy of the JAX package's ``models/config.py``, kept apart so that the
port imports nothing of that package.  A model is a list of *segments*;
each segment is a homogeneous stack of layers (in the port, one module per
layer, run in a Python loop).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # 'dense' | 'moe' | 'mamba' | 'hybrid' | 'vision_group'
    n_layers: int      # number of (stacked, scanned) layers in this segment
    # attention flavour inside the segment
    attn: str = "gqa"  # 'gqa' | 'mla' | 'none'
    causal: bool = True
    sliding_window: int = 0      # 0 = full attention
    cross_attn: bool = False     # vision_group: 1 cross + (sub_layers-1) self
    sub_layers: int = 1          # for vision_group: layers per scanned block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: tuple[Segment, ...]
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    router_aux_coef: float = 0.01

    # --- MLA (deepseek-v3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = True  # absorbed-weight decode (latent-space attention)

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    d_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)

    # --- multimodal stubs ---
    frame_input: bool = False    # audio: inputs are (B,S,d_model) embeddings
    n_image_tokens: int = 0      # vlm: stub patch embeddings (B,N,d_model)

    # --- multi-token prediction (deepseek-v3) ---
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.1

    # --- parallelism / perf knobs ---
    strategy: str = "tp"         # 'tp' | 'dp_seq' | 'tp+ep_data'
    n_heads_padded: int = 0      # pad q heads per kv group so H divides tp
    remat: str = "full"          # 'none' | 'full' | 'dots'
    zero_opt_state: bool = False # shard Adam moments over the data axis too
    # under a mesh, each model rank holds its block of the residual stream's
    # sequence between sub-layers: the tp families gather their input and
    # reduce-scatter their output (models.model, parallel.sharding.seq_split)
    seq_shard_activations: bool = False

    # expert placement plan (paper technique); set via with_placement()
    expert_placement: tuple | None = None  # tuple of tuples: replicas per expert

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers * s.sub_layers for s in self.segments)

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ counting
    def param_count(self) -> int:
        """Exact parameter count (used for MODEL_FLOPS = 6*N*D)."""
        D, V = self.d_model, self.vocab
        total = V * D  # embed
        if not self.tie_embeddings:
            total += D * V  # head
        total += D  # final norm
        for seg in self.segments:
            total += seg.n_layers * self._layer_params(seg)
        if self.mtp_depth:
            total += self.mtp_depth * (2 * D * D + self._layer_params(
                Segment("dense", 1)) + D)
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k)."""
        if not self.n_experts:
            return self.param_count()
        D = self.d_model
        dead_per_layer = (self.n_experts - self.top_k) * 3 * D * self.moe_d_ff
        n_moe_layers = sum(s.n_layers for s in self.segments if s.kind == "moe")
        return self.param_count() - n_moe_layers * dead_per_layer

    def _attn_params(self, attn: str) -> int:
        D = self.d_model
        if attn == "none":
            return 0
        if attn == "mla":
            qk_hd = self.qk_nope_head_dim + self.qk_rope_head_dim
            p = D * self.q_lora_rank + self.q_lora_rank  # wq_a + norm
            p += self.q_lora_rank * self.n_heads * qk_hd  # wq_b
            p += D * (self.kv_lora_rank + self.qk_rope_head_dim)  # wkv_a
            p += self.kv_lora_rank  # norm
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim
                                                     + self.v_head_dim)  # wkv_b
            p += self.n_heads * self.v_head_dim * D  # wo
            return p
        hd = self.hd
        return (D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                + self.n_heads * hd * D)

    def _mamba_params(self) -> int:
        D, di, st = self.d_model, self.d_inner, self.ssm_state
        r = self.dt_rank_
        return (D * 2 * di + di * self.d_conv + di * st + di  # in,conv,A,D
                + di * (r + 2 * st) + r * di + di * D)        # x_proj,dt,out

    def _layer_params(self, seg: Segment) -> int:
        D = self.d_model
        p = 2 * D  # two norms
        if seg.kind == "mamba":
            return D + self._mamba_params()  # single norm + mixer
        if seg.kind == "hybrid":
            p += self._attn_params(seg.attn) + self._mamba_params()
        elif seg.kind == "vision_group":
            # one cross-attn layer + (sub_layers-1) self-attn layers
            cross = (2 * D + self._attn_params("gqa") + 1  # gate
                     + 2 * D + 3 * D * self.d_ff)
            self_l = 2 * D + self._attn_params(seg.attn) + 3 * D * self.d_ff
            return cross + (seg.sub_layers - 1) * self_l
        else:
            p += self._attn_params(seg.attn)
        if seg.kind == "moe":
            p += D * self.n_experts  # router
            p += self.n_experts * 3 * D * self.moe_d_ff
            p += self.n_shared_experts * 3 * D * self.moe_d_ff
        elif seg.kind in ("dense", "hybrid"):
            p += 3 * D * self.d_ff if self.d_ff else 0
        return p

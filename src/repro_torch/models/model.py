"""The serving model: dense GQA decoders, Mamba-1, the parallel
attention + SSM hybrid, MoE decoders, MLA + MoE with multi-token
prediction (deepseek-v3) and cross-attention vision groups
(llama-3.2-vision), with the JAX package's ``Model`` semantics.

``forward`` and ``logits_fn`` run the full sequence; ``init_cache``,
``prefill`` and ``decode_step`` serve.  Parameters live in one submodule
per layer (``segments.<i>.<j>.<group>.<name>``, an ``nn.ModuleList`` per
segment): the JAX package's stacked scan over layers is a Python loop
here.  A vision group (segment kind ``vision_group``) holds ``cross``
(the cross-attention sub-layer: norms, the f32 scalar ``gate``,
``cross_w{q,k,v,o}`` and its MLP) and ``self``, one submodule per
self-attention sub-layer (``segments.<i>.<j>.self.<k>.attn.wq``).
``convert.model_state_from_jax`` unstacks a JAX parameter pytree into this
layout.  Parameters are initialized from an explicit
``torch.Generator`` with the JAX package's shapes, dtypes and constants
(the random numbers differ: a test hands both packages the same weights
through the converter).  Parameters do not require grad: serving never
takes a gradient, and training (``train.step``) turns them on.

Caches are, per segment, a list of per-layer dicts: ``k``/``v`` (B, L,
KV, hd) for GQA attention, ``ckv`` (B, L, kv_lora_rank) and ``kr`` (B, L,
rope head dim) for MLA, and ``mamba`` = {``conv``: (B, d_conv-1, di),
``ssm``: (B, di, N) f32} for the SSM mixer; a vision group's is
{``cross``: {``ck``, ``cv``} (B, N, KV, hd), the image keys and values,
``self``: one linear ``k``/``v`` cache per sub-layer}.  The image
embeddings (``batch["image_embeds"]``, (B, N, D), cast to the model dtype)
enter ``forward`` and ``prefill``; decode reads their cached keys and
values.  A sliding window's ``k``/``v`` is a ring (``models.layers``).
``decode_step`` writes the caches in place, at a position held on the
device, so that one step can be captured in a CUDA graph and replayed
(``launch.serve.GreedyStep``).  The head of a bf16 model multiplies as
the JAX package's does, bf16 by bf16 into f32, in the loss and in serving
alike (``logits_fn``, ``_HeadProduct``).

The multi-token prediction module (``mtp``, one entry per depth: ``proj``,
``ln`` and a one-layer dense ``block`` with the last segment's attention)
has the JAX package's weights and ``_mtp_loss``; serving does not run it,
``loss`` does.

``loss`` is the JAX package's training loss.  Where a gradient is taken,
``cfg.remat`` recomputes each layer in the backward pass as the JAX
package's ``jax.checkpoint`` does: ``"full"`` saves only the layer's input
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` also the outputs
of its matrix products (selective checkpointing), ``"none"`` keeps every
activation.

MoE layers route through the model's ``PlacementPlan`` (default: the
round robin over ``n_ep_shards`` shards).  The FFN's ``mode`` follows the
JAX package's serve path on a mesh: ``prefill`` and ``forward`` run the
a2a slot path, ``decode_step`` the tp slot path, and ``route_trace`` the
dense reference (``models.moe``).

Under a mesh (``parallel.sharding.set_active_mesh``, before the model is
built) the model is one rank's part of the whole, in explicit SPMD.  The
weights are drawn whole, as on one device, and each leaf that
``parallel.sharding.held_specs`` shards (``param_spec``'s rules, the
Mamba mixer's leaves as channel blocks) keeps only this rank's block.
Each family of a layer then takes the route
``parallel.sharding.tp_split`` gives it on the model axis, from the
config alone:

* ``tp``: its products run on the blocks as held (``Params.tp_blocks``):
  the attention on the rank's heads, the MLP and the Mamba mixer on its
  channels (the mixer's ``in_proj`` and ``conv_w`` in the port's own
  channel blocks, ``parallel.sharding.held_specs``), each output summed by
  one psum over 'model'; the embedding looks up the rank's
  vocabulary rows (``_vocab_embed``), the head gives the rank's vocabulary
  slice of the logits, and the cross-entropy is vocab-parallel
  (``_xent``).  No weight moves between ranks;
* ``gathered``: reading a leaf (``Params[name]``, ``Model._w``) gathers
  its blocks through an autograd Function (an ``all_gather``, whose
  backward is a ``reduce_scatter``), where a layer uses it, again under
  remat: the MoE router, and any family whose heads (or channels) the
  axis does not divide.

Serving gathers the dense leaves once (``gather_dense_``, which also
drops the ``tp`` routes: the reference serves with whole parameters) and
keeps of the experts only this rank's slots (``place_slots_``);
``prefill`` and ``decode_step`` refuse a model still split for training.

The residual stream stays whole on every rank of the model axis (the MoE
layers split the sequence inside, ``moe_a2a``), except under a sequence
split (``parallel.sharding.seq_split_of``), where each rank holds its
block of the positions between the sub-layers and each family runs on it
by its route (``parallel.sharding.seq_split``: ``seq``, ``token`` or
``gathered``):

* ``dp_seq``: the batch holds the rank's block already
  (``train.step.TrainStep.local_batch``, which also hands it its labels
  with the next block's first label, and ``batch["seq_split"]``).  The
  GQA layers attend from the block to the keys and values gathered over
  the sequence; the other families that mix positions gather their
  input.  The loss is each rank's sum of cross-entropy terms, added over
  the model axis and divided by the global count of terms;
* ``seq_shard_activations`` (with the weights' ``tp`` routes): the
  sequence is whole at the input; the embedding reduce-scatters it into
  the blocks, every ``tp`` family gathers its input over the sequence and
  reduce-scatters its output (in place of the psum), the per-token ones
  run on the block, and ``forward`` gathers the stream again before the
  head, as the reference's ``_constrain_residual`` lays it out.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from . import layers as L
from .config import ModelConfig, Segment
from ..parallel import sharding as shd
from .moe import (PlacementPlan, materialize_slots, moe_apply,
                  round_robin_plan, router_topk)

_KINDS = ("dense", "hybrid", "mamba", "moe", "vision_group")


def _check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a segment kind the JAX model does not
    have."""
    for seg in cfg.segments:
        if seg.kind not in _KINDS:
            raise ValueError(f"unknown segment kind {seg.kind!r}")


def _self_segment(seg: Segment) -> Segment:
    """The segment of a vision group's self-attention sub-layers: dense
    layers with the group's attention and mask."""
    return dataclasses.replace(seg, kind="dense", n_layers=1, sub_layers=1,
                               cross_attn=False)


class Params(nn.Module):
    """One group of parameters, indexed by name like the JAX pytree's
    dicts; a nested dict becomes a child group, a list of dicts an
    ``nn.ModuleList`` of them."""

    def __init__(self, tensors: dict):
        super().__init__()
        self._shardings = {}   # name -> parallel.sharding.Sharding
        for name, t in tensors.items():
            if isinstance(t, dict):
                self.add_module(name, Params(t))
            elif isinstance(t, list):
                self.add_module(name, nn.ModuleList(Params(x) for x in t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        """The named leaf, whole (its blocks gathered under a mesh), or
        the named child group."""
        t = getattr(self, name)
        sh = self._shardings.get(name)
        return t if sh is None else sh.full(t)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def held(self, name: str):
        """The named leaf as this rank holds it, and its ``Sharding`` (None
        where whole)."""
        return getattr(self, name), self._shardings.get(name)

    def tp_block(self, name: str, dim: int) -> torch.Tensor:
        """The named leaf as this rank's block over 'model' on ``dim``
        (raises where it is held otherwise)."""
        return _tp_block(name, *self.held(name), dim)

    def tp_blocks(self, dims: dict) -> dict:
        """Every leaf of this group as this rank holds it: those of
        ``dims`` ({name: dim}) as their blocks (``tp_block``), the others
        whole (raises where one is split)."""
        out = {}
        for name in self._parameters:
            if name in dims:
                out[name] = self.tp_block(name, dims[name])
            elif self._shardings.get(name) is not None:
                raise RuntimeError(f"{name} is split, but the products of "
                                   f"its family do not read it so")
            else:
                out[name] = getattr(self, name)
        return out


def _tp_block(name: str, t: torch.Tensor, sh, dim: int) -> torch.Tensor:
    """``t`` (leaf ``name``, held with ``Sharding`` ``sh``), which a
    tensor-parallel product reads as this rank's block over 'model' on
    ``dim``: raises where it is held otherwise."""
    if sh is None or sh.spec != shd.tp_spec(t.dim(), dim,
                                            shd.TP_GROUPS.get(name, 1)):
        raise RuntimeError(f"{name}: a tensor-parallel product needs its "
                           f"block over 'model' on dim {dim}; held as "
                           f"{None if sh is None else sh.spec}")
    return t


class _Init:
    """Draws a model's weights from one generator, in a fixed order, with
    the JAX package's ``_init``: normal / sqrt(fan-in) in f32, then cast."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 dtype: torch.dtype):
        self.cfg, self.gen, self.device, self.dtype = cfg, gen, device, dtype

    def normal(self, shape, scale_dim, dtype=None) -> torch.Tensor:
        # scaled in place: one f32 draw beside the cast, not two (an
        # expert tensor of deepseek-v3 is 15 GB in f32)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return x.mul_(scale_dim ** -0.5).to(dtype or self.dtype)

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, dtype=torch.float32, device=self.device)

    def zeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=self.dtype, device=self.device)

    def attn(self, kind: str = "gqa") -> dict:
        cfg = self.cfg
        D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
        if kind == "mla":
            qr, kvr, nope, rp, vh = L._mla_dims(cfg)
            H = cfg.n_heads
            return {"wq_a": self.normal((D, qr), D),
                    "q_ln": self.ones(qr),
                    "wq_b": self.normal((qr, H * (nope + rp)), qr),
                    "wkv_a": self.normal((D, kvr + rp), D),
                    "kv_ln": self.ones(kvr),
                    "wkv_b": self.normal((kvr, H * (nope + vh)), kvr),
                    "mla_wo": self.normal((H * vh, D), H * vh)}
        Hp = L.n_q_heads(cfg)
        return {"wq": self.normal((D, Hp * hd), D),
                "wk": self.normal((D, KV * hd), D),
                "wv": self.normal((D, KV * hd), D),
                "wo": self.normal((Hp * hd, D), Hp * hd)}

    def mlp(self, d_ff: int) -> dict:
        D = self.cfg.d_model
        return {"w_gate": self.normal((D, d_ff), D),
                "w_up": self.normal((D, d_ff), D),
                "w_down": self.normal((d_ff, D), d_ff)}

    def mamba(self) -> dict:
        cfg = self.cfg
        D, di, N, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        A = torch.arange(1, N + 1, dtype=torch.float32,
                         device=self.device).expand(di, N)
        return {"in_proj": self.normal((D, 2 * di), D),
                "conv_w": self.normal((cfg.d_conv, di), cfg.d_conv),
                "conv_b": self.zeros(di),
                "A_log": torch.log(A).contiguous(),
                "ssm_D": self.ones(di),
                "x_proj": self.normal((di, r + 2 * N), di),
                "dt_proj": self.normal((r, di), r),
                "dt_bias": self.zeros(di),
                "out_proj": self.normal((di, D), di)}

    def moe(self) -> dict:
        cfg = self.cfg
        D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        out = {"router": self.normal((D, E), D, torch.float32),
               "e_gate": self.normal((E, D, F_), D),
               "e_up": self.normal((E, D, F_), D),
               "e_down": self.normal((E, F_, D), F_)}
        if cfg.n_shared_experts:
            out.update(self.mlp(cfg.n_shared_experts * F_))
        return out

    def cross(self) -> dict:
        """A vision group's cross-attention sub-layer; its gate is an f32
        zero, so a fresh model's cross-attention adds nothing."""
        cfg = self.cfg
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        return {"ln1": self.ones(D), "ln2": self.ones(D),
                "gate": torch.zeros((), dtype=torch.float32,
                                    device=self.device),
                "cross_wq": self.normal((D, H * hd), D),
                "cross_wk": self.normal((D, KV * hd), D),
                "cross_wv": self.normal((D, KV * hd), D),
                "cross_wo": self.normal((H * hd, D), H * hd),
                "mlp": self.mlp(cfg.d_ff)}

    def layer(self, seg: Segment) -> dict:
        D = self.cfg.d_model
        if seg.kind == "mamba":
            return {"ln1": self.ones(D), "mamba": self.mamba()}
        if seg.kind == "vision_group":    # no norms of its own
            sub = _self_segment(seg)
            return {"cross": self.cross(),
                    "self": [self.layer(sub)
                             for _ in range(seg.sub_layers - 1)]}
        p = {"ln1": self.ones(D), "ln2": self.ones(D),
             "attn": self.attn(seg.attn)}
        if seg.kind == "hybrid":
            p["mamba"] = self.mamba()
        if seg.kind == "moe":
            p["moe"] = self.moe()
        else:
            p["mlp"] = self.mlp(self.cfg.d_ff)
        return p

    def mtp(self) -> dict:
        """One depth of multi-token prediction: the JAX package's
        ``_init_mtp``."""
        D = self.cfg.d_model
        return {"proj": self.normal((2 * D, D), 2 * D), "ln": self.ones(D),
                "block": self.layer(_mtp_segment(self.cfg))}


def _mtp_segment(cfg: ModelConfig) -> Segment:
    """The segment of an MTP block: one dense layer with the last
    segment's attention."""
    return Segment("dense", 1, attn=cfg.segments[-1].attn)


# the outputs ``remat="dots"`` saves: the matrix products'
# (jax.checkpoint_policies.checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 (or f16) matrices, accumulated and returned
    in f32: ``torch.mm``'s ``out_dtype`` off the CPU (no f32 copy of
    either operand), the same values upcast on the CPU, which has no such
    product.  Products of bf16 values are exact in f32, so the two differ
    only in the order of the sums."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class _HeadProduct(torch.autograd.Function):
    """The head of a bf16 (or f16) model, x (T, D) @ head (D, V) -> f32
    logits, as the JAX package multiplies it: ``jnp.einsum(...,
    preferred_element_type=jnp.float32)`` of the model's own dtypes.

    The backward follows what JAX does with that einsum.  Its transpose
    rule (``_dot_general_transpose_lhs`` and ``_rhs`` in
    ``jax/_src/lax/lax.py``) multiplies the f32 cotangent by the other,
    bf16 operand into f32 and casts the result to the operand's dtype;
    at default precision the TPU multiplies f32 operands in one bf16
    pass, so the cotangent enters that product rounded to bf16.  Here the
    cotangent from the cross-entropy is rounded to the model's dtype once,
    dX = dL · headᵀ and dHead = xᵀ · dL are bf16 products accumulated in
    f32 (``_mm_f32``), and each is cast to its operand's dtype.  Against
    the f32 product that an f32 copy of the head would give, the one
    difference that is not the order of sums is that rounding of the
    cotangent.  Nothing of the head is copied in f32: the saved tensors
    are x and the head themselves."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, head)
        return _mm_f32(x, head)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dhead = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, head.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dhead = _mm_f32(x.t(), g).to(head.dtype)
        return dx, dhead


def _xent(logits: torch.Tensor, targets: torch.Tensor,
          tp: str | None = None, total: bool = False) -> torch.Tensor:
    """The mean cross-entropy of ``logits`` (f32) against ``targets``
    (``total``: the sum of its terms; without ``tp``).  Under ``tp`` the
    logits are this rank's slice of the vocabulary: the log-sum-exp and
    the target's logit come from two all-reduces over ``tp`` (the max,
    which takes no gradient, then the exps' sum and the target's shifted
    logit in one psum).  On an axis of one rank the slice is the whole
    vocabulary, and this is the plain cross-entropy."""
    if tp is None or shd.axis_size(tp) == 1:
        logp = torch.log_softmax(logits.float(), dim=-1)
        terms = -logp.gather(-1, targets[..., None].long())[..., 0]
        return terms.sum() if total else terms.mean()
    V = logits.shape[-1]
    t = targets.long() - shd.axis_index(tp) * V
    mine = (t >= 0) & (t < V)
    z = logits.float() - shd.pmax(logits.amax(dim=-1, keepdim=True), tp)
    zt = z.gather(-1, t.clamp(0, V - 1)[..., None])[..., 0]
    sums = shd.psum(torch.stack([z.exp().sum(dim=-1),
                                 torch.where(mine, zt, 0.0)]), tp)
    return (torch.log(sums[0]) - sums[1]).mean()


def _vocab_embed(tokens: torch.Tensor, rows: torch.Tensor,
                 tp: str, scatter: bool = False) -> torch.Tensor:
    """The embedding of ``tokens`` from this rank's block of vocabulary
    rows: the tokens of other ranks' rows come out as zeros, and a psum
    over ``tp`` puts every token's row together (``scatter``: a
    reduce_scatter along the sequence, each rank its block of it)."""
    V = rows.shape[0]
    t = tokens - shd.axis_index(tp) * V
    mine = ((t >= 0) & (t < V))[..., None]
    x = torch.where(mine, F.embedding(t.clamp(0, V - 1), rows), 0)
    return shd.reduce_scatter(x, tp, 1) if scatter else shd.psum(x, tp)


def causal_lm(cfg: ModelConfig) -> bool:
    """The loss pairs position t's logits with label t + 1 (a causal
    token model); else each position with its own label (frames, or
    attention that is not causal)."""
    return not cfg.frame_input and all(s.causal for s in cfg.segments)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, plan: PlacementPlan | None = None,
                 *, n_ep_shards: int = 1, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        """``generator`` draws every weight, on ``device`` (default: seed 0
        there); a CUDA ``device`` raises without a CUDA device.  On the
        meta device (the dry run) the draws allocate nothing and take no
        generator (the meta device has none).  ``plan`` places the experts
        (default: ``round_robin_plan(E, n_ep_shards)``); under a mesh it
        has one shard per rank of the model axis.  Under the active mesh
        each leaf keeps this rank's block."""
        super().__init__()
        _check_supported(cfg)
        self._shardings = {}
        self.plan = plan
        if cfg.n_experts and plan is None:
            self.plan = round_robin_plan(cfg.n_experts, n_ep_shards)
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Model on device 'cuda', but no CUDA device is available; "
                "pass device='cpu' for the plain PyTorch versions")
        self.cfg = cfg
        self.device = dev
        self.dtype = getattr(torch, cfg.dtype)
        gen = generator
        if gen is None and dev.type != "meta":
            gen = torch.Generator(device=dev).manual_seed(0)
        ini = _Init(cfg, gen, dev, self.dtype)
        D, V = cfg.d_model, cfg.vocab
        self.embed = nn.Parameter(ini.normal((V, D), D), requires_grad=False)
        self.final_ln = nn.Parameter(ini.ones(D), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(ini.normal((D, V), D),
                                        requires_grad=False)
        self.segments = nn.ModuleList(
            nn.ModuleList(Params(ini.layer(seg)) for _ in range(seg.n_layers))
            for seg in cfg.segments)
        if cfg.mtp_depth:
            self.mtp = nn.ModuleList(Params(ini.mtp())
                                     for _ in range(cfg.mtp_depth))
        self.mesh = shd.active_mesh()
        # the model axis the families are routed over (tp_split), None
        # without one or once gather_dense_ holds the leaves whole
        self._n_model = None
        if self.mesh is not None:
            self._shard(self.mesh)

    # ------------------------------------------------------------ sharding
    def _shard(self, mesh) -> None:
        """Keep of each leaf that ``held_specs`` shards this rank's block,
        and note its ``Sharding`` where the leaf is read."""
        n_model = shd.axis_sizes(mesh).get("model", 1)
        if self.plan is not None and self.plan.n_shards != n_model:
            raise ValueError(f"a plan over {self.plan.n_shards} shards on "
                             f"a model axis of {n_model} rank(s)")
        shardings = shd.tree_shardings(dict(self.named_parameters()), mesh,
                                       self.cfg)
        for prefix, mod in self.named_modules():
            for name, prm in mod.named_parameters(recurse=False):
                sh = shardings[f"{prefix}.{name}" if prefix else name]
                if sh.axes():
                    prm.data = sh.local(prm.data).clone()
                    mod._shardings[name] = sh
        if "model" in mesh.mesh_dim_names:
            self._n_model = n_model

    def _route(self, seg: Segment | None, family: str) -> str | None:
        """The axis ('model') that ``family`` of ``seg`` (None: the
        embedding and head) runs its products over (``tp_split``), or None
        where it reads its leaves whole."""
        if self._n_model is None:
            return None
        route = shd.tp_split(self.cfg, seg, self._n_model)[family]
        return "model" if route == "tp" else None

    def _tp(self, seg: Segment | None, family: str) -> str | None:
        """``_route``, counted in ``parallel.sharding.tp_route_launches``
        under a mesh."""
        tp = self._route(seg, family)
        if self._n_model is not None:
            shd.count_tp_route(family, "tp" if tp else "gathered")
        return tp

    def _seq(self, batch: dict) -> "shd.SeqSplit | None":
        """The sequence split of a forward on ``batch``: under ``dp_seq``
        the one ``local_batch`` cut the batch by (``batch["seq_split"]``),
        under ``seq_shard_activations`` that of the input's length
        (``seq_split_of``); None without one, and always when serving."""
        if self._n_model is None:
            return None
        if self.cfg.strategy == "dp_seq":
            return batch.get("seq_split")
        x = batch["frames" if self.cfg.frame_input else "tokens"]
        return shd.seq_split_of(self.cfg, x.shape[1], self.mesh)

    def _seq_route(self, seg: Segment | None, family: str,
                   seq: "shd.SeqSplit | None") -> str | None:
        """``family``'s route on the split sequence ``seq``
        (``parallel.sharding.seq_split``), counted in
        ``seq_route_launches``; None without a split."""
        if seq is None:
            return None
        route = shd.seq_split(self.cfg, seg, self._n_model)[family]
        shd.count_seq_route(family, route)
        return route

    @staticmethod
    def _whole(seq: "shd.SeqSplit | None", tp: str | None, fn,
               h: torch.Tensor) -> torch.Tensor:
        """``fn(h, scatter)`` on the whole sequence (route ``gathered``):
        under ``seq`` the block ``h`` is gathered over the sequence first
        and the rank keeps its block of the output -- a ``tp`` family's by
        the reduce_scatter that ``scatter`` asks for, another's as a view."""
        if seq is None:
            return fn(h, False)
        out = fn(seq.gather(h), tp is not None)
        return out if tp is not None else seq.local(out)

    @staticmethod
    def _weights(p: "Params", family: str, tp: str | None):
        """A family's leaves: the blocks as held where ``tp``, else ``p``
        (whose reads gather)."""
        return p if tp is None else p.tp_blocks(shd.TP_DIMS[family])

    def shardings(self) -> dict:
        """{parameter name: its ``Sharding``, or None where whole}."""
        out = {}
        for prefix, mod in self.named_modules():
            for name, _ in mod.named_parameters(recurse=False):
                path = f"{prefix}.{name}" if prefix else name
                out[path] = getattr(mod, "_shardings", {}).get(name)
        return out

    def _w(self, name: str) -> torch.Tensor:
        """A top-level leaf (``embed``, ``lm_head``), whole."""
        t = getattr(self, name)
        sh = self._shardings.get(name)
        return t if sh is None else sh.full(t)

    @torch.no_grad()
    def gather_dense_(self) -> None:
        """Serving under a mesh: hold every leaf but the experts' whole,
        gathered once here instead of at every read."""
        for mod in self.modules():
            for name, sh in list(getattr(mod, "_shardings", {}).items()):
                if name not in ("e_gate", "e_up", "e_down"):
                    prm = getattr(mod, name)
                    prm.data = sh.full(prm.data)
                    del mod._shardings[name]
        self._n_model = None

    @torch.no_grad()
    def place_slots_(self, plan: PlacementPlan) -> None:
        """Serving: adopt ``plan`` and keep of each MoE layer's experts
        only this rank's slot weights (``e_*_slots``), gathered once per
        layer; the logical expert leaves go."""
        self.plan = plan
        for seg, layers in zip(self.cfg.segments, self.segments):
            if seg.kind != "moe":
                continue
            for lp in layers:
                mp = lp["moe"]
                slots = materialize_slots(mp, plan)
                for name in ("e_gate", "e_up", "e_down"):
                    t = slots[f"{name}_slots"]
                    del mp._parameters[name]
                    mp._shardings.pop(name, None)
                    mp.register_parameter(f"{name}_slots", nn.Parameter(
                        t.contiguous(), requires_grad=False))

    # ------------------------------------------------------------ forward
    def _mixer(self, lp, x: torch.Tensor, seg: Segment,
               seq: "shd.SeqSplit | None" = None) -> torch.Tensor:
        """Attention and/or SSM part of one layer (full sequence, or the
        rank's block of a split one)."""
        cfg = self.cfg
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        parts = []
        if seg.attn in ("mla", "gqa"):
            tp = self._tp(seg, seg.attn)
            w = self._weights(lp["attn"], seg.attn, tp)
            if self._seq_route(seg, seg.attn, seq) == "seq":
                parts.append(L.gqa_attention(w, h, cfg, seg, seq=seq))
            else:
                attend = (L.mla_attention if seg.attn == "mla"
                          else L.gqa_attention)
                parts.append(self._whole(seq, tp, lambda hh, sc: attend(
                    w, hh, cfg, seg, tp, scatter=sc), h))
        if seg.kind in ("mamba", "hybrid"):
            parts.append(self._mamba(lp, h, seg, seq))
        out = parts[0]
        for extra in parts[1:]:
            out = out + extra
        return out

    def _mamba(self, lp, h: torch.Tensor, seg: Segment,
               seq: "shd.SeqSplit | None") -> torch.Tensor:
        """The Mamba mixer: on the rank's channel blocks where its route is
        ``tp`` (its output summed over 'model', or under ``seq``
        reduce-scattered along the sequence), else on its leaves read
        whole."""
        tp = self._tp(seg, "mamba")
        self._seq_route(seg, "mamba", seq)
        w = self._weights(lp["mamba"], "mamba", tp)
        return self._whole(seq, tp, lambda hh, sc: L.mamba_mixer(
            w, hh, self.cfg, tp=tp, scatter=sc)[0], h)

    def _ffn(self, lp, x: torch.Tensor, seg: Segment, mode: str,
             seq: "shd.SeqSplit | None" = None):
        """The FFN part of one layer and its aux loss (None but for MoE)."""
        h = L.rmsnorm(x, lp["ln2"], self.cfg.norm_eps)
        if seg.kind == "moe":
            self._tp(seg, "router")
            tp = self._tp(seg, "mlp") if self.cfg.n_shared_experts else None
            if self._seq_route(seg, "moe", seq) is None:
                return moe_apply(lp["moe"], h, self.cfg, self.plan, mode, tp)
            y, aux = moe_apply(lp["moe"], seq.gather(h), self.cfg,
                               self.plan, mode, tp)
            return seq.local(y), aux
        return self._swiglu(lp["mlp"], h, seg, seq), None

    def _swiglu(self, p: "Params", h: torch.Tensor, seg: Segment,
                seq: "shd.SeqSplit | None" = None) -> torch.Tensor:
        tp = self._tp(seg, "mlp")
        w = self._weights(p, "mlp", tp)
        if self._seq_route(seg, "mlp", seq) == "gathered":
            return L.swiglu(w, seq.gather(h), tp, scatter=True)
        return L.swiglu(w, h, tp)

    def _block(self, lp, x: torch.Tensor, seg: Segment, mode: str,
               img: torch.Tensor | None = None,
               seq: "shd.SeqSplit | None" = None):
        """One layer, or one vision group (its cross sub-layer against the
        image embeddings ``img``, then its self sub-layers): (output, aux
        loss or None); under ``seq`` on the rank's block of the
        sequence."""
        if seg.kind == "mamba":
            h = L.rmsnorm(x, lp["ln1"], self.cfg.norm_eps)
            return x + self._mamba(lp, h, seg, seq), None
        if seg.kind == "vision_group":
            x = self._cross_block(lp["cross"], x, seg, img=img, seq=seq)
            sub = _self_segment(seg)
            for sp in lp["self"]:
                x, _ = self._block(sp, x, sub, mode, seq=seq)
            return x, None
        x = x + self._mixer(lp, x, seg, seq)
        y, aux = self._ffn(lp, x, seg, mode, seq)
        return x + y, aux

    def _cross_block(self, cp, x: torch.Tensor, seg: Segment, *,
                     img: torch.Tensor | None = None,
                     kv: tuple | None = None,
                     seq: "shd.SeqSplit | None" = None) -> torch.Tensor:
        """A vision group's (``seg``) cross-attention sub-layer against the
        image embeddings ``img``, or their keys and values ``kv``, then its
        MLP."""
        cfg = self.cfg
        h = L.rmsnorm(x, cp["ln1"], cfg.norm_eps)
        tp = self._tp(seg, "cross")
        w = self._weights(cp, "cross", tp)

        def attend(hh, scatter):
            if kv is None:
                return L.cross_attention(w, hh, img, cfg, tp, scatter)
            return L.cross_attend(w, hh, *kv, cfg, tp, scatter)
        if self._seq_route(seg, "cross", seq) == "gathered":
            x = x + attend(seq.gather(h), True)
        else:
            x = x + attend(h, False)
        return x + self._swiglu(cp["mlp"], L.rmsnorm(x, cp["ln2"],
                                                     cfg.norm_eps), seg, seq)

    def _embed_inputs(self, batch: dict,
                      seq: "shd.SeqSplit | None" = None) -> torch.Tensor:
        """The input embeddings: of the whole sequence, or under ``seq``
        of the rank's block (the batch's block under ``dp_seq``; cut from
        the whole input under ``seq_shard_activations``, a ``tp``
        embedding by its reduce_scatter)."""
        cut = seq is not None and self.cfg.strategy != "dp_seq"
        if self.cfg.frame_input:
            x = batch["frames"].to(self.dtype)
            return seq.local(x) if cut else x
        tokens = batch["tokens"]
        if self._seq_route(None, "embed", seq) == "gathered":
            return self._embed(tokens, scatter=True)
        return self._embed(seq.local(tokens) if cut else tokens)

    def _embed(self, tokens: torch.Tensor,
               scatter: bool = False) -> torch.Tensor:
        tp = self._tp(None, "embed")
        if tp is None:
            return F.embedding(tokens, self._w("embed"))
        return _vocab_embed(tokens, self._vocab_rows("embed"), tp, scatter)

    def _vocab_rows(self, name: str) -> torch.Tensor:
        """``embed`` or ``lm_head`` as this rank's block of the vocabulary."""
        family = "embed" if name == "embed" else "head"
        return _tp_block(name, getattr(self, name),
                         self._shardings.get(name), shd.TP_DIMS[family][name])

    def _image_embeds(self, batch: dict) -> torch.Tensor | None:
        img = batch.get("image_embeds")
        if img is None and self.cfg.n_image_tokens:
            raise ValueError(f"{self.cfg.name} attends to "
                             "batch['image_embeds'], (B, N, d_model)")
        return None if img is None else img.to(self.dtype)

    def logits_fn(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head, accumulated in f32 (B, S, V); where the
        head runs tensor-parallel, this rank's slice of the vocabulary
        (B, S, V / ranks), which ``_xent`` takes with its ``tp``.  An f32
        model multiplies f32 by f32; a bf16 or f16 model multiplies its
        own dtypes into f32 (``_HeadProduct``, in the loss, prefill and
        the decode step alike), as the JAX package's
        ``preferred_element_type`` does, with no f32 copy of the head."""
        x = L.rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        tie = self.cfg.tie_embeddings
        if self._tp(None, "head") is None:
            head = self._w("embed").T if tie else self._w("lm_head")
        else:
            head = (self._vocab_rows("embed").T if tie
                    else self._vocab_rows("lm_head"))
        if x.dtype == torch.float32:
            return x.float() @ head.float()
        B, S, D = x.shape
        return _HeadProduct.apply(x.reshape(B * S, D), head).reshape(B, S,
                                                                     -1)

    def forward(self, batch: dict, mode: str = "a2a"
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence hidden states (under ``dp_seq`` with a split
        sequence the rank's block of them) and the summed auxiliary (router
        load-balancing) loss of the MoE layers."""
        seq = self._seq(batch)
        x = self._embed_inputs(batch, seq)
        img = self._image_embeds(batch)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat != "none" and torch.is_grad_enabled()
        for seg, layers in zip(self.cfg.segments, self.segments):
            for lp in layers:
                if remat and any(p.requires_grad for p in lp.parameters()):
                    x, aux = self._remat_block(lp, x, seg, mode, img, seq)
                else:
                    x, aux = self._block(lp, x, seg, mode, img, seq)
                if aux is not None:
                    aux_total = aux_total + aux
        if seq is not None and self.cfg.strategy != "dp_seq":
            x = seq.gather(x)        # whole before the (vocab-parallel) head
        return x, aux_total

    def _remat_block(self, lp, x: torch.Tensor, seg: Segment, mode: str,
                     img: torch.Tensor | None,
                     seq: "shd.SeqSplit | None" = None):
        """``_block`` recomputed in the backward pass: all of it
        (``remat="full"``) or all but its matrix products (``"dots"``)."""
        kw = {}
        if self.cfg.remat == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        elif self.cfg.remat != "full":
            raise ValueError(f"unknown remat {self.cfg.remat!r}")
        return ckpt.checkpoint(self._block, lp, x, seg, mode, img, seq,
                               use_reentrant=False, preserve_rng_state=False,
                               **kw)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The JAX package's training loss: the mean next-token
        cross-entropy (f32; frame classification against ``labels`` as
        they stand for a frame-input or non-causal model), plus
        ``router_aux_coef`` times the MoE layers' load-balancing loss, plus
        ``mtp_loss_weight`` times the multi-token prediction loss.  Returns
        (total, metrics: ``ce``, ``aux``, ``mtp_ce`` with MTP, ``loss``).

        Under ``dp_seq`` with a split sequence the batch is the rank's
        block, its labels with the next block's first label
        (``TrainStep.local_batch``): the cross-entropy is the rank's sum of
        terms, added over the model axis and divided by the global count
        of terms, so that the loss (and each metric) is the one-device
        value on every rank."""
        cfg = self.cfg
        seq = self._seq(batch)
        x, aux = self.forward(batch, mode="a2a")
        logits = self.logits_fn(x)
        labels = batch["labels"]
        causal = causal_lm(cfg)
        tgt = labels[:, 1:] if causal else labels
        if self._seq_route(None, "head", seq) == "token":    # dp_seq's block
            n_terms = labels.shape[0] * (seq.length - int(causal))
            ce = shd.psum(_xent(logits[:, :tgt.shape[1]], tgt, total=True),
                          seq.axis) / n_terms
        else:
            ce = _xent(logits[:, :-1] if causal else logits, tgt,
                       self._route(None, "head"))
        total = ce + cfg.router_aux_coef * aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp_depth:
            mtp_ce = self._mtp_loss(x, batch, seq)
            total = total + cfg.mtp_loss_weight * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, x: torch.Tensor, batch: dict,
                  seq: "shd.SeqSplit | None" = None) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: each depth d predicts token
        t + 2 + d from (h_t, embed(token_{t+1+d})); the mean over depths of
        its cross-entropy (f32).  ``x``: the final hidden states of
        ``forward``.  On a split sequence (route ``gathered``) the block
        runs whole on every rank: under ``dp_seq`` the hidden states,
        tokens and labels are gathered over the sequence first."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        if self._seq_route(None, "mtp", seq) and \
                cfg.strategy == "dp_seq":
            x, tokens = seq.gather(x), seq.gather(tokens)
            labels = seq.gather(labels[:, :seq.block])
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        seg = _mtp_segment(cfg)
        h = x
        for d, mp in enumerate(self.mtp):
            nxt = self._embed(tokens[:, d + 1:])
            hcat = torch.cat([L.rmsnorm(h[:, :nxt.shape[1]], mp["ln"],
                                        cfg.norm_eps), nxt], dim=-1)
            hm, _ = self._block(mp["block"], hcat @ mp["proj"], seg, "a2a")
            lg = self.logits_fn(hm)
            total = total + _xent(lg[:, :-1], labels[:, d + 1:][:, 1:],
                                  self._route(None, "head"))
            h = hm
        return total / cfg.mtp_depth

    def route_trace(self, batch: dict) -> list:
        """Replay the forward pass (dense FFNs) collecting each MoE layer's
        router choices: one (L, T, top_k) int64 tensor per MoE segment, the
        placement planner's input.  As in the JAX package, the router sees
        the post-mixer hidden state and the mixer runs twice per layer."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        traces = []
        for seg, layers in zip(cfg.segments, self.segments):
            idxs = []
            for lp in layers:
                if seg.kind == "moe":
                    hh = L.rmsnorm(x + self._mixer(lp, x, seg), lp["ln2"],
                                   cfg.norm_eps)
                    idxs.append(router_topk(lp["moe"]["router"],
                                            hh.reshape(-1, cfg.d_model),
                                            cfg)[1])
                x, _ = self._block(lp, x, seg, "dense")
            if seg.kind == "moe":
                traces.append(torch.stack(idxs))
        return traces

    # -------------------------------------------------------------- serve
    def _whole_leaves(self) -> None:
        """Serving reads whole leaves and whole logits: raise where the
        model is still split for training (``tp`` routes)."""
        if self._n_model is not None:
            raise RuntimeError("serving under a mesh reads whole leaves: "
                               "call gather_dense_() first, as "
                               "launch.serve does")

    def init_cache(self, B: int, max_len: int) -> list:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        caches = []
        for seg in cfg.segments:
            def one():
                c: dict = {}
                if seg.kind == "vision_group":
                    shape = (B, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd)
                    c["cross"] = {n: torch.zeros(shape, dtype=dt, device=dev)
                                  for n in ("ck", "cv")}
                    c["self"] = [L.gqa_init_cache(cfg, seg, B, max_len, dt,
                                                  dev)
                                 for _ in range(seg.sub_layers - 1)]
                elif seg.attn == "gqa" and seg.kind != "mamba":
                    c.update(L.gqa_init_cache(cfg, seg, B, max_len, dt, dev))
                elif seg.attn == "mla":
                    c.update(L.mla_init_cache(cfg, B, max_len, dt, dev))
                if seg.kind in ("mamba", "hybrid"):
                    c["mamba"] = L.mamba_init_cache(cfg, B, dt, dev)
                return c
            caches.append([one() for _ in range(seg.n_layers)])
        return caches

    def prefill(self, batch: dict, max_len: int):
        """Run the full prompt; return (last-token logits (B, 1, V) f32,
        from ``logits_fn``; caches).  As in
        the JAX package, each layer's cache is built by a
        second pass over its input (``_prefill_layer_cache``), so the SSM
        mixer runs twice per layer and a vision group's every sub-layer
        twice."""
        self._whole_leaves()
        x = self._embed_inputs(batch)
        img = self._image_embeds(batch)
        caches = []
        for seg, layers in zip(self.cfg.segments, self.segments):
            seg_caches = []
            for lp in layers:
                y, _ = self._block(lp, x, seg, "a2a", img)
                seg_caches.append(self._prefill_layer_cache(lp, x, seg,
                                                            max_len, img))
                x = y
            caches.append(seg_caches)
        return self.logits_fn(x[:, -1:]), caches

    def _prefill_layer_cache(self, lp, x_in: torch.Tensor, seg: Segment,
                             max_len: int,
                             img: torch.Tensor | None = None) -> dict:
        cfg = self.cfg
        if seg.kind == "vision_group":
            # the image keys and values; each self sub-layer's cache from
            # a replay of the group up to it
            cp, sub = lp["cross"], _self_segment(seg)
            ck, cv = L.cross_kv(cp, img, cfg)
            x = self._cross_block(cp, x_in, seg, kv=(ck, cv))
            self_caches = []
            for sp in lp["self"]:
                self_caches.append(self._prefill_layer_cache(sp, x, sub,
                                                             max_len))
                x, _ = self._block(sp, x, sub, "a2a")
            return {"cross": {"ck": ck, "cv": cv}, "self": self_caches}
        c: dict = {}
        h = L.rmsnorm(x_in, lp["ln1"], cfg.norm_eps)
        if seg.attn == "gqa" and seg.kind != "mamba":
            c.update(L.gqa_prefill_cache(lp["attn"], h, cfg, seg, max_len))
        elif seg.attn == "mla":
            c.update(L.mla_prefill_cache(lp["attn"], h, cfg, max_len))
        if seg.kind in ("mamba", "hybrid"):
            c["mamba"] = L.mamba_mixer(lp["mamba"], h, cfg)[1]
        return c

    def decode_step(self, token: torch.Tensor, caches: list, pos):
        """One token (B, 1) for the whole batch at position ``pos``: a 0-d
        int32 tensor on the model's device, the JAX package's traced
        ``pos`` (``launch.serve.GreedyStep`` holds one and adds one to it
        on the device), or a Python int.  Writes every layer's cache in
        ``caches`` (this model's, from ``prefill`` or ``init_cache``) in
        place; returns (logits (B, 1, V) f32 from ``logits_fn``,
        ``caches``: the same list)."""
        self._whole_leaves()
        if self.cfg.frame_input:
            x = token.to(self.dtype)
        else:
            x = F.embedding(token, self._w("embed"))
        pos = L.StepPos(pos, token.shape[0], x.device)
        for seg, layers, seg_cache in zip(self.cfg.segments, self.segments,
                                          caches):
            for lp, c in zip(layers, seg_cache):
                x = self._decode_block(lp, x, seg, c, pos)
        return self.logits_fn(x), caches

    def _decode_block(self, lp, x: torch.Tensor, seg: Segment, cache: dict,
                      pos: "L.StepPos") -> torch.Tensor:
        """One layer's decode step, its cache written in place."""
        cfg = self.cfg
        if seg.kind == "vision_group":
            # the cross query against the cached image keys and values,
            # which stay as they are
            cc = cache["cross"]
            x = self._cross_block(lp["cross"], x, seg,
                                  kv=(cc["ck"], cc["cv"]))
            sub = _self_segment(seg)
            for sp, c in zip(lp["self"], cache["self"]):
                x = self._decode_block(sp, x, sub, c, pos)
            return x
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if seg.kind == "mamba":
            return x + L.mamba_mixer(lp["mamba"], h, cfg,
                                     state=cache["mamba"])[0]
        parts = []
        if seg.attn == "mla":
            parts.append(L.mla_attention_decode(lp["attn"], h, cfg, cache,
                                                pos, absorb=cfg.mla_absorb)[0])
        elif seg.attn == "gqa":
            parts.append(L.gqa_attention_decode(lp["attn"], h, cfg, seg,
                                                cache, pos)[0])
        if seg.kind == "hybrid":
            parts.append(L.mamba_mixer(lp["mamba"], h, cfg,
                                       state=cache["mamba"])[0])
        out = parts[0]
        for extra in parts[1:]:
            out = out + extra
        x = x + out
        y, _ = self._ffn(lp, x, seg, "tp")
        return x + y

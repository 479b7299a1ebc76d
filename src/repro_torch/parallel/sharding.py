"""The active mesh, the parameter sharding rules and the collectives of
the port's explicit SPMD: the JAX package's ``parallel/sharding.py``.

The JAX package compiles one global program and lets ``shard_map`` hand
each device its block.  The port runs one process per rank, each on its
own local tensors, and moves data between ranks only through the
functional collectives of ``torch.distributed`` (``torch.ops.
_c10d_functional``), which ``roofline.hlo.CollectiveCounter`` counts.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
(``launch.mesh``), or, where only its names and sizes are read (the
sharding rules, the dry run's planning), an ``AbstractMesh``.

Parameters carry logical axes implied by their names; ``param_spec`` maps
them to mesh axes with the reference's rules and divisibility guard, rule
for rule: a dimension is sharded on ``model`` only when the axis divides
it, else replicated (8 KV heads on a 16-way model axis stay whole).  A
spec is a tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the major one
first).  ``Sharding`` cuts a full tensor into a rank's block and gathers
the blocks back.

The JAX package's ``constrain`` has no counterpart: in explicit SPMD a
tensor's layout is where the code puts it.  Without a sequence split the
residual stream stays whole on every rank of the model axis, and what is
split is the work on it:

* tensor-parallel products (``tp_split``): where the model axis divides
  a family's heads (or channels, or the vocabulary), its column-parallel
  products (wq/wk/wv, w_gate/w_up, wq_b/wkv_b, cross_w{q,k,v}, the head)
  run on the rank's column blocks, its row-parallel ones (wo, w_down,
  mla_wo, cross_wo) on its row blocks, and one ``psum`` over 'model' adds
  the partial outputs, as the reference's partitioner runs them on the
  blocks that ``param_spec`` gives.  The embedding is a lookup of the
  rank's rows, then a psum; the cross-entropy a vocab-parallel one.  A
  family the condition fails reads its leaves whole (route
  ``gathered``: ``Sharding.full``, an ``all_gather`` per leaf);
* the sequence at the MoE boundary (``models.moe.moe_a2a``).

The Mamba mixer is the one family whose ``tp`` blocks are not
``param_spec``'s: the reference's rules split ``in_proj`` (D, 2·di) on its
last dimension (at n = 2 one rank holds all of x, the other all of z) and
``conv_w`` (d_conv, di) over its taps.  Where the mixer runs
tensor-parallel, the port holds them as channel blocks of its own
(``held_specs``): ``in_proj`` as the rank's ``[x block | z block]`` (a
``Blocks`` entry: the last dimension in two groups, each split over
'model') and ``conv_w`` on its channels.  ``Sharding.local`` and ``full``
cut and gather these as any other block, so a checkpoint (the leaves
gathered whole) keeps the reference's layout, and a restore onto
another mesh cuts the blocks anew.

The sequence split (``seq_split_of``): under ``dp_seq`` (the batch's
sequence over 'model', ``train.step.batch_specs``) and under
``seq_shard_activations`` (the reference's ``_constrain_residual``) each
rank of the model axis holds its block of the sequence (``SeqSplit``)
between the sub-layers, and each family runs on it by the route
``seq_split`` gives it from the config alone: ``seq`` (GQA self-attention
with whole weights: the rank's queries against the keys and values
gathered over the sequence, the queries at the block's offset), ``token``
(per-token work on the block, no collective), or ``gathered`` (the
family's input gathered over the sequence and the family run whole; the
rank keeps its block of the output, a ``tp`` family by a
``reduce_scatter`` along the sequence in place of its psum).

The collectives here are autograd Functions whose backward is the
adjoint collective, so that one backward pass over every rank's loss
(each rank's share: ``train.step``) gives the gradient of their sum:
``all_gather``'s backward is a ``reduce_scatter`` and ``reduce_scatter``'s
an ``all_gather``, ``all_to_all``'s the reverse ``all_to_all``, ``psum``'s
a ``psum``.  Under that convention a
replicated tensor's gradient on each rank is a share, and the shares sum
to its gradient: so the replicated input of a column-parallel product
needs no collective of its own (its conjugate is the identity both ways,
where Megatron's ``f`` all-reduces in the backward because each of its
ranks starts from the whole loss), the row-parallel output's psum
backward turns the shares into the whole cotangent on every rank, and
the step's psum of each replicated leaf's gradient over 'model' adds the
shares once (``train.step``).  ``pmax`` (the cross-entropy's shift) has
no gradient.  None of them stages data through the host: the transport is
the process group's (NCCL, or gloo, which takes CUDA tensors as they
are).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np
import torch

_C = torch.ops._c10d_functional

_ACTIVE_MESH = None


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without a process group (the JAX
    package's ``jax.sharding.AbstractMesh``): what the sharding rules and
    the dry run's planning read."""
    shape: tuple
    mesh_dim_names: tuple


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """``with use_mesh(mesh):`` holds ``mesh`` active and restores the mesh
    that was active before, also when the block raises."""
    before = _ACTIVE_MESH
    set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(before)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh=None) -> tuple:
    """Mesh axes the global batch is sharded over."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if mesh is None:
        return ()
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def batch_entry(mesh=None):
    """The batch axes as one spec entry: None, a lone axis by its name, or
    a tuple of them."""
    dp = batch_axes(mesh)
    return None if not dp else dp[0] if len(dp) == 1 else dp


@dataclasses.dataclass(frozen=True)
class Blocks:
    """A spec entry: the dimension is ``groups`` equal groups, each split
    into blocks over the mesh axis ``axis``; a rank holds its block of
    every group, in group order (the Mamba mixer's ``in_proj`` (D, 2·di)
    as the rank's ``[x block | z block]``: ``Blocks("model", 2)``)."""
    axis: str
    groups: int


def axis_size_of(mesh, axis) -> int:
    """The ranks of a spec entry: 1 for None, an axis's size, or the
    product of a tuple of axes'."""
    if axis is None:
        return 1
    if isinstance(axis, Blocks):
        axis = axis.axis
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return int(np.prod([sizes[a] for a in axis]))
    return sizes[axis]


def _guard(mesh, shape: tuple, spec: list) -> tuple:
    """Drop mesh axes that don't divide the corresponding dim."""
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            out.append(None)
        elif dim % axis_size_of(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


# path-pattern -> which dim gets the 'model' axis (negative = from the end)
_MODEL_DIM_RULES: list[tuple[str, int]] = [
    (r"embed$", 0),            # (vocab, d) -> shard vocab
    (r"lm_head$", -1),         # (d, vocab) -> shard vocab
    (r"\bwq$", -1), (r"\bwk$", -1), (r"\bwv$", -1),   # (.., d, H*hd)
    (r"\bwo$", -2),            # (.., H*hd, d)
    (r"\bw_gate$", -1), (r"\bw_up$", -1),             # (.., d, f)
    (r"\bw_down$", -2),        # (.., f, d)
    (r"\be_gate$", -3), (r"\be_up$", -3), (r"\be_down$", -3),  # (L,E,..,..)
    (r"\brouter$", -1),
    (r"\bwq_b$", -1), (r"\bwkv_b$", -1),              # MLA head projections
    (r"\bmla_wo$", -2),
    (r"\bin_proj$", -1),       # mamba (d, 2*di)
    (r"\bconv_w$", -2), (r"\bA_log$", -2), (r"\bssm_D$", -1),
    (r"\bx_proj$", -2), (r"\bdt_proj$", -1), (r"\bout_proj$", -2),
    (r"\bcross_wq$", -1), (r"\bcross_wk$", -1), (r"\bcross_wv$", -1),
    (r"\bcross_wo$", -2),
]


def param_spec(path: str, shape: tuple, strategy: str = "tp",
               mesh=None) -> tuple:
    """The spec of a parameter named ``path`` (the port's dotted names or
    the reference's ``/`` paths) under ``mesh`` (default: the active one);
    all ``None`` without a mesh, under ``dp_seq``, or where no rule
    matches."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    replicated = (None,) * len(shape)
    if mesh is None or strategy == "dp_seq" \
            or "model" not in mesh.mesh_dim_names:
        return replicated
    for pat, dim in _MODEL_DIM_RULES:
        if re.search(pat, path):
            spec = [None] * len(shape)
            spec[dim if dim >= 0 else len(shape) + dim] = "model"
            # 'tp+ep_data': expert FFN weights additionally sharded over
            # the data axis on dim -2 (persistent storage / dp; gathered
            # per layer at the slot boundary)
            if ("ep_data" in strategy and "data" in mesh.mesh_dim_names
                    and re.search(r"\be_(gate|up|down)$", path)):
                spec[len(shape) - 2] = "data"
            return _guard(mesh, shape, spec)
    return replicated


# ------------------------------------------------- tensor-parallel routes
# the leaves of each family whose products run on blocks, and the
# dimension each is held split over 'model' on (column-parallel: the last;
# row-parallel: the one before; the embedding's vocabulary rows):
# ``param_spec``'s, and for the Mamba mixer ``held_specs``'
TP_DIMS = {"gqa": {"wq": -1, "wk": -1, "wv": -1, "wo": -2},
           "mamba": {"in_proj": -1, "conv_w": -1, "A_log": -2,
                     "ssm_D": -1, "x_proj": -2, "dt_proj": -1,
                     "out_proj": -2},
           "mla": {"wq_b": -1, "wkv_b": -1, "mla_wo": -2},
           "cross": {"cross_wq": -1, "cross_wk": -1, "cross_wv": -1,
                     "cross_wo": -2},
           "mlp": {"w_gate": -1, "w_up": -1, "w_down": -2},
           "embed": {"embed": 0},
           "head": {"lm_head": -1}}
# the leaves held in groups of blocks (``Blocks``): {name: groups}
TP_GROUPS = {"in_proj": 2}
ROUTES = ("tp", "gathered")
# the families' routes, counted each time a family runs under a mesh
# (a remat replay counts again), as ``kernels.ops.route_launches`` counts
# the attention calls
tp_route_launches: dict[str, dict[str, int]] = {}


def reset_tp_routes() -> None:
    tp_route_launches.clear()


def count_tp_route(family: str, route: str) -> None:
    counts = tp_route_launches.setdefault(family, dict.fromkeys(ROUTES, 0))
    counts[route] += 1


def tp_split(cfg, seg, n_model: int) -> dict:
    """{family: ``"tp"`` or ``"gathered"``} of segment ``seg`` of ``cfg``
    (``seg`` None: the model's embedding and head) on a model axis of
    ``n_model`` ranks, from the config alone (never from a rank's shapes,
    so every rank takes the same collectives).  The condition is the
    reference cost model's (``roofline.model``): GQA and cross-attention
    split where ``n_model`` divides the (physical) query heads and the KV
    heads, MLA where it divides the heads, the SwiGLU MLP (a MoE layer's
    shared experts) its hidden width, the embedding and head the
    vocabulary.  ``param_spec`` shards columns, so a head count that
    ``n_model`` does not divide (hymba's 25 heads at 2) is split in the
    middle of a head: the family reads its leaves whole.  The Mamba mixer
    splits where ``n_model`` divides its channels (``d_inner``), the
    cost model's ``di / tp``, on the channel blocks that ``held_specs``
    gives it.  The MoE router (top-k needs every expert's logit) is always
    ``gathered``.  Under ``dp_seq`` every leaf is whole and every family
    reads it so: what the model axis splits there is the sequence
    (``seq_split``)."""
    whole = cfg.strategy == "dp_seq"

    def route(ok: bool) -> str:
        return "tp" if ok and not whole else "gathered"

    n = n_model
    if seg is None:
        out = {"head": route(cfg.vocab % n == 0)}
        if not cfg.frame_input:
            out["embed"] = route(cfg.vocab % n == 0)
        return out
    heads = (cfg.n_heads_padded or cfg.n_heads) % n == 0
    out = {}
    if seg.attn == "gqa" and seg.kind != "mamba":
        out["gqa"] = route(heads and cfg.n_kv_heads % n == 0)
    elif seg.attn == "mla":
        out["mla"] = route(cfg.n_heads % n == 0)
    if seg.kind in ("mamba", "hybrid"):
        out["mamba"] = route(cfg.d_inner % n == 0)
    if seg.kind == "vision_group":
        out["cross"] = route(cfg.n_heads % n == 0
                             and cfg.n_kv_heads % n == 0)
    if seg.kind == "moe":
        out["router"] = "gathered"
        if cfg.n_shared_experts:
            out["mlp"] = route(cfg.n_shared_experts * cfg.moe_d_ff % n == 0)
    elif seg.kind != "mamba" and cfg.d_ff:
        out["mlp"] = route(cfg.d_ff % n == 0)
    return out


# ----------------------------------------------------- the sequence split
SEQ_ROUTES = ("seq", "token", "gathered")
# the families' sequence routes, counted each time a family runs on a
# split sequence (a remat replay counts again)
seq_route_launches: dict[str, dict[str, int]] = {}


def reset_seq_routes() -> None:
    seq_route_launches.clear()


def count_seq_route(family: str, route: str) -> None:
    counts = seq_route_launches.setdefault(family,
                                           dict.fromkeys(SEQ_ROUTES, 0))
    counts[route] += 1


def seq_split(cfg, seg, n_model: int) -> dict:
    """{family: ``"seq"``, ``"token"`` or ``"gathered"``} of segment
    ``seg`` of ``cfg`` (``seg`` None: the embedding, the head and the MTP
    block) on a sequence split over a model axis of ``n_model`` ranks,
    from the config alone (never from a rank's shapes), beside the weight
    routes of ``tp_split``:

    * GQA self-attention whose weights are whole: ``seq``, the rank's
      queries against the keys and values gathered over the sequence;
    * the families that mix positions -- the Mamba mixer, MLA, a MoE layer
      (its capacity depends on the whole token set), the MTP block, and a
      ``tp`` GQA (its column-parallel products want every position) --
      and every ``tp`` family under ``seq_shard_activations``:
      ``gathered``, the input gathered over the sequence, the family run
      whole, the rank's block kept (a ``tp`` family's output
      reduce-scattered along the sequence in place of its psum);
    * per-token work with whole weights -- the dense MLP, cross-attention
      (text queries against the image, which no text position shares),
      the embedding, and the head under ``dp_seq`` (its cross-entropy
      terms summed per rank, then over the model axis): ``token``.

    The norms and rope are per-token too and take no route."""
    tp = tp_split(cfg, seg, n_model)

    def per_token(family: str) -> str:
        return "gathered" if tp.get(family) == "tp" else "token"

    if seg is None:
        out = {"head": ("token" if cfg.strategy == "dp_seq"
                        else "gathered")}
        if not cfg.frame_input:
            out["embed"] = per_token("embed")
        if cfg.mtp_depth:
            out["mtp"] = "gathered"
        return out
    out = {}
    for family in tp:
        if family == "gqa":
            out["gqa"] = "gathered" if tp["gqa"] == "tp" else "seq"
        elif family in ("mlp", "cross"):
            if seg.kind != "moe":           # a MoE layer's shared experts
                out[family] = per_token(family)
        elif family == "router":
            out["moe"] = "gathered"
        else:                               # mla, mamba
            out[family] = "gathered"
    return out


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """This rank's block of a sequence of ``n * block`` positions split
    over the mesh axis ``axis`` of ``n`` ranks: positions ``offset`` to
    ``offset + block - 1`` (``index``: the rank's coordinate)."""
    axis: str
    index: int
    n: int
    block: int

    @property
    def offset(self) -> int:
        return self.index * self.block

    @property
    def length(self) -> int:
        return self.n * self.block

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of the whole ``x`` along ``dim`` (a view)."""
        return x.narrow(dim, self.offset, self.block)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from every rank's block (``all_gather``)."""
        return all_gather(x, self.axis, dim)


def seq_split_of(cfg, S: int, mesh=None) -> SeqSplit | None:
    """The split of a sequence of ``S`` positions over 'model' under
    ``mesh`` (default: the active one), or None: none without a model axis
    of two or more ranks, outside ``dp_seq`` and ``seq_shard_activations``,
    or where the axis does not divide ``S`` (``train.step.batch_specs``,
    the reference's ``_constrain_residual``)."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    if cfg.strategy != "dp_seq" and not cfg.seq_shard_activations:
        return None
    n = axis_sizes(mesh)["model"]
    if n < 2 or S < 2 or S % n:
        return None
    return SeqSplit("model", axis_index("model", mesh), n, S // n)


def tp_spec(ndim: int, dim: int, groups: int = 1) -> tuple:
    """The spec of a leaf of ``ndim`` dimensions held as this rank's block
    over 'model' on ``dim`` (of each of ``groups`` groups: ``Blocks``)."""
    spec = [None] * ndim
    spec[dim] = "model" if groups == 1 else Blocks("model", groups)
    return tuple(spec)


def tree_param_specs(shapes: dict, strategy: str = "tp", mesh=None) -> dict:
    """{name: spec} for {name: tensor or shape}."""
    return {name: param_spec(name, tuple(getattr(s, "shape", s)), strategy,
                             mesh)
            for name, s in shapes.items()}


def held_specs(shapes: dict, cfg, mesh=None) -> dict:
    """{name: spec} of the layout the port holds {name: tensor or shape}
    of ``cfg`` in under ``mesh`` (default: the active one):
    ``param_spec``'s, but where the Mamba mixer runs tensor-parallel
    (``tp_split``) each of its leaves is held as the rank's block of
    channels that its product reads (``TP_DIMS``, ``TP_GROUPS``):
    ``in_proj`` as ``[x block | z block]`` and ``conv_w`` on its channels
    where the reference's rules split them otherwise.  ``conv_b`` and
    ``dt_bias`` stay whole, as the reference has them."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    specs = tree_param_specs(shapes, cfg.strategy, mesh)
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return specs
    seg = next((s for s in cfg.segments if s.kind in ("mamba", "hybrid")),
               None)
    if seg is None or tp_split(cfg, seg, axis_sizes(mesh)["model"])[
            "mamba"] != "tp":
        return specs
    dims = TP_DIMS["mamba"]
    for name, s in shapes.items():
        parts = name.split(".")
        if len(parts) >= 2 and parts[-2] == "mamba" and parts[-1] in dims:
            specs[name] = tp_spec(len(getattr(s, "shape", s)),
                                  dims[parts[-1]],
                                  TP_GROUPS.get(parts[-1], 1))
    return specs


def tree_shardings(shapes: dict, mesh, cfg) -> dict:
    """{name: Sharding} of {name: tensor or shape} of ``cfg`` under
    ``mesh``, as the port holds them (``held_specs``)."""
    return {name: Sharding(mesh, spec) for name, spec in
            held_specs(shapes, cfg, mesh).items()}


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, Blocks):
        return (entry.axis,)
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``): which block
    of a full tensor each rank holds."""
    mesh: object
    spec: tuple

    def axes(self) -> tuple:
        """Every mesh axis the tensor is split over."""
        return tuple(a for e in self.spec for a in _axes_of(e))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view, but of a ``Blocks``
        entry's groups, which are put together in a copy)."""
        out = full
        for dim, e in enumerate(self.spec):
            n = axis_size_of(self.mesh, e)
            if n == 1:
                continue
            idx = 0
            for a in _axes_of(e):        # the major axis first
                idx = idx * axis_size(a, self.mesh) + axis_index(a,
                                                                 self.mesh)
            if isinstance(e, Blocks):
                g = out.unflatten(dim, (e.groups, -1))
                step = g.shape[dim + 1] // n
                out = g.narrow(dim + 1, idx * step, step).flatten(dim,
                                                                  dim + 1)
                continue
            step = out.shape[dim] // n
            out = out.narrow(dim, idx * step, step)
        return out

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (differentiable:
        ``all_gather`` per sharded axis, the minor axis first; a
        ``Blocks`` entry's within each group)."""
        out = local
        for dim, e in enumerate(self.spec):
            if isinstance(e, Blocks):
                g = out.unflatten(dim, (e.groups, -1))
                out = all_gather(g, e.axis, dim + 1,
                                 self.mesh).flatten(dim, dim + 1)
                continue
            for a in reversed(_axes_of(e)):
                out = all_gather(out, a, dim, self.mesh)
        return out


# ------------------------------------------------------------ collectives
def _mesh(mesh):
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("a collective needs an active mesh")
    return mesh


def axis_size(axis: str, mesh=None) -> int:
    return axis_sizes(_mesh(mesh))[axis]


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return _mesh(mesh).get_local_rank(axis)


def _group(axis: str, mesh) -> tuple[int, str]:
    mesh = _mesh(mesh)
    return axis_size(axis, mesh), mesh.get_group(axis).group_name


def _gloo_cuda(x: torch.Tensor, axis: str, mesh) -> bool:
    return x.is_cuda and torch.distributed.get_backend(
        _mesh(mesh).get_group(axis)) == "gloo"


def _all_reduce(x: torch.Tensor, axis: str, mesh,
                op: str = "sum") -> torch.Tensor:
    _, name = _group(axis, mesh)
    return _C.wait_tensor(_C.all_reduce(x.contiguous(), op, name))


def _all_gather(x: torch.Tensor, axis: str, dim: int, mesh) -> torch.Tensor:
    n, name = _group(axis, mesh)
    x0 = x.movedim(dim, 0).contiguous()
    if _gloo_cuda(x, axis, mesh):
        # gloo's functional all-gather of CUDA tensors crashes the process
        # (torch 2.11); an all_to_all of n copies moves the same blocks
        out = _all_to_all(x0.expand(n, *x0.shape).reshape(-1, *x0.shape[1:]),
                          axis, mesh)
    else:
        out = _C.wait_tensor(_C.all_gather_into_tensor(x0, n, name))
    # in x's layout: a product on a transposed view takes another GEMM
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, axis: str, dim: int,
                    mesh) -> torch.Tensor:
    n, name = _group(axis, mesh)
    out = _C.wait_tensor(_C.reduce_scatter_tensor(
        x.movedim(dim, 0).contiguous(), "sum", n, name))
    return out.movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Block i of dim 0 goes to rank i; block j of the result came from
    rank j."""
    n, name = _group(axis, mesh)
    split = [x.shape[0] // n] * n
    return _C.wait_tensor(_C.all_to_all_single(x.contiguous(), split, split,
                                               name))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        for a in axes:
            x = _all_reduce(x, a, mesh)
        return x

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = _all_reduce(g, a, ctx.mesh)
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        return _all_gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        return _reduce_scatter(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return _all_to_all(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a name or a tuple of
    names), on every one of them (``jax.lax.psum``).  An axis of one rank
    is skipped: the sum over it is ``x``, and nothing is called."""
    if not _axes_of(axes):
        return x
    mesh = _mesh(mesh)
    axes = tuple(a for a in _axes_of(axes) if axis_size(a, mesh) > 1)
    return _PSum.apply(x, axes, mesh) if axes else x


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axes``, on
    every one of them (``jax.lax.pmax``); no gradient."""
    mesh = _mesh(mesh)
    x = x.detach()
    for a in _axes_of(axes):
        if axis_size(a, mesh) > 1:
            x = _all_reduce(x, a, mesh, "max")
    return x


def pmean(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    axes = _axes_of(axes)
    n = int(np.prod([axis_size(a, mesh) for a in axes])) if axes else 1
    return psum(x, axes, mesh) / n


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               mesh=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order."""
    return _AllGather.apply(x, axis, dim, _mesh(mesh))


def reduce_scatter(x: torch.Tensor, axis: str, dim: int = 0,
                   mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, of which each keeps its
    block along ``dim`` in axis order (the adjoint of ``all_gather``)."""
    return _ReduceScatter.apply(x, axis, dim, _mesh(mesh))


def all_to_all(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0)``: dim 0 holds one block per
    rank of ``axis``; block i goes to rank i."""
    return _AllToAll.apply(x, axis, _mesh(mesh))

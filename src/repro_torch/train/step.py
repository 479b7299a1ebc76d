"""The training step: loss, gradients and the AdamW update, on one device
or as one rank of a mesh.

The twin of the JAX package's ``train/step.py``.  The model
(``models.model.Model``) holds the parameters; the training state is
``{"params": {name: parameter}, "opt": adamw state}``, ``params`` being
the model's own parameters, which the step updates in place.  A state
whose ``params`` are other tensors (a checkpoint restored, a state carried
across from the JAX package) is copied into the model at the next step.

On a CUDA device the forward passes run the attention and scan kernels and
the backward passes their backward kernels (``kernels.ops``); the model's
``remat`` recomputes each layer in the backward pass; AdamW runs as one
fused kernel a leaf (``kernels.adamw``).

On one card without a mesh the step is captured, the counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``: the first
``step_fn`` runs eagerly on a side stream (the kernels built, the
workspaces allocated), then one step is recorded in a
``torch.cuda.CUDAGraph`` without running, and every later call copies its
batch into the graph's static buffers and replays it.  The graph owns the
state it was captured on -- the model's parameters and the optimizer's
step, master, m and v -- as the donated state of the reference: a state
of other tensors (a checkpoint restored, a state carried across from the
JAX package) is copied into them in place, and the state returned is
always the graph's.  The metrics are the graph's static tensors, which
the next replay overwrites.  The capture is a ``kernels.ops.Captured``,
as serving's ``launch.serve.GreedyStep`` is: the launches counted while
recording are taken back and booked once a replay.  ``init_state``
builds a new model and drops the graph, so the next step captures again;
a batch of another shape raises; a capture that fails raises, and nothing
falls back to eager steps.  On the CPU, on the
meta device and under a mesh (whose collectives go through the host over
gloo) the step runs eagerly (``TrainStep.mode``).

Under a mesh (``build_train_step(..., mesh=...)``) the step is explicit
SPMD.  The placements are the reference's (``batch_specs``,
``state_shardings``): the batch is split over ('pod', 'data') (each rank
takes its rows of the global batch, ``local_batch``), the parameters hold
the blocks that ``param_spec`` gives them, and under ``zero_opt_state`` the
f32 master and the moments are split over 'data' too.  The model runs
each family on the model axis by its route (``parallel.sharding.
tp_split``): a ``tp`` family multiplies on its blocks and adds the partial
outputs with a psum, a ``gathered`` one gathers its leaves where it reads
them (``models.model``).

Each rank's backward pass starts from its loss times its share,
1 / (ranks).  The collectives' adjoints then carry shares: a psum's
backward (a row-parallel product's, the vocab-parallel embedding's and
cross-entropy's) adds the model ranks' shares into the whole cotangent,
so a tp block's gradient comes out whole on its rank, as an all_gather's
reduce_scatter makes a gathered leaf's; the replicated input of a
column-parallel product takes no collective, its gradient on each rank
being a share.  A psum of every gradient over the axes its leaf is whole
on (over 'model' for a replicated leaf -- the norms, MLA's wq_a and
wkv_a, the MTP projection, and the tp Mamba mixer's conv_b and dt_bias,
whose gradient on each rank is its channels' part -- which adds its
shares once, leaving the same sum on every model rank; over the batch
axes for all) then gives each rank the gradient of the mean loss over
the global batch.  The global gradient norm sums every leaf's blocks once.
Each rank then runs AdamW on its blocks -- under ZeRO on its data slice,
whose new parameters an all_gather over 'data' puts together.  The
stored blocks are ``param_spec``'s (the Mamba mixer's channel blocks
where it runs tensor-parallel, ``parallel.sharding.held_specs``), and a
checkpoint holds every leaf whole, so checkpoints and elastic restores
do not depend on the routes.

The sequence split of ``dp_seq`` (``batch_specs`` puts the model axis on
the sequence where it divides it): ``local_batch`` hands each rank its
block of the sequence -- its tokens (or frames), and its labels with the
next block's first label, which the causal loss pairs with the block's
last position -- and ``batch["seq_split"]`` (a
``parallel.sharding.SeqSplit``).  The model runs each family on the block
by its sequence route (``parallel.sharding.seq_split``), and its loss is
the rank's sum of cross-entropy terms, added over 'model' and divided by
the global count, so the 1 / ranks share above gives the gradient of the
one-device mean loss here too.  Every leaf is whole under ``dp_seq``, and
its gradient is summed over every axis.  ``seq_shard_activations`` splits
the residual stream inside the model (``models.model``); its batch is
whole over 'model'.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..kernels import ops
from ..models.config import ModelConfig
from ..models.model import Model, causal_lm
from ..models.moe import PlacementPlan
from ..optim import adamw
from ..parallel import sharding as shd


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


def batch_specs(cfg: ModelConfig, mesh, shapes: dict) -> dict:
    """The reference's specs of the input batch ({name: shape}): the batch
    over ('pod', 'data'); under ``dp_seq`` also the sequence over 'model'
    where it divides (not a decode step's single token)."""
    dp = shd.batch_entry(mesh)
    seq_axis = "model" if cfg.strategy == "dp_seq" else None
    out = {}
    for k, shape in shapes.items():
        shape = tuple(getattr(shape, "shape", shape))
        if k in ("tokens", "labels", "frames"):
            spec = [dp, seq_axis] + [None] * (len(shape) - 2)
            if shape[1] == 1 or (seq_axis and shape[1]
                                 % shd.axis_sizes(mesh)["model"]):
                spec[1] = None
        else:  # image_embeds etc: batch-sharded only
            spec = [dp] + [None] * (len(shape) - 1)
        out[k] = tuple(spec)
    return out


def cache_specs(cfg: ModelConfig, mesh, caches: list) -> list:
    """The reference's cache specs, leaf for leaf of ``Model.init_cache``:
    the batch over the data axes where it divides, the longest remaining
    dimension of 1024 or more over 'model' where that divides.  The
    reference decides on its caches stacked over layers (and a vision
    group's sub-layers); each leaf here is decided with those leading
    dimensions put back, which are then dropped."""
    dp = shd.batch_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
    model_size = sizes.get("model", 1)
    dp_spec = shd.batch_entry(mesh)

    def spec_for(shape):
        spec = [None] * len(shape)
        batch_dim = None
        for i in range(1, len(shape)):
            if shape[i] % dp_size == 0 and shape[i] >= dp_size:
                spec[i] = dp_spec
                batch_dim = i
                break
        order = sorted((i for i in range(1, len(shape)) if i != batch_dim),
                       key=lambda i: -shape[i])
        for i in order:
            if shape[i] >= model_size and shape[i] % model_size == 0 \
                    and shape[i] >= 1024:
                spec[i] = "model"
                break
        return tuple(spec)

    def walk(tree, lead):
        if isinstance(tree, dict):
            return {k: walk(v, lead) for k, v in tree.items()}
        if isinstance(tree, list):   # a vision group's sub-layers
            return [walk(v, lead + (len(tree),)) for v in tree]
        return spec_for(lead + tuple(tree.shape))[len(lead):]

    return [[walk(c, (len(seg),)) for c in seg] for seg in caches]


def state_shardings(cfg: ModelConfig, mesh, shapes: dict,
                    held: bool = False) -> dict:
    """The reference's specs of the training state for parameters
    {name: shape}: ``params`` by ``param_spec`` (``held``: as the port
    holds them, ``parallel.sharding.held_specs``, the Mamba mixer's
    leaves in channel blocks where it runs tensor-parallel); the
    optimizer's ``master``, ``m`` and ``v`` the same, and under
    ``zero_opt_state`` (where the parameter is not data-sharded already)
    'data' on the largest dimension left whole that it divides; ``step``
    whole."""
    sizes = shd.axis_sizes(mesh)
    pspecs = (shd.held_specs(shapes, cfg, mesh) if held
              else shd.tree_param_specs(shapes, cfg.strategy, mesh))

    def opt_spec(name):
        spec = list(pspecs[name])
        shape = tuple(getattr(shapes[name], "shape", shapes[name]))
        if "data" in spec:
            return tuple(spec)
        if cfg.zero_opt_state and "data" in sizes:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if spec[i] is None and shape[i] % sizes["data"] == 0 \
                        and shape[i] >= sizes["data"]:
                    spec[i] = "data"
                    break
        return tuple(spec)

    opt = {name: opt_spec(name) for name in shapes}
    return {"params": pspecs,
            "opt": {"step": (), "master": opt, "m": dict(opt),
                    "v": dict(opt)}}


@dataclasses.dataclass
class TrainStep:
    """One training step of ``cfg`` (``step_fn``).  ``graph``: captured
    once in a CUDA graph and replayed (one card, no mesh; see the module
    docstring), else eager.  After each ``step_fn``, ``last_kind`` says
    how it ran -- ``"eager"``, ``"capture"`` (eagerly, then recorded) or
    ``"replay"`` -- and a capture leaves its seconds in ``capture_s`` and
    the bytes the allocator reserved for the graph's private pool while
    recording it (the pool's peak, rounded up to the allocator's segments)
    in ``graph_pool_B``."""
    cfg: ModelConfig
    opt_cfg: adamw.AdamWConfig
    device: torch.device
    model: Model | None = None
    mesh: object = None
    plan: PlacementPlan | None = None
    graph: bool = False
    last_kind: str | None = None
    capture_s: float | None = None
    graph_pool_B: int | None = None
    _specs: dict | None = dataclasses.field(default=None, repr=False)
    _graph: ops.Captured | None = dataclasses.field(default=None,
                                                    repr=False)
    _batch: dict | None = dataclasses.field(default=None, repr=False)
    _state: dict | None = dataclasses.field(default=None, repr=False)
    _metrics: dict | None = dataclasses.field(default=None, repr=False)

    @property
    def mode(self) -> str:
        """``"graph"`` (captured and replayed) or ``"eager"``."""
        return "graph" if self.graph else "eager"

    def init_state(self, seed: int = 0) -> dict:
        """A fresh model drawn from ``torch.Generator(device)`` seeded with
        ``seed`` (none on the meta device, whose draws make no numbers),
        gradients on, and AdamW's initial state; under a mesh, this rank's
        blocks of both.  Drops a captured step: the next one captures
        again, on the new model."""
        self.drop_graph()
        self.model = None     # the old weights go before the new are drawn
        gen = (None if self.device.type == "meta"
               else torch.Generator(device=self.device).manual_seed(seed))
        n_ep = (1 if self.mesh is None
                else shd.axis_sizes(self.mesh).get("model", 1))
        with shd.use_mesh(self.mesh):
            self.model = Model(self.cfg, self.plan, n_ep_shards=n_ep,
                               device=self.device,
                               generator=gen).requires_grad_(True)
        params = dict(self.model.named_parameters())
        self._specs = None
        if self.mesh is not None:     # the reference's, on the full shapes
            full = {}
            for n, sh in self.model.shardings().items():
                shape = tuple(params[n].shape)
                full[n] = shape if sh is None else tuple(
                    k * shd.axis_size_of(self.mesh, e)
                    for k, e in zip(shape, sh.spec))
            self._specs = state_shardings(self.cfg, self.mesh, full,
                                          held=True)
        return {"params": params,
                "opt": adamw.init_state(self.opt_cfg, self._opt_view(params))}

    def _zero_dim(self, name: str) -> int | None:
        """The dimension ZeRO splits over 'data' beyond the parameter's own
        spec, or None."""
        if self._specs is None:
            return None
        pspec, ospec = (self._specs["params"][name],
                        self._specs["opt"]["master"][name])
        for i, (a, b) in enumerate(zip(pspec, ospec)):
            if a != b:
                return i
        return None

    def _opt_view(self, tree: dict) -> dict:
        """Each leaf as the optimizer holds it: its ZeRO slice over 'data'
        where there is one (a view), else itself."""
        out = {}
        for n, t in tree.items():
            d = self._zero_dim(n)
            if d is not None:
                k = t.shape[d] // shd.axis_size("data", self.mesh)
                t = t.narrow(d, shd.axis_index("data", self.mesh) * k, k)
            out[n] = t
        return out

    def state_shardings(self) -> dict:
        """The training state's tree of ``parallel.sharding.Sharding``
        (None without a mesh): what the checkpointer gathers and cuts."""
        if self._specs is None:
            return None
        opt = {k: {n: shd.Sharding(self.mesh, s) for n, s in v.items()}
               for k, v in self._specs["opt"].items() if k != "step"}
        return {"params": {n: shd.Sharding(self.mesh, s) for n, s in
                           self._specs["params"].items()},
                "opt": {"step": shd.Sharding(self.mesh, ()), **opt}}

    def local_batch(self, batch: dict) -> dict:
        """This rank's part of a global batch (``batch_to`` form): its rows
        (the batch over ('pod', 'data')), and under ``dp_seq`` its block of
        the sequence where 'model' divides it (``batch_specs``): the
        tokens, frames and labels of its positions, the labels with the
        next block's first one where the loss is causal, and the split as
        ``"seq_split"``; else whole over 'model'."""
        if self.mesh is None:
            return batch
        rows = shd.Sharding(self.mesh, (shd.batch_entry(self.mesh),))
        out = {k: rows.local(v) for k, v in batch.items()}
        x = out["frames" if self.cfg.frame_input else "tokens"]
        seq = (shd.seq_split_of(self.cfg, x.shape[1], self.mesh)
               if self.cfg.strategy == "dp_seq" else None)
        if seq is None:
            return out
        for k in ("tokens", "frames", "labels"):
            if k in out:
                n = seq.block + int(k == "labels" and causal_lm(self.cfg))
                out[k] = out[k].narrow(1, seq.offset, min(
                    n, seq.length - seq.offset))
        out["seq_split"] = seq
        return out

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
        """The loss and its gradients on ``batch`` (``batch_to`` form; under
        a mesh this rank's rows, ``local_batch``): returns (the model's
        parameters, each ``.grad`` set -- zeros where the loss does not
        reach it; under a mesh, the gradient of the mean loss over the
        global batch -- and the loss metrics, over the global batch)."""
        params = self._bind(state["params"])
        for p in params.values():
            p.grad = None
        with shd.use_mesh(self.mesh):
            loss, metrics = self.model.loss(batch)
            if self.mesh is None:
                loss.backward()
            else:
                (loss / self.mesh.size()).backward()
                metrics = {k: shd.pmean(v.detach(), shd.batch_axes())
                           for k, v in metrics.items()}
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            self._reduce_grads(params)
        return params, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def _reduce_grads(self, params: dict) -> None:
        """Sum each gradient over the axes its leaf is whole on."""
        names = self.mesh.mesh_dim_names
        shardings = self.model.shardings()
        for n, p in params.items():
            sh = shardings[n]
            axes = tuple(a for a in names
                         if a not in (sh.axes() if sh else ()))
            p.grad = shd.psum(p.grad, axes, self.mesh)

    @torch.no_grad()
    def _global_norm(self, params: dict) -> torch.Tensor:
        """The gradient norm over every leaf whole: each leaf's norm from
        the squares of its blocks, summed over the axes it is split on (one
        psum for all the leaves split on the same axes)."""
        norms = [torch.linalg.vector_norm(p.grad, dtype=torch.float32)
                 for p in params.values()]
        shardings = self.model.shardings()
        split: dict[tuple, list] = {}
        for i, n in enumerate(params):
            if shardings[n] is not None:
                split.setdefault(shardings[n].axes(), []).append(i)
        for axes, idx in split.items():
            sq = torch.stack([norms[i] for i in idx])
            sq = torch.sqrt(shd.psum(sq * sq, axes, self.mesh))
            for j, i in enumerate(idx):
                norms[i] = sq[j]
        return torch.linalg.vector_norm(torch.stack(norms))

    def update(self, state: dict, params: dict) -> dict:
        """AdamW from the parameters' ``.grad`` (then dropped), in place;
        returns its metrics.  Under a mesh each rank updates its blocks
        (under ZeRO its data slice, then gathered over 'data')."""
        grads = {n: p.grad for n, p in params.items()}
        if self.mesh is None:
            out = adamw.apply_updates(self.opt_cfg, state["opt"], grads,
                                      params)
        else:
            gnorm = self._global_norm(params)
            views = self._opt_view({n: p.data for n, p in params.items()})
            out = adamw.apply_updates(self.opt_cfg, state["opt"],
                                      self._opt_view(grads), views,
                                      gnorm=gnorm)
            with torch.no_grad():
                for n, p in params.items():
                    d = self._zero_dim(n)
                    if d is not None:
                        p.copy_(shd.all_gather(views[n], "data", d,
                                               self.mesh))
        for p in params.values():
            p.grad = None
        return out

    def step_fn(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One step on ``batch``: ``grads`` then ``update``.  Returns (the
        state, updated in place, and the metrics: ``loss``, ``ce``,
        ``aux``, ``grad_norm``, ``lr``, as 0-d tensors on the device).
        Captured (``graph``): the first call runs eagerly and records the
        step, later calls replay it on the graph's own state and static
        batch, into which ``state`` and ``batch`` are copied where they
        are other tensors."""
        if not self.graph:
            self.last_kind = "eager"
            return self._eager_step(state, batch)
        if self._graph is None:
            return self._capture(state, batch)
        self._load(state, batch)
        self._graph()
        self.last_kind = "replay"
        return self._state, self._metrics

    def _eager_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        params, metrics = self.grads(state, batch)
        metrics.update(self.update(state, params))
        return {"params": params, "opt": state["opt"]}, metrics

    def _capture(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """The first captured step: one step eagerly on the static batch, a
        copy of ``batch``, on the capture's stream (``ops.Captured.warm``),
        then the step recorded, not run, on the state it left."""
        if self.model is None:
            self.init_state(0)
        self._batch = {k: v.clone() for k, v in batch.items()}
        graph = ops.Captured(self.device)
        state, metrics = graph.warm(
            lambda: self._eager_step(state, self._batch))
        self._state = state
        t0 = time.perf_counter()
        self._metrics = graph.record(
            lambda: self._eager_step(state, self._batch)[1])
        self.capture_s = time.perf_counter() - t0
        self.graph_pool_B = graph.pool_B
        self._graph = graph
        self.last_kind = "capture"
        return state, metrics

    def _load(self, state: dict, batch: dict) -> None:
        """Copy ``batch`` into the static batch (same keys, shapes and
        dtypes, else raise) and ``state`` into the graph's own tensors
        where it holds others."""
        mine = self._batch
        if batch.keys() != mine.keys() or any(
                batch[k].shape != mine[k].shape
                or batch[k].dtype != mine[k].dtype for k in mine):
            raise ValueError(
                "the captured step takes batches of its first batch's "
                f"keys, shapes and dtypes: "
                f"{ {k: tuple(v.shape) for k, v in mine.items()} }, got "
                f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
        for k, v in batch.items():
            if v is not mine[k]:
                mine[k].copy_(v)
        self._bind(state["params"])
        own, theirs = self._state["opt"], state["opt"]
        if theirs is own:
            return
        with torch.no_grad():
            if theirs["step"] is not own["step"]:
                own["step"].copy_(theirs["step"])
            for part in ("master", "m", "v"):
                for n, t in own[part].items():
                    if theirs[part][n] is not t:
                        t.copy_(theirs[part][n])

    def drop_graph(self) -> None:
        """Drop the captured step, its graph and its private pool (freed
        once nothing holds its metrics): the next step captures again."""
        self._graph = self._batch = self._state = self._metrics = None


def build_train_step(cfg: ModelConfig,
                     opt_cfg: adamw.AdamWConfig | None = None, *,
                     mesh=None, plan: PlacementPlan | None = None,
                     device: str | torch.device = "cuda",
                     graph: bool | None = None) -> TrainStep:
    """The step of ``cfg`` on ``device`` (default CUDA, which raises
    without a card), as one rank of ``mesh`` where given; its model is
    drawn by ``init_state`` (or seed 0 at the first step).  ``plan`` places
    the experts (default: the round robin over the model axis).  ``graph``
    (default: on one CUDA card without a mesh) captures the step once and
    replays it; ``graph=True`` anywhere else raises, ``graph=False`` runs
    it eagerly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_train_step on device 'cuda', but no CUDA "
                           "device is available; pass device='cpu' for the "
                           "plain PyTorch versions")
    on_card = dev.type == "cuda" and mesh is None
    if graph is None:
        graph = on_card
    elif graph and not on_card:
        raise ValueError(f"a captured step runs on one CUDA card without a "
                         f"mesh, not on {dev}"
                         + (" under a mesh" if mesh is not None else ""))
    return TrainStep(cfg, opt_cfg or adamw.AdamWConfig(), dev, mesh=mesh,
                     plan=plan, graph=graph)

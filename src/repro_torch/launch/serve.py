"""Batched serving launcher: one prefill, then greedy decode, on one device
or over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --requests 4 --prompt-len 2048 --gen 32 [--reduced --layers N] \\
        [--device cpu] [--mesh DxM [--backend gloo|nccl]] \\
        [--replicated-placement | --online-placement --epochs E]

The twin of the JAX package's ``launch/serve.py``.
Weights come from a seeded ``torch.Generator`` and prompts from a seeded
numpy generator, as the JAX launcher serves from seeded random init; a
vision model (``llama-3.2-vision-11b``) also gets the launcher's stub
image embeddings, drawn from the same generator right after the prompts
(``draw_batch``).
``serve`` runs the loop -- one ``prefill``, then ``G - 1`` greedy
decode steps, one host read per token -- and returns the tokens, the
timings and the kernel launch counts of the run.

A decode step is ``GreedyStep``: the embedding of a static token buffer,
every layer (the caches written in place), the head, the argmax into the
same buffer and ``pos += 1``, all on the device -- the JAX launcher's
jitted ``decode_step`` with its traced ``pos``.  On one card (CUDA, no
mesh) the first step runs eagerly, then one step is captured in a
``torch.cuda.CUDAGraph`` and replayed for the other ``G - 2``
(``ServeResult.decode == "graph"``); on the CPU and under a mesh (gloo's
collectives go through the host) every step runs eagerly (``"eager"``).
A capture that fails raises.

Under a mesh (``--mesh DxM``: D data ranks by M model ranks, spawned one
process each; or ``serve`` under ``parallel.sharding.use_mesh``) each data
rank serves its rows of the requests, the model axis holds the experts
(``n_shards`` = M): the model gathers its dense leaves once and keeps its
slot weights (``Model.gather_dense_``, ``place_slots_``).  On one device
the plan's slot weights are placed once too (for the round robin they
are the experts' own tensors).

For an MoE model the placement flags plan where the experts go, as the
JAX launcher does: ``--replicated-placement`` profiles the router on the
prompts (``Model.route_trace``, every rank on all of them, so that every
rank plans the same) and plans a replicated placement with hypergraph
partitioning; ``--online-placement`` feeds ``--epochs`` epochs of router
traffic to the ``OnlineController``.  Both plan for ``max(M, 2)`` shards
and report the plan's costs; serving adopts the plan once the model axis
reaches 2, and keeps the round robin over M shards below, as the JAX
launcher does.  The report gives the all_to_all bytes of one prefill
layer under the adopted plan (``models.moe.a2a_bytes``).  The controller
prices a migration at 1 MiB per expert, the JAX launcher's figure (it
reads a config field that does not exist: ROADMAP Queue 3 d).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config, list_archs, reduce_config
from ..core.placement import OnlineController, plan_expert_placement
from ..kernels import ops
from ..models.config import ModelConfig
from ..models.model import Model
from ..models.moe import a2a_bytes
from ..parallel import sharding as shd
from .mesh import default_backend, make_mesh, run_ranks


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray           # (B, G) generated ids
    prefill_s: float             # prompt in, first token read on the host
    decode_s: float              # the G - 1 decode steps
    launches: dict               # kernel launches of the run, per counter
    placement: dict | None = None  # what the placement flag planned
    a2a_bytes: dict | None = None  # one prefill MoE layer's, this rank's
    weight_bytes: int = 0        # the model's parameters as served
    prefill_logits: np.ndarray | None = None   # (B, 1, V) f32
    decode: str = "eager"        # "graph": replays of a captured step
    capture_s: float = 0.0       # the capture, not in decode_s

    @property
    def ms_per_token(self) -> float:
        steps = self.tokens.shape[1] - 1
        return 1e3 * self.decode_s / steps if steps else float("nan")

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / (self.prefill_s + self.decode_s)


def make_model(cfg: ModelConfig, *, device: str | torch.device = "cuda",
               seed: int = 0) -> Model:
    """The model with weights drawn from ``seed`` on ``device``; under the
    active mesh, this rank's part (the experts over the model axis)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving on 'cuda', but no CUDA device is "
                           "available; pass device='cpu'")
    return Model(cfg, n_ep_shards=_n_shards(), device=dev,
                 generator=torch.Generator(device=dev).manual_seed(seed))


def make_prompts(cfg: ModelConfig, B: int, S: int,
                 seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def draw_batch(cfg: ModelConfig, rng: np.random.Generator, B: int,
               S: int) -> dict:
    """The JAX launcher's draws from ``rng``, in its order: ``tokens`` (B,
    S) int32, then for a vision model ``image_embeds`` (B, N, D), standard
    normals in f32 (the model casts them to its dtype)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_image_tokens:
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _n_shards() -> int:
    """The active mesh's model axis (1 without a mesh)."""
    mesh = shd.active_mesh()
    return 1 if mesh is None else shd.axis_sizes(mesh).get("model", 1)


def _replicated_placement(model: Model, tokens: torch.Tensor) -> dict:
    """Plan a replicated placement from the router's choices on the
    prompts (the first MoE segment's layers, as the JAX launcher)."""
    cfg = model.cfg
    trace = model.route_trace({"tokens": tokens})[0].reshape(
        -1, cfg.top_k).cpu().numpy()
    res = plan_expert_placement(
        np.sort(trace, axis=1), cfg.n_experts, max(_n_shards(), 2),
        kappa0=min(1000, 8 * len(trace)), device=model.device)
    return {"kind": "replicated", "n_shards": res.plan.n_shards,
            "plan": res.plan,
            "lambda_cost_no_repl": res.lambda_cost_no_repl,
            "lambda_cost_repl": res.lambda_cost_repl,
            "local_fraction_no_repl": res.local_fraction_no_repl,
            "local_fraction_repl": res.local_fraction_repl}


def _online_placement(model: Model, rng: np.random.Generator, B: int,
                      S: int, epochs: int) -> dict:
    """Feed ``epochs`` epochs of router traffic (fresh prompts each) to
    the online controller, as the JAX launcher does."""
    cfg = model.cfg
    n_sh = max(_n_shards(), 2)
    slots = cfg.n_experts // n_sh + max(2, cfg.n_experts // (4 * n_sh))
    ctrl = OnlineController(cfg.n_experts, n_sh, slots,
                            kappa0=min(1000, 8 * B * S), warmup_epochs=2,
                            bytes_per_expert=1 << 20, device=model.device)
    reports = []
    for epoch in range(epochs):
        prompts = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        traces = model.route_trace(
            {"tokens": torch.from_numpy(prompts).to(model.device)})
        chunk = np.sort(traces[0].reshape(-1, cfg.top_k).cpu().numpy(),
                        axis=1)
        rep = ctrl.step(chunk)
        reports.append({"epoch": epoch, "planned": rep.plan is not None,
                        "cost_keep": rep.cost_keep,
                        "cost_new": rep.cost_new,
                        "containment": rep.containment,
                        "committed": rep.committed,
                        "migration_bytes": rep.migration_bytes})
    return {"kind": "online", "n_shards": n_sh, "epochs": reports,
            "plan": ctrl.plan,
            "commits": ctrl.n_commits,
            "migration_bytes": ctrl.total_migration_bytes}


class GreedyStep:
    """One greedy decode step of ``model`` over static state: ``token``
    (B, 1) int64, ``caches`` (written in place) and ``pos``, a 0-d int32
    tensor on the device.  A step embeds ``token``, runs every layer and
    the serving head (``logits``, (B, 1, V) f32), writes the argmax into
    ``token`` and adds one to ``pos``, all on the device; the caller reads
    ``token`` after it.

    Called, it runs the step: eagerly, or once ``capture`` has recorded
    it, as a replay of that ``torch.cuda.CUDAGraph`` (no host work but the
    launch).  With ``graph`` the step is held by a ``kernels.ops.Captured``
    (``graph``), whose stream the eager steps run on, so that every lazy
    set-up (libraries, workspaces, the caches of plan tables) is done
    before the capture, and which books the capture's launches once a
    replay.  A capture that fails raises: nothing falls back to eager
    steps."""

    def __init__(self, model: Model, token: torch.Tensor, caches: list,
                 pos: int, graph: bool = False):
        dev = token.device
        if graph and dev.type != "cuda":
            raise ValueError(f"a captured step runs on CUDA, not {dev}")
        self.model, self.caches = model, caches
        self.token = token.to(torch.int64).clone()
        self.pos = torch.full((), pos, dtype=torch.int32, device=dev)
        self.logits: torch.Tensor | None = None
        self.graph = ops.Captured(dev) if graph else None

    def _step(self) -> None:
        logits, _ = self.model.decode_step(self.token, self.caches, self.pos)
        self.token.copy_(logits[:, -1].argmax(dim=-1, keepdim=True))
        self.pos.add_(1)
        self.logits = logits

    def __call__(self) -> None:
        if self.graph is None:
            self._step()
        elif self.graph.graph is None:
            self.graph.warm(self._step)
        else:
            self.graph()

    def capture(self) -> None:
        """Record one step (it does not run) for the later calls."""
        if self.graph is None:
            raise RuntimeError("GreedyStep(graph=True) captures")
        self.graph.record(self._step)

    def load(self, token: torch.Tensor, caches: list, pos: int) -> None:
        """Set the state to copies of ``token``, ``caches`` (of the same
        layout) and ``pos``, in place: a captured step keeps its
        buffers."""
        self.token.copy_(token)
        for mine, theirs in zip(_tensors(self.caches), _tensors(caches),
                                strict=True):
            mine.copy_(theirs)
        self.pos.fill_(pos)


def _tensors(tree):
    """The tensors of nested lists and dicts, dicts in key order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for name in sorted(tree):
            yield from _tensors(tree[name])
    else:
        for item in tree:
            yield from _tensors(item)


def _local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (over the mesh's batch axes)."""
    mesh = shd.active_mesh()
    return t if mesh is None else shd.Sharding(
        mesh, (shd.batch_entry(),)).local(t)


@torch.inference_mode()
def serve(cfg: ModelConfig, B: int, S: int, G: int, *,
          device: str | torch.device = "cuda", seed: int = 0,
          placement: str | None = None, epochs: int = 6,
          capacity_factor: float | None = None) -> ServeResult:
    """Serve ``B`` random prompts of ``S`` tokens, ``G`` new tokens each
    (greedy), from weights and prompts drawn from ``seed``; under the
    active mesh, as this rank (its rows of the requests; the tokens are
    those rows').

    ``placement`` (an MoE model): ``None``, ``"replicated"`` or
    ``"online"`` (``epochs`` epochs of traffic); it is planned before the
    prefill, and its report, with the kernel launches the planning made,
    is the result's ``placement``.  ``capacity_factor`` replaces the
    served plan's.  The launch counts are reset just before the prefill,
    so the result's are the served run's."""
    if placement not in (None, "replicated", "online"):
        raise ValueError(f"placement must be None, 'replicated' or "
                         f"'online', got {placement!r}")
    mesh = shd.active_mesh()
    model = make_model(cfg, device=device, seed=seed)
    if mesh is not None:
        model.gather_dense_()
    dev = model.device
    rng = np.random.default_rng(seed)
    batch = {name: torch.from_numpy(a).to(dev)
             for name, a in draw_batch(cfg, rng, B, S).items()}
    report = None
    if placement is not None and cfg.n_experts:
        ops.reset_launches()
        t0 = time.perf_counter()
        if placement == "replicated":
            report = _replicated_placement(model, batch["tokens"])
        else:
            report = _online_placement(model, rng, B, S, epochs)
        report["seconds"] = time.perf_counter() - t0
        report["launches"] = dict(ops.launches)
    plan = model.plan
    if report is not None and _n_shards() >= 2 and report["plan"] is not None:
        plan = report["plan"]
    if plan is not None and capacity_factor is not None:
        plan = dataclasses.replace(plan, capacity_factor=capacity_factor)
    a2a = None
    if plan is not None:
        # the slot weights, gathered once (the identity's are the experts')
        model.place_slots_(plan)
    if mesh is not None and plan is not None:
        B_loc = B // int(np.prod([shd.axis_size(a)
                                  for a in shd.batch_axes()]))
        a2a = a2a_bytes(plan, B_loc * S // plan.n_shards, cfg.top_k,
                        cfg.d_model, model.dtype.itemsize)
    batch = {name: _local_rows(t) for name, t in batch.items()}
    graph = dev.type == "cuda" and mesh is None
    ops.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(batch, max_len=S + G)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok.cpu()]
    t1 = time.perf_counter()
    capture_s = 0.0
    if G > 1:
        step = GreedyStep(model, tok, caches, S, graph=graph)
        step()
        out.append(step.token.to("cpu", copy=True))
        if graph:
            tc = time.perf_counter()
            step.capture()
            capture_s = time.perf_counter() - tc
        for _ in range(G - 2):
            step()
            out.append(step.token.to("cpu", copy=True))
    t2 = time.perf_counter()
    return ServeResult(tokens=torch.cat(out, dim=1).numpy(),
                       prefill_s=t1 - t0, decode_s=t2 - t1 - capture_s,
                       launches=dict(ops.launches), placement=report,
                       a2a_bytes=a2a, weight_bytes=sum(
                           p.numel() * p.element_size()
                           for p in model.parameters()),
                       prefill_logits=logits.float().cpu().numpy(),
                       decode="graph" if graph else "eager",
                       capture_s=capture_s)


def _serve_rank(rank: int, mesh_shape: tuple, device: str, cfg, B, S, G,
                placement, epochs) -> ServeResult:
    """One rank of ``main``'s ``--mesh`` run."""
    mesh = make_mesh(mesh_shape, ("data", "model"), device=device)
    with shd.use_mesh(mesh):
        return serve(cfg, B, S, G, device=device, placement=placement,
                     epochs=epochs)


def main(argv: list[str] | None = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve over D x M ranks ('data', 'model'), one "
                         "process each")
    ap.add_argument("--backend", default=None,
                    help="the ranks' transport (default: nccl on CUDA with "
                         "a card per rank, else gloo)")
    ap.add_argument("--replicated-placement", action="store_true")
    ap.add_argument("--online-placement", action="store_true",
                    help="drift-aware epoch controller instead of a "
                         "one-shot warmup plan")
    ap.add_argument("--epochs", type=int, default=6,
                    help="router-traffic epochs for --online-placement")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, layers_per_segment=args.layers)
    B, S, G = args.requests, args.prompt_len, args.gen
    placement = ("online" if args.online_placement else
                 "replicated" if args.replicated_placement else None)
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        world = shape[0] * shape[1]
        backend = args.backend or default_backend(args.device, world)
        print(f"[serve] mesh {shape} ('data', 'model') over {backend}")
        res = run_ranks(_serve_rank, world, shape, args.device, cfg, B, S,
                        G, placement, args.epochs, backend=backend,
                        device=args.device, timeout=3600)[0]
    else:
        res = serve(cfg, B, S, G, device=args.device, placement=placement,
                    epochs=args.epochs)
    rep = res.placement
    if rep is not None and rep["kind"] == "replicated":
        print(f"[serve] placement: lambda-cost "
              f"{rep['lambda_cost_no_repl']:.1f} -> "
              f"{rep['lambda_cost_repl']:.1f} with replication; local "
              f"fraction {rep['local_fraction_no_repl']:.2f} -> "
              f"{rep['local_fraction_repl']:.2f}")
    elif rep is not None:
        for ep in rep["epochs"]:
            if not ep["planned"]:
                print(f"[serve] epoch {ep['epoch']}: warming up accumulator")
            else:
                print(f"[serve] epoch {ep['epoch']}: cost "
                      f"{ep['cost_keep']:.1f} -> {ep['cost_new']:.1f}, "
                      f"containment {ep['containment']:.2f}, " + (
                          f"migrated {ep['migration_bytes'] >> 20} MiB"
                          if ep["committed"] else "kept placement"))
    print(f"[serve] {B} requests, prompt {S}, generated {G} tokens each "
          f"on {args.device}: prefill {res.prefill_s:.3f}s, decode "
          f"{res.ms_per_token:.2f} ms/token ({res.tokens_per_s:.1f} tok/s; "
          f"{res.decode} decode, capture {res.capture_s:.3f}s)")
    if res.a2a_bytes is not None:
        print(f"[serve] all_to_all bytes a prefill MoE layer, rank 0: "
              f"{res.a2a_bytes}")
    print(f"[serve] kernel launches: {res.launches}")
    print(f"[serve] sample continuation ids: {res.tokens[0][:12].tolist()}")
    return res


if __name__ == "__main__":
    main()

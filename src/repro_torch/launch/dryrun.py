"""Dry run of one step on the meta device: does a cell fit one card, and
what does its step cost?

For each (arch x shape) cell this builds the port's model on the ``meta``
device (shapes and dtypes, no memory, no numbers) and runs the real step
on the meta inputs of ``configs.input_specs``: a training step
(``TrainStep.grads`` then ``update``, the model's ``remat`` as configured),
``Model.prefill``, or one ``Model.decode_step`` against ``init_cache``.
While it runs it holds

- ``torch.utils.flop_counter.FlopCounterMode`` for the FLOPs of PyTorch's
  own operations (the matrix products, the recompute included);
- ``kernels.ops.meta_cost`` for the hand-written kernels, which on meta
  tensors allocate their outputs and count the FLOPs and bytes of their
  bounds instead of launching (the fused AdamW update's bytes among them,
  one call a leaf; the loss head's bf16 product is PyTorch's, counted
  above, with no f32 copy of the head);
- ``MetaMemory``, which follows every storage alive on the meta device
  from the step's arguments on, for the peak, and sums the bytes that
  each PyTorch operation reads and writes;
- ``roofline.hlo.CollectiveCounter`` (0 on one card), the collective
  bytes by kind.

and writes the JAX package's cell keys (``cell``, ``status``, ``arch``,
``shape``, ``mesh``, ``chips``, ``seconds``, ``memory``, ``cost``,
``collectives``, ``params``, ``active_params``) plus the port's own:
``leaves`` (the model's parameters, counted), ``param_bytes`` (theirs),
``state_bytes`` (the training state: parameters, f32 master, m and v),
``kernel_calls`` and
``step_cost`` (``roofline.model`` at dp = tp = 1, for comparison).  The
predicted peak leaves out the CUDA allocator's rounding and the decode
kernel's few-kilobyte workspace.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b \\
        --shape train_4k [--all] [--tag T] [--out DIR] [--mesh DxM]

Output: ``<out>/<cell>.json``, ``out`` defaulting to ``dryrun_out/`` at
the root of the checkout (listed in ``.gitignore``).

``--multi-pod`` prices a cell as rank 0 of the (2, 16, 16) production
mesh, ``--both-meshes`` of (16, 16) and of (2, 16, 16) (cells
``...__gpu256``, ``...__gpu512``), ``--mesh DxM`` of a (D, M) mesh
('data', 'model'), and ``run_cell(..., mesh=fake_mesh(shape))`` of any
mesh: the process is rank 0 of a fake process group of that size (``torch.testing``'s ``FakeStore``, backend ``"fake"``), the model
holds rank 0's blocks on the meta device, the batch is rank 0's part (``TrainStep.local_batch``
for training: its rows, and under ``dp_seq`` its block of the sequence; a
cell whose batch does not split over the data axes is skipped), serving
holds its dense leaves whole and its experts in the round robin over the
model axis, and ``MetaCollectives`` answers the collectives with meta
tensors of their results' shapes.  A training step takes the families'
routes on the model axis (``parallel.sharding.tp_split``): a ``tp``
family holds its blocks and its products' psums count as all-reduces,
a ``gathered`` one its all-gathers; on a split sequence each family
takes its sequence route (``parallel.sharding.seq_split``: the K/V
gathers of the GQA layers and their reduce-scatters, the attention
kernels' costs at rank 0's query offset).  Parameters, state bytes, the
peak, FLOPs and collective bytes are rank 0's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import (SHAPES, cell_is_applicable, get_config, input_specs,
                       list_archs)
from ..configs.shapes import Shape
from ..kernels import ops
from ..models.model import Model
from ..launch.mesh import make_mesh
from ..parallel import sharding as shd
from ..roofline.hlo import CollectiveCounter, summarize_cost
from ..roofline.model import step_cost
from ..train.step import batch_to, build_train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"


def _tensors(tree) -> list:
    """The tensors of a (nested) dict, list or tuple."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaMemory(TorchDispatchMode):
    """The bytes of live meta storage while held, and their peak.

    ``hold(tree)`` counts the storages of the tensors in ``tree`` (a dict,
    list or tensor) as live from then on, until they die; each operation's
    outputs whose storage is new count from the operation on, until the
    storage dies (a finalizer on the storage: the meta device frees
    nothing else).  ``live`` and ``peak`` are bytes.  ``accessed`` sums,
    over every operation that is not a view and does not only allocate
    (``empty``), the bytes of its tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self._held: dict[int, int] = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def hold(self, tree) -> int:
        """Count the storages of ``tree`` as live; returns their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and not func.__name__.startswith(
                ("empty", "new_empty")):
            self.accessed += sum(_nbytes(t) for t in _tensors(
                (args, kwargs, out)))
        for t in _tensors(out):
            if t.device.type == "meta":
                self._track(t)
        return out


class MetaCollectives(TorchDispatchMode):
    """The functional collectives on meta tensors: a meta tensor of each
    result's shape (a fake process group moves nothing)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace != "_c10d_functional" or not args[0].is_meta:
            return func(*args, **kwargs)
        x, name = args[0], func._opname
        rest = tuple(x.shape[1:])
        if name == "wait_tensor":
            return x
        if name == "all_reduce":
            return torch.empty_like(x)
        if name == "all_gather_into_tensor":
            return x.new_empty((x.shape[0] * args[1],) + rest)
        if name == "reduce_scatter_tensor":
            return x.new_empty((x.shape[0] // args[2],) + rest)
        if name == "all_to_all_single":
            return x.new_empty((sum(args[1]),) + rest)
        raise NotImplementedError(f"{func} on meta tensors")


def fake_mesh(shape: tuple, axes: tuple = ("data", "model")):
    """Rank 0 of a ``shape`` mesh with axis names ``axes`` over a fake
    process group (started here once per size; ``main`` ends it)."""
    import math
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return make_mesh(shape, axes, device="cpu")


def _state_bytes(state: dict) -> int:
    """Bytes of the training state: parameters, f32 master, m and v."""
    return sum(_nbytes(t) for part in (state["params"],
                                       state["opt"]["master"],
                                       state["opt"]["m"], state["opt"]["v"])
               for t in part.values())


def run_cell(arch: str, shape: str | Shape, tag: str = "",
             overrides: dict | None = None, mesh=None) -> dict:
    """The dry run of ``arch`` (with ``overrides``, a dict of config
    fields) at ``shape`` (a name of ``SHAPES`` or a ``Shape``) on one card,
    the experts (if any) in the model's one-shard round robin, or as rank
    0 of ``mesh`` (``fake_mesh``): the cell's dict (see the module
    docstring), or a ``skipped`` one where the cell does not apply."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    if not isinstance(shape, Shape):
        shape = SHAPES[shape]
    ok, why = cell_is_applicable(cfg, shape)
    chips = 1 if mesh is None else mesh.size()
    cell = f"{arch}__{shape.name}__gpu{chips}{tag}"
    sizes = {"data": 1, "model": 1} if mesh is None else shd.axis_sizes(mesh)
    dp = chips // sizes["model"]
    if ok and shape.global_batch % dp:
        ok, why = False, (f"a batch of {shape.global_batch} does not split "
                          f"over {dp} data ranks")
    if not ok:
        return {"cell": cell, "status": "skipped", "reason": why}
    with shd.use_mesh(mesh), MetaCollectives():
        return _run_cell(cfg, arch, shape, cell, mesh, sizes, dp)


def _run_cell(cfg, arch: str, shape: Shape, cell: str, mesh, sizes: dict,
              dp: int) -> dict:
    t0 = time.time()
    batch = batch_to(input_specs(cfg, shape), "meta")   # ids as int64
    if mesh is not None and shape.kind != "train":     # rank 0's rows
        rows = shd.Sharding(mesh, (shd.batch_entry(),))
        batch = {k: rows.local(v) for k, v in batch.items()}
    ops.reset_meta_cost()
    mem = MetaMemory()
    flops = FlopCounterMode(display=False)
    coll = CollectiveCounter()
    state_bytes = None
    if shape.kind == "train":
        ts = build_train_step(cfg, device="meta", mesh=mesh)
        batch = ts.local_batch(batch)
        state = ts.init_state(0)
        model = ts.model
        state_bytes = _state_bytes(state)
        with flops, mem, coll:
            arg_bytes = mem.hold((state, batch))
            params, _ = ts.grads(state, batch)
            ts.update(state, params)
            out = None
    else:
        model = Model(cfg, n_ep_shards=sizes["model"], device="meta")
        if mesh is not None:      # as launch.serve holds them
            model.gather_dense_()
            if model.plan is not None:
                model.place_slots_(model.plan)
        with torch.no_grad(), flops, mem, coll:
            if shape.kind == "prefill":
                arg_bytes = mem.hold((dict(model.named_parameters()), batch))
                out = model.prefill(batch, shape.seq_len)
            else:
                caches = model.init_cache(batch["tokens"].shape[0],
                                         shape.seq_len)
                arg_bytes = mem.hold((dict(model.named_parameters()), batch,
                                      caches))
                out = model.decode_step(batch["tokens"], caches,
                                        shape.seq_len - 1)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        c = step_cost(cfg, B, 1, S, dp, sizes["model"], "decode")
    else:
        c = step_cost(cfg, B, S, S, dp, sizes["model"], shape.kind)
    counted = {"flops": float(flops.get_total_flops()
                              + ops.meta_cost["flops"]),
               "bytes accessed": float(mem.accessed
                                       + ops.meta_cost["bytes"]),
               "bytes accessed kernels": float(ops.meta_cost["bytes"])}
    leaves = sum(p.numel() for p in model.parameters())
    param_bytes = sum(_nbytes(p) for p in model.parameters())
    result = {
        "cell": cell,
        "status": "ok",
        "arch": arch,
        "shape": shape.name,
        "mesh": sizes,
        "chips": dp * sizes["model"],
        "seconds": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": sum(_nbytes(t) for t in _tensors(out)),
            "temp_bytes": mem.peak - arg_bytes,
            "peak_bytes": mem.peak,
        },
        "cost": summarize_cost(counted),
        "collectives": coll.result(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "leaves": leaves,
        "param_bytes": param_bytes,
        "state_bytes": state_bytes,
        "kernel_calls": {k: n for k, n in ops.meta_calls.items() if n},
        "kernel_flops": float(ops.meta_cost["flops"]),
        "step_cost": {k: float(v) for k, v in c.items()},
    }
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="price the cells as rank 0 of a (D, M) mesh "
                         "('data', 'model')")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    # each cell's mesh shape (None: one card, no mesh)
    meshes = ([(16, 16), (2, 16, 16)] if args.both_meshes
              else [(2, 16, 16)] if args.multi_pod
              else [tuple(int(n) for n in args.mesh.lower().split("x"))]
              if args.mesh else [None])

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    try:
        return _cells(args, meshes, archs, shapes, out_dir)
    finally:
        import torch.distributed as dist
        if meshes != [None] and dist.is_initialized():
            dist.destroy_process_group()


def _cells(args, meshes, archs, shapes, out_dir) -> int:
    failures = 0
    for mesh_shape, arch, shape in ((m, a, s) for m in meshes for a in archs
                                   for s in shapes):
        mesh = None if mesh_shape is None else fake_mesh(
            mesh_shape, ("pod", "data", "model") if len(mesh_shape) == 3
            else ("data", "model"))
        chips = 1 if mesh is None else mesh.size()
        cell = f"{arch}__{shape}__gpu{chips}{args.tag}"
        path = out_dir / f"{cell}.json"
        if args.skip_existing and path.exists():
            print(f"[dryrun] {cell}: cached", flush=True)
            continue
        try:
            out = run_cell(arch, shape, tag=args.tag, mesh=mesh)
        except Exception as e:  # noqa: BLE001 -- recorded per cell
            out = {"cell": cell, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            failures += 1
        path.write_text(json.dumps(out, indent=1))
        status = out["status"]
        extra = (f" flops={out['cost'].get('flops', 0):.3g}"
                 f" coll={out['collectives'].get('total_bytes', 0):.3g}B"
                 f" peak={out['memory']['peak_bytes']}"
                 if status == "ok" else
                 out.get("reason", out.get("error", "")))
        print(f"[dryrun] {cell}: {status} {extra} -> {path}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher, on one device or over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --steps 5 --batch 4 --seq 2048 [--device cuda|cpu] \\
        [--mesh DxM [--backend gloo|nccl]] [--reduced --layers N] \\
        [--ckpt-dir DIR] [--ckpt-every K] [--lr LR]

The twin of the JAX package's ``launch/train.py``: seeded weights,
``SyntheticTokenStream`` batches, AdamW with a tenth of the steps as
warm-up, the fault-tolerant ``Trainer`` (checkpoints, restart from the
latest one in ``--ckpt-dir``, under any mesh).  The default device is
CUDA, which raises without a card; ``--device cpu`` runs the plain
PyTorch versions (use ``--reduced`` there).  On one card the step is
captured in a CUDA graph at the first step and replayed (``train.step``);
the launcher prints the form and the capture's seconds.  On the CPU and
over a mesh it runs eagerly.

``--mesh DxM`` trains over D data ranks by M model ranks ('data',
'model'), spawned one process each (gloo on the CPU, e.g. ``--mesh 1x2
--device cpu``; on cards NCCL where each rank has one, else gloo).  Under
``torchrun`` the process group comes from its environment and the mesh
is ``--mesh`` or, as the JAX launcher's default, ``make_host_mesh`` with a
model axis of 2 once there are two ranks.  Without either, one device and
no mesh.  A ``dp_seq`` config (smollm-135m) splits each sequence over the
model axis: ``--arch smollm-135m --mesh 1x2`` trains each rank on its half
of every sequence (``TrainStep.local_batch``).
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from ..configs import get_config, list_archs, reduce_config
from ..data.pipeline import DataConfig
from ..optim import adamw
from ..runtime.trainer import DEFAULT_CKPT_DIR, Trainer, TrainerConfig
from .mesh import default_backend, make_host_mesh, make_mesh, run_ranks


def _train_rank(rank: int, shape: tuple | None, device: str, *args) -> list:
    """One rank of a ``--mesh`` (or torchrun) run: its loss history."""
    mesh = (make_mesh(shape, ("data", "model"), device=device) if shape
            else make_host_mesh(1 if dist.get_world_size() < 2 else 2,
                                device=device))
    return Trainer(*args, device=device, mesh=mesh).run()[1]


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train over D x M ranks ('data', 'model')")
    ap.add_argument("--backend", default=None,
                    help="the ranks' transport (default: nccl on CUDA with "
                         "a card per rank, else gloo)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, layers_per_segment=args.layers)
    shape = (tuple(int(n) for n in args.mesh.lower().split("x"))
             if args.mesh else None)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={args.device} mesh={shape}")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                             total_steps=args.steps)
    targs = (cfg, DataConfig(args.batch, args.seq), tcfg, ocfg)
    if "WORLD_SIZE" in os.environ:             # torchrun
        dist.init_process_group(args.backend or default_backend(
            args.device, int(os.environ["WORLD_SIZE"])))
        try:
            hist = _train_rank(dist.get_rank(), shape, args.device, *targs)
        finally:
            dist.destroy_process_group()
    elif shape:
        world = shape[0] * shape[1]
        backend = args.backend or default_backend(args.device, world)
        print(f"[train] {world} ranks over {backend}")
        hist = run_ranks(_train_rank, world, shape, args.device, *targs,
                         backend=backend, device=args.device,
                         timeout=24 * 3600)[0]
    else:
        trainer = Trainer(*targs, device=args.device)
        _, hist = trainer.run()
        ts = trainer.ts
        print(f"[train] step form {ts.mode}"
              + (f", capture {ts.capture_s:.3f} s (graph pool "
                 f"{ts.graph_pool_B} B)" if ts.capture_s is not None
                 else ""))
    if hist:
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()

"""Training launcher on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --steps 5 --batch 4 --seq 2048 [--device cuda|cpu] \\
        [--reduced --layers N] [--ckpt-dir DIR] [--ckpt-every K] [--lr LR]

The twin of the JAX package's ``launch/train.py`` on one device: seeded
weights, ``SyntheticTokenStream`` batches, AdamW with a tenth of the steps
as warm-up, the fault-tolerant ``Trainer`` (checkpoints, restart from the
latest one in ``--ckpt-dir``).  The default device is CUDA, which raises
without a card; ``--device cpu`` runs the plain PyTorch versions (use
``--reduced`` there).
"""
from __future__ import annotations

import argparse

from ..configs import get_config, list_archs, reduce_config
from ..data.pipeline import DataConfig
from ..optim import adamw
from ..runtime.trainer import DEFAULT_CKPT_DIR, Trainer, TrainerConfig


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, layers_per_segment=args.layers)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={args.device}")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                             total_steps=args.steps)
    trainer = Trainer(cfg, DataConfig(args.batch, args.seq), tcfg, ocfg,
                      device=args.device)
    _, hist = trainer.run()
    if hist:
        print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()

"""Batched serving launcher: one prefill, then greedy decode, on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --requests 4 --prompt-len 2048 --gen 32 [--reduced --layers N] \\
        [--device cpu]

The twin of the JAX package's ``launch/serve.py`` without the mesh and
without the expert-placement flags (they need the MoE path, which the port
does not have yet).  Weights come from a seeded ``torch.Generator`` and
prompts from a seeded numpy generator, as the JAX launcher serves from
seeded random init.  ``serve`` runs the loop -- one ``prefill``, then
``G - 1`` greedy ``decode_step``s, one host read per token -- and returns
the tokens, the timings and the kernel launch counts of the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config, list_archs, reduce_config
from ..kernels import ops
from ..models.config import ModelConfig
from ..models.model import Model


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray           # (B, G) generated ids
    prefill_s: float             # prompt in, first token read on the host
    decode_s: float              # the G - 1 decode steps
    launches: dict               # kernel launches of the run, per counter

    @property
    def ms_per_token(self) -> float:
        steps = self.tokens.shape[1] - 1
        return 1e3 * self.decode_s / steps if steps else float("nan")

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / (self.prefill_s + self.decode_s)


def make_model(cfg: ModelConfig, *, device: str | torch.device = "cuda",
               seed: int = 0) -> Model:
    """The model with weights drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving on 'cuda', but no CUDA device is "
                           "available; pass device='cpu'")
    return Model(cfg, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(seed))


def make_prompts(cfg: ModelConfig, B: int, S: int,
                 seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(cfg: ModelConfig, B: int, S: int, G: int, *,
          device: str | torch.device = "cuda", seed: int = 0) -> ServeResult:
    """Serve ``B`` random prompts of ``S`` tokens, ``G`` new tokens each
    (greedy), from weights and prompts drawn from ``seed``.  The launch
    counts are reset just before the prefill, so the result's are this
    run's."""
    model = make_model(cfg, device=device, seed=seed)
    dev = model.device
    tokens = torch.from_numpy(make_prompts(cfg, B, S, seed)).to(dev)
    ops.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill({"tokens": tokens}, max_len=S + G)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok.cpu()]
    t1 = time.perf_counter()
    for i in range(G - 1):
        logits, caches = model.decode_step(tok, caches, S + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(tok.cpu())
    t2 = time.perf_counter()
    return ServeResult(tokens=torch.cat(out, dim=1).numpy(),
                       prefill_s=t1 - t0, decode_s=t2 - t1,
                       launches=dict(ops.launches))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, layers_per_segment=args.layers)
    B, S, G = args.requests, args.prompt_len, args.gen
    res = serve(cfg, B, S, G, device=args.device)
    print(f"[serve] {B} requests, prompt {S}, generated {G} tokens each "
          f"on {args.device}: prefill {res.prefill_s:.3f}s, decode "
          f"{res.ms_per_token:.2f} ms/token ({res.tokens_per_s:.1f} tok/s)")
    print(f"[serve] kernel launches: {res.launches}")
    print(f"[serve] sample continuation ids: {res.tokens[0][:12].tolist()}")


if __name__ == "__main__":
    main()

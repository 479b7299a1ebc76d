"""Deterministic, shard-aware synthetic data pipeline: a copy of the JAX
package's ``data/pipeline.py`` (numpy only), kept apart so that the port
imports nothing of that package; its batches are bit-equal to the
reference's.

Every (step, shard) pair maps to the same tokens regardless of topology --
restarts and elastic re-sharding resume byte-identically (the fault-
tolerance tests rely on this).  Tokens come from a splitmix64 hash, with a
Zipf-flavored mapping into the vocab so MoE routers see non-uniform data.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.config import ModelConfig


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


class SyntheticTokenStream:
    """Iterator over global batches; `state` is just the step counter, so
    checkpointing the pipeline is trivial."""

    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.dc = data_cfg
        self.step = step

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def next_batch(self) -> dict:
        B, S = self.dc.global_batch, self.dc.seq_len
        base = (np.uint64(self.dc.seed) << np.uint64(40)) \
            + (np.uint64(self.step) << np.uint64(20))
        idx = np.arange(B * (S + 1), dtype=np.uint64) + base * np.uint64(1_000_003)
        h = _splitmix64(idx).astype(np.float64) / 2.0 ** 64
        # Zipf-ish skew: u^3 concentrates mass on low token ids
        toks = (np.minimum(h ** 2.5, 0.999999) * self.cfg.vocab).astype(np.int32)
        toks = toks.reshape(B, S + 1)
        self.step += 1
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if self.cfg.frame_input:
            f = _splitmix64(idx[: B * S * 4]).astype(np.float64) / 2 ** 64
            frames = (f.reshape(B, S, 4) - 0.5).repeat(
                self.cfg.d_model // 4, axis=-1).astype(np.float32)
            out = {"frames": frames, "labels": out["labels"] % self.cfg.vocab}
        if self.cfg.n_image_tokens:
            g = _splitmix64(idx[: B * self.cfg.n_image_tokens]) \
                .astype(np.float64) / 2 ** 64
            out["image_embeds"] = np.tile(
                (g.reshape(B, self.cfg.n_image_tokens, 1) - 0.5),
                (1, 1, self.cfg.d_model)).astype(np.float32)
        out["labels"] = out["labels"] % self.cfg.vocab
        if "tokens" in out:
            out["tokens"] = out["tokens"] % self.cfg.vocab
        return out

"""Fault-tolerant training loop: the JAX package's
``runtime/trainer.py``, on one device or as one rank of a mesh.

  * checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps (the
    state copied to the host, the files written on a worker thread); on
    (re)start the latest step is restored with the data pipeline's cursor,
    so a resumed run sees the same batches;
  * failure handling: an exception in a step restores the last checkpoint,
    at most ``max_failures`` times (``failure_hook(step)`` injects
    failures);
  * straggler watchdog: a step slower than ``straggler_factor`` times the
    trailing median is logged and counted.  On one card the step is
    captured (``train.step``): the step that captures -- the first after a
    start or a restart, which runs eagerly and then records the graph --
    is booked apart (``capture_times``), not against the replays' median;
  * elastic re-scaling: under a mesh every rank draws the same global
    batch and takes its part (``TrainStep.local_batch``: its rows, and
    under ``dp_seq`` its block of the sequence); checkpoints hold full
    leaves (rank 0 writes them gathered), so a run restores under another
    mesh.  The trainer holds its mesh active while it runs and clears it
    when it is done.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..checkpoint.checkpointer import Checkpointer
from ..data.pipeline import DataConfig, SyntheticTokenStream
from ..models.config import ModelConfig
from ..models.moe import round_robin_plan
from ..optim import adamw
from ..parallel import sharding as shd
from ..train import step as step_lib

# checkpoints go under the checkout's ignored build directory by default
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" /
                       "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = DEFAULT_CKPT_DIR
    keep: int = 3
    max_failures: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, opt_cfg: adamw.AdamWConfig | None = None,
                 *, device: str | torch.device = "cuda", failure_hook=None,
                 mesh=None, capacity_factor: float | None = None):
        """``mesh``: train as this process's rank of it.  ``capacity_factor``
        (an MoE model): the round-robin plan's, over the model axis.  On
        one card without a mesh the step is captured
        (``build_train_step``'s default)."""
        self.cfg = cfg
        self.mesh = mesh
        self.tcfg = tcfg
        self.data = SyntheticTokenStream(cfg, data_cfg)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.failure_hook = failure_hook or (lambda step: None)
        self.step_times: list[float] = []
        self.capture_times: list[float] = []
        self.stragglers = 0
        plan = None
        if cfg.n_experts and capacity_factor is not None:
            n_ep = 1 if mesh is None else shd.axis_sizes(mesh).get("model", 1)
            plan = round_robin_plan(cfg.n_experts, n_ep, capacity_factor)
        self.ts = step_lib.build_train_step(cfg, opt_cfg, mesh=mesh,
                                            plan=plan, device=device)
        self.opt_cfg = self.ts.opt_cfg

    # ------------------------------------------------------------- state
    def fresh_state(self, seed: int = 0) -> dict:
        return self.ts.init_state(seed)

    def try_restore(self, state: dict) -> tuple[dict, int]:
        last = self.ckpt.latest_step()
        if last is None:
            return state, 0
        restored, extra = self.ckpt.restore(last, state,
                                            self.ts.state_shardings())
        self.data.restore(extra["data"])
        return restored, int(extra["step"])

    # -------------------------------------------------------------- loop
    def run(self, state: dict | None = None, seed: int = 0):
        with shd.use_mesh(self.mesh):
            out = self._run(state, seed)
        if self.mesh is not None:
            dist.barrier()     # rank 0's last checkpoint is on disk
        return out

    def _run(self, state: dict | None, seed: int):
        state = state if state is not None else self.fresh_state(seed)
        state, start = self.try_restore(state)
        step = start
        failures = 0
        metrics_hist = []
        while step < self.tcfg.steps:
            try:
                batch_np = self.data.next_batch()
                self.failure_hook(step)  # test injection point
                t0 = time.monotonic()
                batch = self.ts.local_batch(
                    step_lib.batch_to(batch_np, self.ts.device))
                state, metrics = self.ts.step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                kind = self.ts.last_kind
                if kind == "capture":
                    self.capture_times.append(dt)
                else:
                    self._watch_straggler(dt, step)
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                metrics_hist.append({"step": step, "loss": loss,
                                     "seconds": dt, "kind": kind})
                step += 1
                if step % self.tcfg.ckpt_every == 0 or step == self.tcfg.steps:
                    self.ckpt.save_async(
                        step, state,
                        extra={"step": step, "data": self.data.state()},
                        shardings=self.ts.state_shardings())
                if step % self.tcfg.log_every == 0:
                    print(f"[train] step {step} loss {loss:.4f} "
                          f"({dt*1e3:.0f} ms)", flush=True)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 -- the restart path
                failures += 1
                print(f"[train] step {step} FAILED ({type(e).__name__}: {e}); "
                      f"restart {failures}/{self.tcfg.max_failures}",
                      flush=True)
                if failures > self.tcfg.max_failures:
                    raise
                self.ckpt.wait()
                state = None
                state = self.fresh_state(seed)
                state, step = self.try_restore(state)
        self.ckpt.wait()
        return state, metrics_hist

    def _watch_straggler(self, dt: float, step: int) -> None:
        if len(self.step_times) >= 5:
            med = statistics.median(self.step_times[-20:])
            if dt > self.tcfg.straggler_factor * med:
                self.stragglers += 1
                print(f"[train] straggler at step {step}: {dt*1e3:.0f}ms "
                      f"vs median {med*1e3:.0f}ms", flush=True)
        self.step_times.append(dt)

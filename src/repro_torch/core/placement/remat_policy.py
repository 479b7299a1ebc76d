"""BSP-replication -> rematerialization bridge (DESIGN.md §2).

In BSP scheduling, replication trades extra *compute* for removed
*communication*.  The training-step analogue: rematerializing a layer's
activations in the backward pass trades recompute FLOPs for removed HBM
traffic (saving residuals to memory is the "communication" -- on TPU the
backward pass "receives" them from HBM).  The trade is governed by the
same comparison the paper's basic heuristic makes per step:

    replicate (remat)  iff  recompute_time < save_traffic_time
                       or   the saved bytes do not fit the HBM budget.

``plan_remat`` evaluates both sides per layer family with the analytic
cost model and returns the checkpoint policy for the step builder.

The JAX package's ``core/placement/remat_policy.py``, formula and
signature unchanged, at the H100's rates (``roofline.model``: 989 TFLOP/s
bf16, 3.35 TB/s) where that package has a TPU's.  Nothing on the training
path calls it: the model's ``remat`` comes from its config.
"""
from __future__ import annotations

import dataclasses

from ...models.config import ModelConfig
from ...roofline.model import HBM_BW, PEAK_FLOPS


@dataclasses.dataclass
class RematDecision:
    policy: str               # 'none' | 'dots' | 'full'
    recompute_seconds: float  # extra fwd per device per step
    save_seconds: float       # HBM traffic of saved activations
    save_bytes: int           # bytes of saved residuals+intermediates
    fits_budget: bool


def plan_remat(cfg: ModelConfig, B: int, S: int, dp: int, tp: int,
               hbm_budget_bytes: float = 8e9) -> RematDecision:
    """Decide the activation-checkpoint policy for (cfg, shape, mesh)."""
    from ...roofline.model import step_cost

    fwd = step_cost(cfg.with_(remat="none"), B, S, S, dp, tp, "prefill")
    recompute_s = fwd["flops"] / PEAK_FLOPS

    # bytes that must live until the backward pass without remat:
    # residual stream per layer + the larger ffn/attention intermediates
    T_dev = B * S / dp
    D = cfg.d_model
    L = cfg.n_layers
    resid = T_dev * D * 2 * L
    inter = 0.0
    for seg in cfg.segments:
        n = seg.n_layers * seg.sub_layers
        width = max(cfg.d_ff, cfg.moe_d_ff * cfg.top_k,
                    2 * cfg.d_inner if cfg.ssm_state else 0, D)
        inter += n * T_dev * (width / max(tp, 1)) * 2
    save_bytes = resid + inter
    save_s = save_bytes / HBM_BW

    fits = save_bytes <= hbm_budget_bytes
    if not fits or recompute_s < save_s:
        policy = "full"
    elif resid + inter * 0.3 <= hbm_budget_bytes:
        policy = "none"
    else:
        policy = "dots"  # keep matmul outputs, recompute elementwise
    return RematDecision(policy=policy, recompute_seconds=recompute_s,
                         save_seconds=save_s, save_bytes=int(save_bytes),
                         fits_budget=fits)

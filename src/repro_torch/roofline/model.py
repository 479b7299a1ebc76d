"""Analytic per-device cost model of a step, and its roofline on the H100.

A line-for-line copy of the JAX package's ``roofline/model.py``: FLOPs,
HBM bytes and collective bytes per layer from first principles, scaled by
the layer counts, so ``step_cost`` gives that package's numbers for every
config, shape and (dp, tp).  The port counts the same way because its
dry run (``launch/dryrun.py``) traces one step on the meta device and
cannot see what a kernel moves inside it; the dry run's own counts are set
beside these, not in their place.

All quantities are PER DEVICE per step.  Training FLOPs = fwd x (1 + 2 +
remat); serve = fwd.  SSM mixers are costed with the CUDA scan's traffic
(``kernels/csrc/mamba_scan.cu``: the state stays in registers and shared
memory; u, dt and y cross HBM once, Bc and Cc once), not with a
materialized scan.  MoE layers are costed at the static capacities of the
port's own ``models/moe.py`` (``round_robin_plan``, ``a2a_capacities``).

``roofline_terms`` turns a ``step_cost`` into the three roofline terms
(compute, memory, collective seconds) at the H100 constants below, the
bottleneck, the model FLOPs (6 or 2 x active parameters x tokens) and the
roofline fraction, as ``benchmarks/roofline.py::analyze`` does at a TPU's.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, Segment

BF16 = 2
F32 = 4


def dataclasses_replace_local_fraction(plan, local_fraction: float):
    import dataclasses as _dc
    return _dc.replace(plan, local_fraction=local_fraction)


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    B: int            # global batch
    S: int            # query seq len (1 for decode)
    K: int            # kv/context length
    dp: int           # data-parallel ways (pod*data)
    tp: int           # model-parallel ways
    kind: str         # train | prefill | decode

    @property
    def T(self) -> float:       # tokens per device
        return self.B * self.S / self.dp

    @property
    def fwd_mult(self) -> float:
        if self.kind != "train":
            return 1.0
        return 4.0 if self.cfg.remat == "full" else 3.0


def _mm(ctx: Ctx, d_in: float, d_out: float, tp_shard: bool = True):
    """One activation x weight matmul: returns (flops, act_bytes, w_bytes)."""
    tp = ctx.tp if tp_shard else 1
    flops = 2 * ctx.T * d_in * d_out / tp
    act = ctx.T * (d_in + d_out / tp) * BF16
    w = d_in * d_out / tp * BF16
    return flops, act, w


def _attn_core(ctx: Ctx, H: float, hd_qk: float, hd_v: float,
               causal: bool, window: int):
    """Score + context matmuls per device (heads sharded over tp)."""
    Keff = min(window, ctx.K) if window else ctx.K
    frac = 0.5 if (causal and ctx.S == ctx.K and not window) else 1.0
    flops = 2 * ctx.T * Keff * (hd_qk + hd_v) * (H / ctx.tp) * frac
    # bytes: read q/k/v + write out; kv cache read dominates decode
    kv_bytes = ctx.B / ctx.dp * Keff * (ctx.cfg.n_kv_heads or H) \
        * (hd_qk + hd_v) * BF16 / (ctx.tp if ctx.kind == "decode" else 1)
    act = ctx.T * H / ctx.tp * (hd_qk + hd_v) * BF16 + kv_bytes
    return flops, act


def _segment_layer_cost(ctx: Ctx, seg: Segment) -> dict:
    cfg = ctx.cfg
    D = cfg.d_model
    flops = act = wbytes = coll = 0.0

    def add(f, a, w):
        nonlocal flops, act, wbytes
        flops += f
        act += a
        wbytes += w

    # ---- mixers -------------------------------------------------------
    if seg.attn == "gqa" and seg.kind != "mamba":
        KV, hd = cfg.n_kv_heads, cfg.hd
        H = cfg.n_heads_padded or cfg.n_heads  # physical (padded) heads
        add(*_mm(ctx, D, H * hd, H % ctx.tp == 0))
        add(*_mm(ctx, D, 2 * KV * hd, KV % ctx.tp == 0))
        tp_eff = ctx.tp if H % ctx.tp == 0 else 1
        f, a = _attn_core(ctx, H, hd, hd, seg.causal, seg.sliding_window)
        flops += f * ctx.tp / tp_eff  # unsharded heads replicate core work
        act += a
        add(*_mm(ctx, H * hd, D, H % ctx.tp == 0))
        coll += ctx.T * D * BF16          # output all-reduce (TP)
    elif seg.attn == "mla":
        H = cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rp, vh = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
        add(*_mm(ctx, D, qr, False))                   # wq_a (replicated)
        add(*_mm(ctx, qr, H * (nope + rp)))            # wq_b
        add(*_mm(ctx, D, kvr + rp, False))             # wkv_a
        if ctx.kind == "decode" and cfg.mla_absorb:
            # latent-space attention: q absorb + scores/ctx vs (K, kvr);
            # the latent cache is SHARED across heads (read once)
            flops += 2 * ctx.T * (H / ctx.tp) * nope * kvr      # absorb q
            flops += 2 * ctx.T * ctx.K * (H / ctx.tp) * (kvr + rp)  # scores
            flops += 2 * ctx.T * ctx.K * (H / ctx.tp) * kvr     # latent ctx
            act += ctx.B / ctx.dp * ctx.K * (kvr + rp) * BF16   # cache read
            flops += 2 * ctx.T * (H / ctx.tp) * kvr * vh        # un-absorb
        elif ctx.kind == "decode":
            # naive decode: re-expand EVERY cached latent each step
            rows = ctx.B / ctx.dp * ctx.K
            flops += 2 * rows * kvr * (H / ctx.tp) * (nope + vh)
            act += rows * (kvr + (H / ctx.tp) * (nope + vh)) * BF16
            f, a = _attn_core(ctx, H, nope + rp, vh, True, 0)
            flops += f
            act += a
        else:
            add(*_mm(ctx, kvr, H * (nope + vh)))       # expand latents
            f, a = _attn_core(ctx, H, nope + rp, vh, seg.causal, 0)
            flops += f
            act += a
        add(*_mm(ctx, H * vh, D))
        coll += ctx.T * D * BF16
    if seg.kind in ("mamba", "hybrid"):
        di, N, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        add(*_mm(ctx, D, 2 * di))
        add(*_mm(ctx, di, r + 2 * N))
        add(*_mm(ctx, r, di))
        add(*_mm(ctx, di, D))
        # selective scan (Pallas traffic model): state stays in VMEM
        flops += 9 * ctx.T * (di / ctx.tp) * N
        act += ctx.T * (3 * di / ctx.tp + 2 * N) * BF16
        flops += 2 * ctx.T * (di / ctx.tp) * cfg.d_conv   # depthwise conv
        coll += ctx.T * D * BF16
    if seg.cross_attn:
        # one cross-attn layer per group: amortize over sub_layers
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        Nimg = cfg.n_image_tokens
        share = 1.0 / seg.sub_layers
        f1, a1, w1 = _mm(ctx, D, H * hd)
        flops += f1 * share
        act += a1 * share
        wbytes += w1 * share
        flops += 2 * ctx.T * Nimg * 2 * hd * (H / ctx.tp) * share
        act += ctx.B / ctx.dp * Nimg * KV * 2 * hd * BF16 * share

    # ---- FFN ----------------------------------------------------------
    if seg.kind == "moe":
        E, k, F = cfg.n_experts, cfg.top_k, cfg.moe_d_ff
        add(*_mm(ctx, D, E, False))                    # router
        # cost exactly what the implementation runs: static-capacity buffers
        from ..models.moe import a2a_capacities, round_robin_plan
        import dataclasses as _dc
        plan = round_robin_plan(E, ctx.tp)
        if isinstance(cfg.expert_placement, float):
            plan = _dc.replace(plan, local_fraction=cfg.expert_placement)
        elif isinstance(cfg.expert_placement, tuple):
            lf, cf = cfg.expert_placement
            plan = _dc.replace(plan, local_fraction=lf, capacity_factor=cf)
        if ctx.kind == "decode":
            # tp path: one buffer over all local slots
            T_loc = ctx.B / ctx.dp * ctx.S
            rows = max(1, int(T_loc * k / plan.total_slots
                              * plan.capacity_factor * plan.n_shards)) \
                * plan.slots_per_shard
            coll += ctx.T * D * BF16                   # psum combine
        else:
            T_loc = max(1, int(ctx.B * ctx.S / ctx.dp / ctx.tp))
            cap_local, cap_send, cap_in = a2a_capacities(plan, T_loc, k)
            rows = plan.slots_per_shard * (cap_local + cap_in)
            # dispatch + return all_to_all buffers (bf16 payload)
            coll += 2 * plan.n_shards * cap_send * D * BF16
        flops += 3 * 2 * rows * D * F
        act += rows * (2 * D + F) * BF16
        wbytes += 3 * plan.slots_per_shard * D * F * BF16
        if cfg.n_shared_experts:
            add(*_mm(ctx, D, 3 * cfg.n_shared_experts * F))
    elif cfg.d_ff and seg.kind != "mamba":
        add(*_mm(ctx, D, cfg.d_ff))
        add(*_mm(ctx, D, cfg.d_ff))
        add(*_mm(ctx, cfg.d_ff, D))
        coll += ctx.T * D * BF16
    # norms
    act += 2 * ctx.T * D * BF16
    return {"flops": flops, "act_bytes": act, "w_bytes": wbytes,
            "coll_bytes": coll}


def step_cost(cfg: ModelConfig, B: int, S: int, K: int, dp: int, tp: int,
              kind: str) -> dict:
    """Total per-device cost for one step."""
    if cfg.strategy == "dp_seq":
        dp, tp = dp * tp, 1  # pure data(+sequence) parallelism
    ctx = Ctx(cfg, B, S, K, dp, tp, kind)
    flops = act = wbytes = coll = 0.0
    for seg in cfg.segments:
        c = _segment_layer_cost(ctx, seg)
        n = seg.n_layers * seg.sub_layers
        flops += c["flops"] * n
        act += c["act_bytes"] * n
        wbytes += c["w_bytes"] * n
        coll += c["coll_bytes"] * n
    # embed + head
    V, D = cfg.vocab, cfg.d_model
    flops += 2 * ctx.T * D * V / tp
    act += ctx.T * (D + V / tp) * BF16 + ctx.T * D * BF16
    wbytes += 2 * V * D / tp * BF16
    coll += ctx.T * D * BF16  # logits reduce
    if kind == "train" and cfg.mtp_depth:
        flops *= (1.0 + 0.03 * cfg.mtp_depth)  # one extra layer + head
    mult = ctx.fwd_mult
    flops *= mult
    act *= mult
    coll_bwd = 2.0 if kind == "train" else 1.0
    coll *= coll_bwd
    if kind == "train":
        # gradient reduction over dp + optimizer update traffic
        n_params_dev = cfg.param_count() / tp
        if "ep_data" in cfg.strategy and cfg.n_experts:
            # expert weights also sharded over dp
            expert = (sum(s.n_layers for s in cfg.segments if s.kind == "moe")
                      * 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff)
            n_params_dev -= expert / tp * (1 - 1.0 / dp)
        if dp > 1:
            if cfg.zero_opt_state:
                # ZeRO: bf16 reduce-scatter only (each rank owns a shard)
                coll += n_params_dev * BF16 * (dp - 1) / dp
            else:
                # bf16 ring all-reduce (grads are in the param dtype)
                coll += n_params_dev * BF16 * 2 * (dp - 1) / dp
        opt_div = dp if cfg.zero_opt_state else 1
        wbytes += n_params_dev * (BF16 + F32 * 3) * 2 / opt_div
    return {"flops": flops, "hbm_bytes": act + wbytes, "coll_bytes": coll,
            "act_bytes": act, "w_bytes": wbytes}


# ---- the card: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates) ----
PEAK_FLOPS = 989e12       # bf16 on the tensor cores, FLOP/s
HBM_BW = 3.35e12          # HBM3, B/s
SMS = 132
SM_CLOCK_HZ = 1980e6      # the maximum SM clock
# NVLink 4, per direction; a one-card run has no collective, so no number
# of the port's reads it: it is here for a multi-card cost only
LINK_BW = 450e9


def roofline_terms(cfg: ModelConfig, B: int, S: int, K: int, dp: int,
                   tp: int, kind: str, chips: int = 1) -> dict:
    """``step_cost`` at these arguments as the roofline's terms, in seconds
    at the H100 constants: ``compute`` (FLOPs over ``PEAK_FLOPS``),
    ``memory`` (HBM bytes over ``HBM_BW``), ``collective`` (collective
    bytes over ``LINK_BW``), the ``bottleneck`` (the largest), the
    ``model_flops`` of the B x S tokens (6 in training, else 2, x active
    parameters x tokens), ``useful_ratio`` (model FLOPs over
    all chips' counted FLOPs) and ``roofline_fraction`` (the model FLOP
    rate at the bottleneck's time over one chip's peak)."""
    c = step_cost(cfg, B, S, K, dp, tp, kind)
    terms = {"compute": c["flops"] / PEAK_FLOPS,
             "memory": c["hbm_bytes"] / HBM_BW,
             "collective": c["coll_bytes"] / LINK_BW}
    bottleneck = max(terms, key=terms.get)
    mf = (6 if kind == "train" else 2) * cfg.active_param_count() * B * S
    t_step = max(terms.values())
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"], "bottleneck": bottleneck,
            "model_flops": mf,
            "useful_ratio": mf / (c["flops"] * chips) if c["flops"] else 0.0,
            "roofline_fraction": ((mf / chips / PEAK_FLOPS) / t_step
                                  if t_step else 0.0),
            "cost": c}

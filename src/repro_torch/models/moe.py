"""Mixture-of-Experts layer with replication-aware expert placement: the
JAX package's ``models/moe.py`` on one card.

A ``PlacementPlan`` maps physical *slots* (shard, slot) to experts;
replication is an expert that occupies slots on several shards.  The plan
arithmetic (``_finalize_plan``, ``plan_from_masks``, ``migration_bytes``,
``a2a_capacities``) is the JAX package's, float for float, so the static
buffer capacities come out the same.

Dispatch is sort-based, as there: a stable argsort of the choices by slot
fills static-capacity (n_slots, capacity, D) buffers, first come first
served in (token, choice) order, and a choice past its slot's capacity is
dropped (buffer row -1).  The expert FFN runs its three products on those
buffers through ``ops.grouped_matmul_aligned``: the grouped-matmul kernel
for CUDA tensors, three launches per call.  The slot paths hand it each
slot's fill (``slot_fills``), so the kernel skips the zero rows that pad a
slot past its kept choices: their products are zeros either way, and the
combine never reads them.  Nothing here reads the device
from the host: capacities are Python ints computed from shapes, and the
dispatch uses no ``nonzero`` or boolean-mask indexing.

Execution modes of ``moe_apply``: ``"dense"`` is the single-device
reference (every expert on every token, gated); ``"tp"`` (decode) and
``"a2a"`` (prefill and training) are the slot paths.  The JAX package runs
those two under ``shard_map`` over the mesh's ``model`` axis; the port
runs them in explicit SPMD (``parallel.sharding``): each rank of the
active mesh's ``model`` axis is one shard of the plan and holds its
``slots_per_shard`` slot weights, and without a mesh the plan has one
shard.  ``moe_a2a`` takes the rank's block of the sequence, serves its
local replicas in place and sends the rest through two ``all_to_all``s
(the rows and their slot ids), the results coming back through a third;
``moe_tp`` sees every token and sums the shards' outputs with a psum, each
choice computed by one shard only (the first that holds its expert).  The
JAX package's ``moe_tp`` computes a choice on every shard that holds its
expert, so a replicated expert adds its output once per replica (ROADMAP
Queue 3 i); the port's does not copy that.

The shared experts (deepseek-v3's) run on every token beside the routed
ones.  Given ``tp`` (``parallel.sharding.tp_split`` routes them ``tp``),
each rank runs its column blocks of ``w_gate``/``w_up`` and its row block
of ``w_down``, and a psum over ``tp`` adds them; else they are read whole.
The router is read whole in every case.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import sharding as shd
from .config import ModelConfig
from .layers import swiglu


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Static expert->device placement with replication."""
    n_experts: int
    n_shards: int
    slots_per_shard: int
    slot_expert: tuple   # (n_shards, slots_per_shard); -1 = empty slot
    local_slot: tuple    # (n_shards, n_experts): local slot id or -1
    home_shard: tuple    # (n_shards, n_experts): dest shard when remote
    home_slot: tuple     # (n_shards, n_experts): slot id on dest shard
    local_fraction: float
    capacity_factor: float = 1.25

    @property
    def total_slots(self) -> int:
        return self.n_shards * self.slots_per_shard


def _finalize_plan(shard_slots, n_experts, n_shards, expert_freq,
                   capacity_factor):
    sps = max(len(s) for s in shard_slots)
    slot_expert = -np.ones((n_shards, sps), np.int64)
    local_slot = -np.ones((n_shards, n_experts), np.int64)
    for p, slots in enumerate(shard_slots):
        for i, e in enumerate(slots):
            slot_expert[p, i] = e
            local_slot[p, e] = i
    home_shard = np.zeros((n_shards, n_experts), np.int64)
    home_slot = np.zeros((n_shards, n_experts), np.int64)
    for e in range(n_experts):
        replicas = [p for p in range(n_shards) if local_slot[p, e] >= 0]
        if not replicas:
            raise ValueError(f"expert {e} unplaced")
        for m in range(n_shards):
            best = min(replicas, key=lambda r: min((r - m) % n_shards,
                                                   (m - r) % n_shards))
            home_shard[m, e] = best
            home_slot[m, e] = local_slot[best, e]
    freq = np.ones(n_experts) if expert_freq is None else np.asarray(
        expert_freq, np.float64)
    freq = freq / max(freq.sum(), 1e-9)
    local_fraction = float(sum(
        freq[e] * (np.sum(local_slot[:, e] >= 0) / n_shards)
        for e in range(n_experts)))
    return PlacementPlan(
        n_experts=n_experts, n_shards=n_shards, slots_per_shard=sps,
        slot_expert=tuple(map(tuple, slot_expert.tolist())),
        local_slot=tuple(map(tuple, local_slot.tolist())),
        home_shard=tuple(map(tuple, home_shard.tolist())),
        home_slot=tuple(map(tuple, home_slot.tolist())),
        local_fraction=local_fraction,
        capacity_factor=capacity_factor,
    )


def round_robin_plan(n_experts: int, n_shards: int,
                     capacity_factor: float = 1.25) -> PlacementPlan:
    """No replication: expert e on shard e % n_shards (the baseline)."""
    shard_slots = [[] for _ in range(n_shards)]
    for e in range(n_experts):
        shard_slots[e % n_shards].append(e)
    return _finalize_plan(shard_slots, n_experts, n_shards, None,
                          capacity_factor)


def plan_from_masks(masks, n_experts: int, n_shards: int,
                    expert_freq=None,
                    capacity_factor: float = 1.25) -> PlacementPlan:
    """Plan from partitioner output ``masks`` (bit p of masks[e] = replica
    of expert e on shard p): the solution of hypergraph partitioning with
    replication on the co-activation hypergraph."""
    shard_slots = [[] for _ in range(n_shards)]
    for e in range(n_experts):
        m = int(masks[e])
        for p in range(n_shards):
            if (m >> p) & 1:
                shard_slots[p].append(e)
    return _finalize_plan(shard_slots, n_experts, n_shards, expert_freq,
                          capacity_factor)


def migration_bytes(old_plan: PlacementPlan, new_plan: PlacementPlan,
                    bytes_per_expert: int) -> int:
    """Weight bytes that must move to go from ``old_plan`` to ``new_plan``:
    an expert's weights are copied onto every shard that hosts it in the
    new plan but did not in the old one (dropping a replica is free)."""
    if (old_plan.n_experts != new_plan.n_experts
            or old_plan.n_shards != new_plan.n_shards):
        raise ValueError("plans cover different expert/shard spaces")
    old = np.asarray(old_plan.local_slot) >= 0   # (P, E) replica present
    new = np.asarray(new_plan.local_slot) >= 0
    return int(np.count_nonzero(new & ~old)) * int(bytes_per_expert)


def a2a_capacities(plan: PlacementPlan, T_loc: int, top_k: int):
    """Static buffer capacities of the a2a path: (local, send, receive)
    rows per slot or shard."""
    n_sh = plan.n_shards
    loc_frac = max(plan.local_fraction, 1.0 / n_sh)
    cap_local = max(1, int(np.ceil(
        T_loc * top_k * loc_frac / plan.slots_per_shard
        * plan.capacity_factor * 2)))
    cap_send = max(1, int(np.ceil(
        T_loc * top_k * (1.0 - loc_frac) / n_sh * plan.capacity_factor)))
    cap_in = max(1, int(np.ceil(
        n_sh * cap_send / plan.slots_per_shard * 2)))
    return cap_local, cap_send, cap_in


def a2a_bytes(plan: PlacementPlan, T_loc: int, top_k: int, d_model: int,
              itemsize: int) -> dict:
    """Bytes of the all_to_all result buffers of one rank in one ``moe_a2a``
    call, as ``roofline.hlo.CollectiveCounter`` counts them: ``sent``, the
    rows and their int64 slot ids, and ``returned``, the rows that come
    back (each a block per shard, the rank's own block included)."""
    if plan.n_shards == 1:
        return {"sent": 0, "returned": 0}
    _, cap_send, _ = a2a_capacities(plan, T_loc, top_k)
    rows = plan.n_shards * cap_send
    return {"sent": rows * (d_model * itemsize + 8),
            "returned": rows * d_model * itemsize}


# ------------------------------------------------------------------ routing

def router_topk(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
                axes: tuple = ()):
    """x (T, D) -> weights (T, k) in x's dtype, experts (T, k) int64, and
    the load-balancing aux loss (f32 scalar).  Logits are f32 (x times the
    f32 router).  The top k come from a stable descending sort, so equal
    probabilities keep the lower expert first, as ``lax.top_k`` does.

    The aux loss is E times the dot product of the mean router
    probability and the mean choice count per expert, over the tokens of
    every rank of ``axes`` (the mesh axes the tokens are split over): each
    rank's sums are summed over those axes first, so the loss is that of
    the whole batch on one device, whatever the mesh.  (The JAX package
    averages per-shard aux losses instead, which makes its loss depend on
    the mesh.)"""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = srt[:, :cfg.top_k], order[:, :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True)
    E = cfg.n_experts
    stats = torch.stack([probs.sum(dim=0),
                         F.one_hot(idx, E).float().sum(dim=(0, 1))])
    n = float(x.shape[0])
    if axes:
        stats = shd.psum(stats, axes)
        n *= int(np.prod([shd.axis_size(a) for a in axes]))
    me, ce = stats[0] / n, stats[1] / n
    aux = E * (me * ce).sum()
    return w.to(x.dtype), idx, aux


def sort_dispatch(xt: torch.Tensor, slot_ids: torch.Tensor,
                  keep: torch.Tensor, n_slots: int, capacity: int):
    """Static-shape sparse dispatch.

    xt (T, D); slot_ids/keep (T, k).  Returns
      xin     (n_slots, capacity, D)  the kept choices' tokens grouped per
                                      slot, first come first served in
                                      (t, k) order; over capacity dropped
      buf_of  (T, k) int64            buffer row of each choice, or -1
    """
    T, k = slot_ids.shape
    D = xt.shape[-1]
    dev = xt.device
    flat = torch.where(keep, slot_ids, n_slots).reshape(-1)       # (T*k,)
    order = torch.argsort(flat, stable=True)
    sorted_slot = flat[order]
    starts = torch.searchsorted(sorted_slot,
                                torch.arange(n_slots + 1, device=dev),
                                right=False)
    pos = (torch.arange(T * k, device=dev)
           - starts[sorted_slot.clamp(0, n_slots)])
    ok = (sorted_slot < n_slots) & (pos < capacity)
    dump = n_slots * capacity
    buf_sorted = torch.where(ok, sorted_slot * capacity + pos, dump)
    buf_flat = torch.empty_like(buf_sorted).scatter_(0, order, buf_sorted)
    # every dropped choice writes the dump row, which is cut off below
    token_of_row = torch.full((dump + 1,), T, dtype=torch.int64, device=dev)
    token_of_row.scatter_(0, buf_sorted, order // k)
    src = torch.cat([xt, xt.new_zeros(1, D)])      # row T: an empty row
    # the gather as an embedding lookup whose padding row (the empty row)
    # takes no gradient: indexing's backward would sum the gradients of
    # all the empty rows into that row, one after another on the card
    xin = F.embedding(token_of_row[:-1], src, padding_idx=T)
    xin = xin.reshape(n_slots, capacity, D)
    buf_of = torch.where(buf_flat < dump, buf_flat, -1)
    return xin, buf_of.reshape(T, k)


def slot_fills(slot_ids: torch.Tensor, keep: torch.Tensor, n_slots: int,
               capacity: int) -> torch.Tensor:
    """(n_slots,) int32: the buffer rows of each slot that ``sort_dispatch``
    fills, ``min(kept choices, capacity)``; choices with ``keep`` False are
    not counted.  A scatter-add on the device: ``torch.bincount`` on CUDA
    reads its input's maximum on the host."""
    flat = torch.where(keep, slot_ids, n_slots).reshape(-1)
    counts = torch.zeros(n_slots + 1, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts[:n_slots].clamp(max=capacity)


def combine_from_buffers(yout_flat: torch.Tensor, buf_of: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """yout_flat (rows, D); buf_of (T, k) row ids (-1: dropped); w (T, k).
    The gate-weighted sum over each token's kept choices, (T, D), summed
    in f32 and cast to yout's dtype."""
    kept = (buf_of >= 0)[..., None]
    # every dropped choice reads row 0 and sends it a zero gradient; as an
    # embedding lookup the backward sums a row's many gradients in
    # parallel pieces, where indexing's sums them one after another
    gathered = F.embedding(buf_of.clamp(min=0), yout_flat)      # (T, k, D)
    gathered = torch.where(kept, gathered, 0)
    return torch.einsum("tkd,tk->td", gathered.float(),
                        w.float()).to(yout_flat.dtype)


def _expert_ffn(e_gate: torch.Tensor, e_up: torch.Tensor,
                e_down: torch.Tensor, xin: torch.Tensor,
                fills: torch.Tensor | None = None) -> torch.Tensor:
    """xin (n_slots, C, D) -> (n_slots, C, D) through each slot's SwiGLU:
    three grouped products, each one kernel launch on the card.  With
    ``fills`` (``slot_fills``) the rows of slot g at or past ``fills[g]``
    come out as zeros without being computed; on dispatch buffers, whose
    such rows are zero, that is the same result."""
    S, C, D = xin.shape
    x2 = xin.reshape(S * C, D)
    g = ops.grouped_matmul_aligned(x2, e_gate, C, fills)
    u = ops.grouped_matmul_aligned(x2, e_up, C, fills)
    y = ops.grouped_matmul_aligned(ops.silu_gate(g, u), e_down, C, fills)
    return y.reshape(S, C, D)


# ---------------------------------------------------------------- execution

def _shared(p, tp: str | None) -> dict:
    """The shared experts' leaves of ``p``: under ``tp`` this rank's blocks
    (``Params.tp_block``), else whole."""
    if tp is None:
        return {name: p[name] for name in _SHARED_FFN}
    return {name: p.tp_block(name, dim)
            for name, dim in shd.TP_DIMS["mlp"].items()}


def moe_dense_ref(p, x: torch.Tensor, cfg: ModelConfig,
                  tp: str | None = None):
    """Single-device reference: dense top-k MoE, every expert on every
    token, gated by the router.  Under a mesh whose model axis holds the
    experts in blocks (``_expert_blocks``), each rank runs its block of
    experts on every token and a psum over 'model' adds them: the same
    sum, without gathering the experts."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    w, idx, aux = router_topk(p["router"], xt, cfg)
    blocks = _expert_blocks(p) if _spmd() else None
    e = blocks or {name: p[name] for name in _EXPERTS}
    g = torch.einsum("td,edf->tef", xt, e["e_gate"])
    u = torch.einsum("td,edf->tef", xt, e["e_up"])
    y = torch.einsum("tef,efd->ted", ops.silu_gate(g, u), e["e_down"])
    oh = F.one_hot(idx, cfg.n_experts).to(x.dtype)
    gates = torch.einsum("tk,tke->te", w, oh)
    if blocks is not None:
        per = y.shape[1]
        gates = gates.narrow(1, shd.axis_index("model") * per, per)
    out = torch.einsum("ted,te->td", y, gates)
    if blocks is not None:
        out = shd.psum(out, "model")
    if "w_gate" in p:
        out = out + swiglu(_shared(p, tp), x, tp).reshape(-1, D)
    return out.reshape(B, S, D), aux


@functools.cache
def _tables(plan: PlacementPlan, device: torch.device) -> dict:
    """The plan's lookup tables on ``device``, built once per plan (and
    kept: a captured decode step reads them at every replay, so they must
    outlive it): ``local_slot``, ``home_shard``, ``home_slot`` (n_shards,
    E) and ``owner`` (E,), the first shard that holds each expert."""
    local = np.array(plan.local_slot, np.int64)
    out = {"local_slot": local, "owner": np.argmax(local >= 0, axis=0),
           "home_shard": np.array(plan.home_shard, np.int64),
           "home_slot": np.array(plan.home_slot, np.int64)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _spmd() -> bool:
    """Whether the slot paths run over the active mesh's model axis."""
    mesh = shd.active_mesh()
    return mesh is not None and "model" in mesh.mesh_dim_names


def _shard_of(plan: PlacementPlan) -> int:
    """This rank's shard: its index on the active mesh's model axis, or 0
    without one; the plan must have one shard per rank of that axis."""
    n = shd.axis_size("model") if _spmd() else 1
    if plan.n_shards != n:
        raise ValueError(f"a plan over {plan.n_shards} shards on a model "
                         f"axis of {n} rank(s)")
    return shd.axis_index("model") if n > 1 else 0


def moe_tp(p, x: torch.Tensor, cfg: ModelConfig, plan: PlacementPlan,
           tp: str | None = None):
    """Decode: every shard sees every token (x is the rank's batch, whole
    over the model axis) and computes the choices whose expert's first
    holder it is; a psum over the model axis adds the shards' outputs, so
    each choice counts once.  The aux loss is over the global batch."""
    m = _shard_of(plan)
    B, S, D = x.shape
    T_loc = B * S
    cap = max(1, int(np.ceil(T_loc * cfg.top_k / plan.total_slots
                             * plan.capacity_factor * plan.n_shards)))
    tab = _tables(plan, x.device)
    xt = x.reshape(-1, D)
    w, idx, aux = router_topk(p["router"], xt, cfg,
                              shd.batch_axes() if _spmd() else ())
    slots = tab["local_slot"][m][idx]
    keep = tab["owner"][idx] == m
    n_slots = plan.slots_per_shard
    xin, buf_of = sort_dispatch(xt, slots.clamp(min=0), keep, n_slots, cap)
    fills = slot_fills(slots.clamp(min=0), keep, n_slots, cap)
    yout = _expert_ffn(p["e_gate_slots"], p["e_up_slots"],
                       p["e_down_slots"], xin, fills)
    y = combine_from_buffers(yout.reshape(-1, D), buf_of, w)
    if _spmd():
        y = shd.psum(y, "model")
    y = y.reshape(B, S, D)
    if "w_gate" in p:
        y = y + swiglu(p, x, tp)
    return y, aux


def moe_a2a(p, x: torch.Tensor, cfg: ModelConfig, plan: PlacementPlan,
            tp: str | None = None):
    """Prefill and training: the rank takes its block of the sequence
    (the reference's ``in_specs`` ``P(dp, "model", None)``), serves the
    choices of its local replicas in place and sends the rest to their
    home shards through a static-capacity ``all_to_all``, with each row's
    slot id beside it; the home shard's results come back through the
    return ``all_to_all``, and the blocks are gathered along the sequence
    again.  The plan's local fraction sizes the buffers
    (``a2a_capacities``): replication shrinks them.  Over one shard every
    choice is local, and the remote branch, which would dispatch nothing,
    is not run.  The aux loss is over the global batch."""
    m = _shard_of(plan)
    n_sh = plan.n_shards
    B, S, D = x.shape
    if S % n_sh:
        raise ValueError(f"a sequence of {S} over {n_sh} shards")
    S_loc = S // n_sh
    xl = x.narrow(1, m * S_loc, S_loc) if n_sh > 1 else x
    T_loc = B * S_loc
    cap_local, cap_send, cap_in = a2a_capacities(plan, T_loc, cfg.top_k)
    tab = _tables(plan, x.device)
    xt = xl.reshape(-1, D)
    w, idx, aux = router_topk(p["router"], xt, cfg,
                              shd.batch_axes() + ("model",) if _spmd() else ())
    my_local = tab["local_slot"][m][idx]
    is_local = my_local >= 0
    n_slots = plan.slots_per_shard
    slots = my_local.clamp(min=0)
    # ---- local replicas: no communication (the replication win) ----
    xin_l, buf_l = sort_dispatch(xt, slots, is_local, n_slots, cap_local)
    fills_l = slot_fills(slots, is_local, n_slots, cap_local)
    e = (p["e_gate_slots"], p["e_up_slots"], p["e_down_slots"])
    yout_l = _expert_ffn(*e, xin_l, fills_l)
    y = combine_from_buffers(yout_l.reshape(-1, D), buf_l, w * is_local)
    if n_sh > 1:
        # ---- remote dispatch through all_to_all ----
        dest = tab["home_shard"][m][idx]
        dslot = tab["home_slot"][m][idx]
        send_x, buf_r = sort_dispatch(xt, dest, ~is_local, n_sh, cap_send)
        # each row's target slot id travels beside it (-1: an empty row)
        rows = n_sh * cap_send
        payload = torch.full((rows + 1,), -1, dtype=torch.int64,
                             device=x.device)
        payload.scatter_(0, torch.where(buf_r >= 0, buf_r, rows).reshape(-1),
                         dslot.reshape(-1))
        rx = shd.all_to_all(send_x.reshape(rows, D), "model")
        rslot = shd.all_to_all(payload[:rows], "model")
        keep_r = (rslot >= 0)[:, None]
        rs = rslot.clamp(min=0)[:, None]
        xin_r, buf_in = sort_dispatch(rx, rs, keep_r, n_slots, cap_in)
        fills_r = slot_fills(rs, keep_r, n_slots, cap_in)
        yout_r = _expert_ffn(*e, xin_r, fills_r)
        # ---- combine: remote results through the return all_to_all ----
        ret = combine_from_buffers(yout_r.reshape(-1, D), buf_in,
                                   torch.ones_like(buf_in, dtype=x.dtype))
        ret = shd.all_to_all(ret, "model")
        y = y + combine_from_buffers(ret, buf_r, w * ~is_local)
    y = y.reshape(B, S_loc, D)
    if _spmd():
        y = shd.all_gather(y, "model", 1)
    if "w_gate" in p:
        y = y + swiglu(p, x, tp)
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, plan: PlacementPlan,
              mode: str, tp: str | None = None):
    """mode: ``"a2a"`` (prefill), ``"tp"`` (decode), ``"dense"`` (the
    reference, and the route trace); ``tp``: the axis the shared experts'
    blocks are over, or None (read whole)."""
    if mode == "dense":
        return moe_dense_ref(p, x, cfg, tp)
    if mode not in ("tp", "a2a"):
        raise ValueError(f"unknown MoE mode {mode!r}")
    p = materialize_slots(p, plan, tp)
    if mode == "tp":
        return moe_tp(p, x, cfg, plan, tp)
    return moe_a2a(p, x, cfg, plan, tp)


_SHARED_FFN = ("w_gate", "w_up", "w_down")
_EXPERTS = ("e_gate", "e_up", "e_down")


def slot_experts(plan: PlacementPlan, shard: int | None = None
                 ) -> np.ndarray:
    """The expert of each slot (an empty slot: expert 0), over every shard
    or of ``shard`` only."""
    se = np.array(plan.slot_expert, np.int64)
    se = se.reshape(-1) if shard is None else se[shard]
    return np.maximum(se, 0)


def _expert_blocks(p):
    """Where ``p`` (the model's ``Params``) holds its expert leaves as this
    rank's contiguous block of experts over 'model' and nothing else:
    {name: local block}; else None (the leaves are read whole)."""
    held = getattr(p, "held", None)
    if held is None:
        return None
    out = {}
    for name in _EXPERTS:
        local, sh = held(name)
        if sh is None or sh.spec != ("model", None, None):
            return None
        out[name] = local
    return out


@functools.lru_cache(maxsize=64)
def _exchange(plan: PlacementPlan, shard: int) -> tuple:
    """The static plan of the slot exchange of ``shard``, whose experts
    are stored in contiguous blocks of E / n_shards: (send, take, K).
    ``send`` (n_shards, K): the local indices of the experts this shard
    sends each shard (the experts of that shard's slots that this one
    stores; padded with 0), ``take`` (slots_per_shard,): each slot's row
    in [this shard's block; the received (n_shards * K) experts], K the
    largest count any shard sends any other (0: nothing to exchange)."""
    n, E = plan.n_shards, plan.n_experts
    per = E // n
    needs = [[sorted({int(e) for e in slot_experts(plan, j)
                      if e // per == i}) if i != j else []
              for i in range(n)] for j in range(n)]   # needs[j][i]
    K = max(len(x) for row in needs for x in row)
    send = np.zeros((n, max(K, 1)), np.int64)
    for j in range(n):
        for k, e in enumerate(needs[j][shard]):
            send[j, k] = e - shard * per
    take = []
    for e in slot_experts(plan, shard):
        e, i = int(e), int(e) // per
        take.append(e - shard * per if i == shard
                    else per + i * K + needs[shard][i].index(e))
    return send, np.array(take, np.int64), K


def _slot_weights(w: torch.Tensor, plan: PlacementPlan,
                  shard: int) -> torch.Tensor:
    """This shard's slot weights from its block ``w`` (E / n_shards, ...)
    of an expert leaf: its own experts read in place, the others' through
    one all_to_all of the experts each shard's slots need (differentiable:
    the backward returns each slot's gradient to the expert's block)."""
    send, take, K = _exchange(plan, shard)
    dev = w.device
    if not K and np.array_equal(take, np.arange(len(w))):
        return w                        # the block is the slots
    if K:
        out = w.index_select(0, torch.from_numpy(send.reshape(-1)).to(dev))
        recv = shd.all_to_all(out, "model")
        w = torch.cat([w, recv])
    return w.index_select(0, torch.from_numpy(take).to(dev))


def materialize_slots(p, plan: PlacementPlan, tp: str | None = None) -> dict:
    """Gather logical expert weights (E, D, F) into the physical slot
    layout: this rank's (slots_per_shard, D, F) under a mesh, all n_shards
    * slots_per_shard slots without one.  Under a mesh whose model axis
    splits the expert leaves into contiguous blocks of experts
    (``param_spec``), each rank reads its own experts in place and gets
    the others its slots hold through one exchange per leaf
    (``_slot_weights``); expert leaves held otherwise are read whole.
    Where every slot holds the expert of its own index (one shard) the
    gather is the identity, and the slot weights are the logical ones, not
    a copy.  Differentiable: gradients of replicated slots sum back into
    the logical expert.  The router is read whole, the shared experts as
    ``_shared`` reads them under ``tp``."""
    if "e_gate_slots" in p:
        return p
    out = {"router": p["router"]}
    if "w_gate" in p:
        out.update(_shared(p, tp))
    shard = _shard_of(plan) if _spmd() else None
    blocks = _expert_blocks(p) if shard is not None else None
    if blocks is not None:
        for name in _EXPERTS:
            out[f"{name}_slots"] = _slot_weights(blocks[name], plan, shard)
        return out
    for name in _EXPERTS:
        w = p[name]
        gather = _slot_gather(plan, shard, w.device)
        out[f"{name}_slots"] = w if gather is None else w.index_select(
            0, gather)
    return out


@functools.cache
def _slot_gather(plan: PlacementPlan, shard: int | None,
                 device: torch.device) -> torch.Tensor | None:
    """The expert of each slot (``slot_experts``) on ``device``, uploaded
    once per plan; None where every slot holds the expert of its own
    index."""
    gather = slot_experts(plan, shard)
    if np.array_equal(gather, np.arange(plan.n_experts)):
        return None
    return torch.from_numpy(gather).to(device)

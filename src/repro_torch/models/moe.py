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
``"a2a"`` (prefill) are the slot paths.  The JAX package runs those two
under ``shard_map`` over the mesh's ``model`` axis; the port serves on one
card, as the JAX launcher does on a one-device mesh, so only a plan with
one shard is taken.  Several shards wait for ROADMAP Queue 1, "Distribution".
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
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


# ------------------------------------------------------------------ routing

def router_topk(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """x (T, D) -> weights (T, k) in x's dtype, experts (T, k) int64, and
    the load-balancing aux loss (f32 scalar).  Logits are f32 (x times the
    f32 router).  The top k come from a stable descending sort, so equal
    probabilities keep the lower expert first, as ``lax.top_k`` does."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = srt[:, :cfg.top_k], order[:, :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True)
    E = cfg.n_experts
    me = probs.mean(dim=0)
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
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
    y = ops.grouped_matmul_aligned(F.silu(g) * u, e_down, C, fills)
    return y.reshape(S, C, D)


# ---------------------------------------------------------------- execution

def moe_dense_ref(p, x: torch.Tensor, cfg: ModelConfig):
    """Single-device reference: dense top-k MoE, every expert on every
    token, gated by the router."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    w, idx, aux = router_topk(p["router"], xt, cfg)
    g = torch.einsum("td,edf->tef", xt, p["e_gate"])
    u = torch.einsum("td,edf->tef", xt, p["e_up"])
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, p["e_down"])
    oh = F.one_hot(idx, cfg.n_experts).to(x.dtype)
    gates = torch.einsum("tk,tke->te", w, oh)
    out = torch.einsum("ted,te->td", y, gates)
    if "w_gate" in p:
        out = out + swiglu(p, x).reshape(-1, D)
    return out.reshape(B, S, D), aux


def _one_shard(plan: PlacementPlan) -> None:
    """The slot paths take one shard, which holds every expert once, in
    expert order (both plan builders fill slots by ascending expert): the
    slot of expert e is e and every choice is local."""
    if plan.n_shards != 1:
        raise NotImplementedError(
            f"a plan over {plan.n_shards} shards: the multi-shard slot "
            "paths (experts over several cards): ROADMAP Queue 1, "
            "\"Distribution\"")
    if plan.local_slot[0] != tuple(range(plan.n_experts)):
        raise ValueError("a one-shard plan must hold expert e in slot e")


def moe_tp(p, x: torch.Tensor, cfg: ModelConfig, plan: PlacementPlan):
    """Decode: every shard sees every token and computes its slots; the
    JAX package sums the shards' outputs with a psum, which over one shard
    is the output itself."""
    _one_shard(plan)
    B, S, D = x.shape
    T_loc = B * S
    cap = max(1, int(np.ceil(T_loc * cfg.top_k / plan.total_slots
                             * plan.capacity_factor * plan.n_shards)))
    xt = x.reshape(-1, D)
    w, idx, aux = router_topk(p["router"], xt, cfg)
    keep = torch.ones_like(idx, dtype=torch.bool)       # slot = expert
    n_slots = plan.slots_per_shard
    xin, buf_of = sort_dispatch(xt, idx, keep, n_slots, cap)
    fills = slot_fills(idx, keep, n_slots, cap)
    yout = _expert_ffn(p["e_gate_slots"], p["e_up_slots"],
                       p["e_down_slots"], xin, fills)
    y = combine_from_buffers(yout.reshape(-1, D), buf_of, w)
    y = y.reshape(B, S, D)
    if "w_gate" in p:
        y = y + swiglu(p, x)
    return y, aux


def moe_a2a(p, x: torch.Tensor, cfg: ModelConfig, plan: PlacementPlan):
    """Prefill: sequence-sharded tokens, local replicas served in place
    and the rest sent through a static-capacity all_to_all.  Over one
    shard every choice is local: the remote branch dispatches nothing and
    its combine weight ``w * ~is_local`` is zero, so it adds exact zeros
    and only the local branch runs here."""
    _one_shard(plan)
    B, S, D = x.shape
    T_loc = B * S
    cap_local, _, _ = a2a_capacities(plan, T_loc, cfg.top_k)
    xt = x.reshape(-1, D)
    w, idx, aux = router_topk(p["router"], xt, cfg)
    is_local = torch.ones_like(idx, dtype=torch.bool)   # slot = expert
    n_slots = plan.slots_per_shard
    xin_l, buf_l = sort_dispatch(xt, idx, is_local, n_slots, cap_local)
    fills = slot_fills(idx, is_local, n_slots, cap_local)
    yout_l = _expert_ffn(p["e_gate_slots"], p["e_up_slots"],
                         p["e_down_slots"], xin_l, fills)
    y = combine_from_buffers(yout_l.reshape(-1, D), buf_l, w)
    y = y.reshape(B, S, D)
    if "w_gate" in p:
        y = y + swiglu(p, x)
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, plan: PlacementPlan,
              mode: str):
    """mode: ``"a2a"`` (prefill), ``"tp"`` (decode), ``"dense"`` (the
    reference, and the route trace)."""
    if mode == "dense":
        return moe_dense_ref(p, x, cfg)
    if mode not in ("tp", "a2a"):
        raise ValueError(f"unknown MoE mode {mode!r}")
    p = materialize_slots(p, plan)
    if mode == "tp":
        return moe_tp(p, x, cfg, plan)
    return moe_a2a(p, x, cfg, plan)


_SHARED = ("router", "w_gate", "w_up", "w_down")


def materialize_slots(p, plan: PlacementPlan) -> dict:
    """Gather logical expert weights (E, D, F) into the physical slot
    layout (n_shards * slots_per_shard, D, F).  Where every slot holds
    the expert of its own index (one shard) the gather is the identity,
    and the slot weights are the logical ones, not a copy."""
    if "e_gate_slots" in p:
        return p
    out = {name: p[name] for name in _SHARED if name in p}
    gather = np.maximum(np.array(plan.slot_expert, np.int64).reshape(-1), 0)
    identity = np.array_equal(gather, np.arange(plan.n_experts))
    index = None if identity else torch.from_numpy(gather).to(
        p["e_gate"].device)
    for name in ("e_gate", "e_up", "e_down"):
        out[f"{name}_slots"] = (p[name] if index is None
                                else p[name].index_select(0, index))
    return out

"""Online replicated expert placement: partitioning under live traffic
(the JAX package's ``core/placement/online.py`` over the port's engine).

The warmup bridge (``expert_placement``) plans placement **once**; real
routers drift.  This module treats serving as *incremental* replicated
hypergraph partitioning -- the online data-placement regime of
arXiv 1312.0285 under the per-shard memory cap of arXiv 2507.17411 --
running the partition engine's deltas continuously instead of once:

  1. ``CoActivationAccumulator`` -- exponentially-decayed tuple counts over
     router-trace chunks.  Each epoch it re-selects the frequent-tuple
     hyperedges (same kappa_0 / mu-normalization rule as the paper's moe-8
     construction) and emits a ``HypergraphDelta``: edges born, edges
     expired, edges re-weighted.
  2. ``OnlineController`` -- keeps a live ``PartitionState`` of the current
     placement, syncs each delta through the engine's structural mutations
     (``add_edge`` / ``remove_edge`` / ``update_mu``, each priced
     incrementally and bit-equal to a rebuild), replans on a *throwaway*
     state (the stock heuristics commit after every move, so they never run
     on the live state), then reprices the candidate inside a
     ``begin()``/``commit()``/``rollback()`` transaction.  A re-placement
     commits only when the projected communication savings over
     ``horizon_epochs`` beat the weight-migration bytes with ``hysteresis``
     to spare -- so the placement never thrashes, and stationary traffic
     commits nothing at all.
  3. ``replay_cost`` -- exact (lambda_e - 1) communication cost of a
     placement on a raw trace chunk, token by token: the serving
     simulator's scoring rule (``core.placement.replay`` replays the
     serving benchmark's drifting traffic through it).

``frontier``/``device`` choose the partitioner's gain-pricing path, as in
``core.partition`` (the CUDA kernels by default); every choice takes the
same decisions.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter

import numpy as np
import torch

from ..frontier import partition_front
from ..hypergraph import Hypergraph
from ..partition import partition_heuristic, replicate_local_search
from ..partition.engine import PartitionState, _lambda_from_rows, _tables
from ...datagen.moe_traces import normalize_mu, select_frequent_tuples
from ...models.moe import PlacementPlan, migration_bytes, plan_from_masks

# accumulator entries below this decayed count can never re-enter the
# frequent-tuple selection before decaying to nothing; drop them
_PRUNE_EPS = 0.25


@dataclasses.dataclass
class HypergraphDelta:
    """Edge-set difference between two accumulator snapshots."""
    added: list        # [(pins_tuple, mu)]
    removed: list      # [pins_tuple]
    reweighted: list   # [(pins_tuple, new_mu)] -- surviving edges, new mu

    @property
    def empty(self) -> bool:
        return not (self.added or self.removed or self.reweighted)


class CoActivationAccumulator:
    """Sliding-window co-activation statistics over router-trace chunks.

    ``observe(chunk)`` decays all tuple counts by ``decay``, folds in the
    chunk's exact counts, re-runs the paper's frequent-tuple selection
    (``select_frequent_tuples``: most frequent until >= kappa_0 pins, mu
    normalized to [1, 10]) and returns the delta against the previous
    selection.  ``freq`` tracks the equally-decayed per-expert activation
    counts (feeds ``PlacementPlan.local_fraction``).
    """

    def __init__(self, n_experts: int, kappa0: int = 1000,
                 decay: float = 0.5):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.n_experts = n_experts
        self.kappa0 = kappa0
        self.decay = decay
        self.counts: Counter = Counter()
        self.freq = np.zeros(n_experts, dtype=np.float64)
        self.edges: dict = {}     # current selection: pins_tuple -> mu

    def observe(self, chunk: np.ndarray) -> HypergraphDelta:
        chunk = np.asarray(chunk)
        if chunk.ndim != 2:
            raise ValueError("chunk must be (tokens, top_k)")
        self.counts = Counter({t: c * self.decay
                               for t, c in self.counts.items()
                               if c * self.decay >= _PRUNE_EPS})
        uniq, counts = np.unique(chunk, axis=0, return_counts=True)
        for row, c in zip(uniq, counts):
            self.counts[tuple(int(x) for x in row)] += int(c)
        self.freq = self.freq * self.decay + np.bincount(
            chunk.reshape(-1), minlength=self.n_experts)
        edges, mu = select_frequent_tuples(self.counts, self.kappa0,
                                           chunk.shape[1])
        new = dict(zip(edges, mu))
        added = [(t, m) for t, m in new.items() if t not in self.edges]
        removed = [t for t in self.edges if t not in new]
        reweighted = [(t, m) for t, m in new.items()
                      if t in self.edges and m != self.edges[t]]
        self.edges = new
        return HypergraphDelta(added=added, removed=removed,
                               reweighted=reweighted)

    def hypergraph(self, name: str = "online") -> Hypergraph:
        """Current selection as a full-expert-space hypergraph."""
        return Hypergraph(n=self.n_experts, edges=list(self.edges),
                          mu=np.array(list(self.edges.values()), np.float64),
                          name=name)


@dataclasses.dataclass
class EpochReport:
    """What the controller did with one traffic epoch."""
    epoch: int
    cost_keep: float          # live cost of the current placement
    cost_new: float           # exact repriced cost of the candidate
    committed: bool           # True = placement migrated to the candidate
    migration_bytes: int      # weight bytes moved this epoch (0 if kept)
    replan_seconds: float     # wall time of accumulate+sync+replan+reprice
    containment: float        # drift statistic (1 = no drift since ref)
    plan: PlacementPlan | None  # in effect *after* this epoch (None: warmup)


class OnlineController:
    """Epoch controller: drifting hypergraph in, ``PlacementPlan`` out.

    Memory cap: each shard has ``slots_per_shard`` expert slots (omega = 1
    per expert, so engine loads *are* slot counts); the balance eps handed
    to the partitioner is derived so capacity == slots_per_shard exactly.

    The first ``warmup_epochs`` epochs only feed the accumulator (``plan``
    is ``None``; serve round-robin meanwhile); the placement is planned on
    the last warmup epoch, when the decayed window has converged, and that
    snapshot of the frequent-edge set becomes the drift detector's
    reference.

    Commit gate (all must hold, checked on the speculatively repriced
    candidate):

      containment < drift_threshold          (the traffic actually drifted)
      cost_new < cost_keep * (1 - min_rel_gain)
      (cost_keep - cost_new) * comm_cost_per_unit * horizon_epochs
          > migration_bytes * (1 + hysteresis)

    ``containment`` is the mu-mass fraction of the current frequent-edge
    set already present at the last (re)placement -- a *data* statistic,
    independent of heuristic noise: on stationary traffic it fluctuates in
    a tight band well above the threshold (measured ~0.76+ at the moe-8
    scale with the default decay), so stationary traffic commits exactly
    zero migrations no matter how lucky a replan gets; under drift it
    decays through the threshold within a few epochs.  ``min_rel_gain``
    then filters noise-level candidates and ``hysteresis`` demands the
    horizon savings clear the migration bill with margin, so back-and-forth
    drift cannot thrash the placement.

    ``comm_cost_per_unit`` converts the engine's abstract mu * (lambda - 1)
    units into bytes of cross-shard activation traffic per epoch.  The
    default assumes moe-8 scale: one cost unit ~ one frequent tuple's
    epoch-worth of token hops (~10^2..10^3 tokens x a ~KB activation), i.e.
    512 KiB -- against the 1 MiB default expert weights, an accumulated
    drift gain of a few dozen cost units pays for re-placing a handful of
    experts, while noise-level gains never do.  Serving stacks should set
    both knobs from their real d_model / dtype / traffic volume.
    """

    def __init__(self, n_experts: int, n_shards: int, slots_per_shard: int,
                 *, kappa0: int = 1000, decay: float = 0.7,
                 warmup_epochs: int = 4, drift_threshold: float = 0.6,
                 bytes_per_expert: int = 1 << 20,
                 comm_cost_per_unit: float = float(1 << 19),
                 horizon_epochs: int = 4, hysteresis: float = 0.25,
                 min_rel_gain: float = 0.05, restarts: int = 2,
                 max_replicas: int | None = None, seed: int = 0,
                 frontier: str | None = None,
                 device: str | torch.device = "cuda"):
        if slots_per_shard * n_shards <= n_experts:
            raise ValueError(
                "no spare slots: slots_per_shard * n_shards must exceed "
                "n_experts (replication needs headroom)")
        self.n_experts = n_experts
        self.n_shards = n_shards
        self.slots_per_shard = slots_per_shard
        self.eps = slots_per_shard * n_shards / n_experts - 1.0
        self.kappa0 = kappa0
        self.warmup_epochs = max(1, int(warmup_epochs))
        self.drift_threshold = drift_threshold
        self.bytes_per_expert = int(bytes_per_expert)
        self.comm_cost_per_unit = comm_cost_per_unit
        self.horizon_epochs = horizon_epochs
        self.hysteresis = hysteresis
        self.min_rel_gain = min_rel_gain
        self.restarts = restarts
        self.max_replicas = max_replicas
        self.seed = seed
        partition_front.check_device(frontier, device)
        self.frontier = frontier
        self.device = device
        self.acc = CoActivationAccumulator(n_experts, kappa0=kappa0,
                                           decay=decay)
        self.state: PartitionState | None = None
        self.plan: PlacementPlan | None = None
        self._tuple_of: list = []   # engine edge id -> pins tuple
        self._edge_of: dict = {}    # pins tuple -> engine edge id
        self._ref_edges: set = set()   # frequent edges at last (re)placement
        self.epoch = 0
        self.n_commits = 0
        self.total_migration_bytes = 0

    # ------------------------------------------------------------- internals
    def _replan(self, hg: Hypergraph, warm: np.ndarray | None) -> np.ndarray:
        """Candidate masks for ``hg``: fresh heuristic + replication vs a
        replication re-search warm-started from the current placement;
        ties prefer the warm start (fewer migrations).  Deterministic
        given ``hg`` (fixed seed)."""
        kw = {"frontier": self.frontier, "device": self.device}
        fresh = partition_heuristic(hg, self.n_shards, self.eps,
                                    restarts=self.restarts, seed=self.seed,
                                    **kw)
        best = replicate_local_search(hg, fresh.masks.copy(), self.n_shards,
                                      self.eps, max_replicas=self.max_replicas,
                                      seed=self.seed, **kw)
        if warm is not None:
            w = replicate_local_search(hg, warm.copy(), self.n_shards,
                                       self.eps,
                                       max_replicas=self.max_replicas,
                                       seed=self.seed, **kw)
            if w.cost <= best.cost:
                best = w
        return np.asarray(best.masks, dtype=np.int64)

    def _sync_delta(self, delta: HypergraphDelta) -> None:
        """Replay an accumulator delta through the engine's structural
        mutations, tracking the swap-remove edge-id renames."""
        st = self.state
        for tup in delta.removed:
            ei = self._edge_of.pop(tup)
            st.remove_edge(ei)
            moved = self._tuple_of.pop()       # tuple formerly last
            if moved != tup:
                self._tuple_of[ei] = moved
                self._edge_of[moved] = ei
        for tup, mu in delta.added:
            ei = st.add_edge(list(tup), mu)
            self._edge_of[tup] = ei
            self._tuple_of.append(tup)
        for tup, mu in delta.reweighted:
            st.update_mu(self._edge_of[tup], mu)

    def _containment(self) -> float:
        """mu-mass fraction of the current frequent edges already present
        at the last (re)placement -- the drift statistic."""
        tot = sum(self.acc.edges.values())
        hit = sum(m for t, m in self.acc.edges.items()
                  if t in self._ref_edges)
        return float(hit / max(tot, 1e-9))

    def _bootstrap(self, t0: float) -> EpochReport:
        hg = self.acc.hypergraph()
        masks = self._replan(hg, warm=None)
        self.state = PartitionState(hg, self.n_shards, masks=masks)
        self._tuple_of = list(self.acc.edges)
        self._edge_of = {t: i for i, t in enumerate(self._tuple_of)}
        self._ref_edges = set(self.acc.edges)
        self.plan = plan_from_masks(masks, self.n_experts, self.n_shards,
                                    expert_freq=self.acc.freq)
        cost = float(self.state.cost)
        return EpochReport(epoch=self.epoch, cost_keep=cost, cost_new=cost,
                           committed=False, migration_bytes=0,
                           replan_seconds=time.perf_counter() - t0,
                           containment=1.0, plan=self.plan)

    # ------------------------------------------------------------------ step
    def step(self, chunk: np.ndarray) -> EpochReport:
        """Digest one epoch of router traffic; maybe migrate the placement.

        The returned plan is what the *next* epoch should serve with
        (``None`` while warming up -- serve the static baseline meanwhile).
        """
        t0 = time.perf_counter()
        delta = self.acc.observe(chunk)
        if self.state is None:
            if self.epoch + 1 < self.warmup_epochs:   # accumulate only
                report = EpochReport(
                    epoch=self.epoch, cost_keep=0.0, cost_new=0.0,
                    committed=False, migration_bytes=0,
                    replan_seconds=time.perf_counter() - t0,
                    containment=1.0, plan=None)
            else:
                report = self._bootstrap(t0)
            self.epoch += 1
            return report
        st = self.state
        self._sync_delta(delta)
        cost_keep = float(st.cost)
        containment = self._containment()

        cand = self._replan(st.live_hypergraph(), warm=st.masks)
        st.begin()
        for v in np.nonzero(cand != st.masks)[0]:
            st.apply(int(v), int(cand[v]))
        cost_new = float(st.cost)
        cap_ok = bool(np.all(np.asarray(st.loads)
                             <= self.slots_per_shard + 1e-9))

        cand_plan = plan_from_masks(cand, self.n_experts, self.n_shards,
                                    expert_freq=self.acc.freq)
        mig = migration_bytes(self.plan, cand_plan, self.bytes_per_expert)
        gain = (cost_keep - cost_new) * self.comm_cost_per_unit \
            * self.horizon_epochs
        commit = bool(cap_ok
                      and containment < self.drift_threshold
                      and cost_new < cost_keep * (1.0 - self.min_rel_gain)
                      and gain > mig * (1.0 + self.hysteresis))
        if commit:
            st.commit()
            self.plan = cand_plan
            self._ref_edges = set(self.acc.edges)
            self.n_commits += 1
            self.total_migration_bytes += mig
        else:
            st.rollback()
            mig = 0
        report = EpochReport(
            epoch=self.epoch, cost_keep=cost_keep, cost_new=cost_new,
            committed=commit, migration_bytes=mig,
            replan_seconds=time.perf_counter() - t0,
            containment=containment, plan=self.plan)
        self.epoch += 1
        return report


def replay_cost(masks: np.ndarray, chunk: np.ndarray, P: int) -> float:
    """Exact total (lambda_e - 1) communication cost of serving ``chunk``
    under placement ``masks``: every token's expert tuple is a hyperedge of
    weight 1, priced by its min-cover over the replica masks.  This is the
    simulator's ground-truth scoring -- no kappa_0 truncation, every
    request counts."""
    chunk = np.asarray(chunk)
    masks = np.asarray(masks, dtype=np.int64)
    uniq, counts = np.unique(chunk, axis=0, return_counts=True)
    popcnt, order, order_pc, contrib = _tables(P)
    rows = contrib[masks[uniq]].sum(axis=1, dtype=np.int32)   # (U, 2^P)
    lam = _lambda_from_rows(rows, order, order_pc).astype(np.int64)
    return float((counts * np.maximum(lam - 1, 0)).sum())


def plan_to_masks(plan: PlacementPlan) -> np.ndarray:
    """Per-expert shard bitmasks of a plan (``replay_cost`` input)."""
    from .expert_placement import plan_masks
    return plan_masks(plan)

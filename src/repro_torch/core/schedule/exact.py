"""Near-exact BSP scheduling for tiny DAGs (the paper's §6.2.1 ILP role).

The paper embeds BSP scheduling in an ILP (COPT, hours of solve time) for
40-80-node DAGs.  Offline we provide a branch-and-bound search over node
assignments (v -> (processor, superstep)) with:

  * exhaustive enumeration of compute-phase assignments (symmetry-broken
    over processors, pruned by work + partial-comm lower bounds);
  * for each complete assignment, communications are derived canonically
    and then improved with the comm re-placement local search.

Without replication this certifies the assignment choice exactly; the comm
phase placement is a (very tight in practice) upper bound.  For replication
we take the exact non-replicating solution as the starting point and apply
the full replication machinery, mirroring the paper's suggestion (§C.1.1)
of warm-starting the replicating ILP with the non-replicating optimum.

The bound evaluation is incremental, in the spirit of the schedule engine:
instead of re-reducing the whole (S, P) work matrix at every search node
(O(S*P) per expansion), the DFS maintains each superstep's work maximum and
their running sum with O(1) updates on assign/unassign -- the same
undo-on-backtrack discipline the partition engine uses for its B&B, and the
leaf evaluation (derive + rebalance + prune + compact) runs on the
engine-backed ``Schedule``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .bsp import EPS, BspInstance, Schedule
from .list_sched import derive_comms, rebalance_comms


@dataclasses.dataclass
class ExactScheduleResult:
    schedule: Schedule
    cost: float
    assignments_optimal: bool
    explored: int


def exact_schedule(inst: BspInstance, max_supersteps: int = 4,
                   time_limit: float = 60.0,
                   ub_sched: Schedule | None = None) -> ExactScheduleResult:
    dag, P = inst.dag, inst.P
    n = dag.n
    topo = dag.topo_order()
    t0 = time.monotonic()

    best = {"cost": np.inf, "sched": None, "explored": 0, "timed_out": False}
    if ub_sched is not None:
        best["cost"] = ub_sched.current_cost()
        best["sched"] = ub_sched.copy()

    assign_p = np.full(n, -1, dtype=np.int64)
    assign_s = np.full(n, -1, dtype=np.int64)
    work = [[0.0] * P for _ in range(max_supersteps)]
    # incremental work lower bound: per-superstep max + running sum
    step_max = [0.0] * max_supersteps
    state = {"work_lb": 0.0}
    # crude comm lower bound: each cross-processor edge costs >= g * mu / P
    # (it contributes mu to someone's sent and recv h-relation)

    def finish() -> None:
        sched = Schedule(inst, max_supersteps)
        for i, v in enumerate(topo):
            sched.add_comp(int(v), int(assign_p[i]), int(assign_s[i]))
        derive_comms(sched)
        # every leaf is a fresh schedule: a device mirror per leaf would
        # cost more than its few short windows, and the host pricers take
        # the same decisions
        rebalance_comms(sched, max_passes=3, backend="numpy")
        sched.prune_useless_comms()
        sched.compact()
        c = sched.current_cost()
        if c < best["cost"] - EPS:
            best["cost"] = c
            best["sched"] = sched

    def lb_partial(cross_mu: float) -> float:
        comm_lb = inst.g * cross_mu / P + (inst.L if cross_mu > 0 else 0.0)
        return state["work_lb"] + comm_lb

    pos = {v: i for i, v in enumerate(topo)}
    parent_positions = [[pos[u] for u in dag.parents[v]] for v in topo]

    def dfs2(idx: int, used_procs: int, cross_mu: float) -> None:
        if best["timed_out"]:
            return
        best["explored"] += 1
        if best["explored"] % 4096 == 0 and time.monotonic() - t0 > time_limit:
            best["timed_out"] = True
            return
        if idx == n:
            finish()
            return
        v = topo[idx]
        omega_v = float(dag.omega[v])
        pidx = parent_positions[idx]
        min_s = 0
        for pi in pidx:
            if assign_s[pi] > min_s:
                min_s = int(assign_s[pi])
        for s in range(min_s, max_supersteps):
            for p in range(min(P, used_procs + 1)):
                ok = True
                add_mu = 0.0
                for pi in pidx:
                    if assign_p[pi] != p:
                        if assign_s[pi] >= s:
                            ok = False
                            break
                        add_mu += dag.mu[topo[pi]]
                if not ok:
                    continue
                assign_p[idx] = p
                assign_s[idx] = s
                old_w = work[s][p]
                new_w = old_w + omega_v
                work[s][p] = new_w
                old_max = step_max[s]
                old_lb = state["work_lb"]
                if new_w > old_max:
                    step_max[s] = new_w
                    state["work_lb"] = old_lb + (new_w - old_max)
                if lb_partial(cross_mu + add_mu) < best["cost"] - EPS:
                    dfs2(idx + 1, max(used_procs, p + 1), cross_mu + add_mu)
                work[s][p] = old_w
                step_max[s] = old_max
                state["work_lb"] = old_lb
                assign_p[idx] = -1
                assign_s[idx] = -1
                if best["timed_out"]:
                    return
        return

    dfs2(0, 0, 0.0)
    return ExactScheduleResult(
        schedule=best["sched"],
        cost=float(best["cost"]),
        assignments_optimal=not best["timed_out"],
        explored=best["explored"],
    )

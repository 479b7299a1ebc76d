"""BSP schedule representation, validity and cost (paper §3.3).

A schedule consists of compute phases ``comp[s][p]`` (sets of nodes) and
communication steps.  We keep comms canonical: at most one communication per
(value, destination) pair -- sending the same value to the same processor
twice is never beneficial.  A comm ``(v, dst) -> (src, s)`` sends v's output
from ``src`` to ``dst`` in superstep ``s``; the value becomes usable on
``dst`` from superstep ``s+1`` on.

Cost (with node compute weights ``omega`` and communication weights ``mu``):

    sum_s  max_p work(p,s)
         + sum_s [h_s > 0] * (L + g*h_s),   h_s = max_p max(sent, recv)

The synchronization cost L is charged only for supersteps with a non-empty
communication phase (matching the paper's Appendix A.1 accounting, where a
communication-free single-superstep schedule costs exactly its work).

``Schedule`` is the incremental-delta engine (``engine.ScheduleState``,
which maintains per-superstep top-2 load maxima, cached superstep costs and
an undo log for transactional trial moves) plus validity checking and
reporting.  The seed's full-recompute implementation survives verbatim in
``reference.py`` as the equivalence oracle.  ``EPS`` is the single shared
cost-comparison tolerance for the whole scheduling stack.
"""
from __future__ import annotations

import dataclasses

from ..hypergraph import Dag
from .engine import EPS, INF, ScheduleState

__all__ = ["BspInstance", "Schedule", "EPS", "INF"]


@dataclasses.dataclass
class BspInstance:
    dag: Dag
    P: int
    g: float = 1.0
    L: float = 0.0


class Schedule(ScheduleState):
    """BSP schedule (engine-backed).  See module docstring for semantics."""

    # ------------------------------------------------------------- validity
    def validate(self) -> list[str]:
        errors: list[str] = []
        dag, P = self.inst.dag, self.inst.P
        computed = [False] * dag.n
        for v in range(dag.n):
            for p, s in self.assign[v].items():
                computed[v] = True
                if v not in self.comp[s][p]:
                    errors.append(f"assign/comp mismatch for ({v},{p},{s})")
                for u in dag.parents[v]:
                    if not self.present_at(u, p, s):
                        errors.append(f"parent {u} of {v} missing on p{p} at s{s}")
        for v in range(dag.n):
            if not computed[v]:
                errors.append(f"node {v} never computed")
        for (v, dst), (src, s) in self.comms.items():
            if not self.present_at(v, src, s):
                errors.append(f"comm ({v},{src}->{dst},s{s}) source not present")
            if dst == src:
                errors.append(f"comm ({v},{src}->{dst}) self-send")
        return errors

    # ------------------------------------------------------------ reporting
    def surplus_cost(self) -> float:
        """Paper Definition 4.4: BSP cost minus the unavoidable n/P (or
        omega(V)/P with weights) compute floor -- captures exactly the
        extra cost of communication and replication."""
        return self.cost() - float(self.inst.dag.omega.sum()) / self.inst.P

    def stats(self) -> dict:
        return {
            "cost": self.cost(),
            "supersteps": self.S,
            "comms": len(self.comms),
            "replicas": sum(len(a) - 1 for a in self.assign if len(a) > 1),
        }

"""Plan-level placement router (model-predicted bin-packing).

Uses the placement pipeline's predictions (per-node adapter capacity +
optimal slot count) to (a) pack adapters onto replicas (greedy bin-pack on
predicted capacity, cf. dLoRA's proactive placement), (b) configure each
replica's ``adapter_slots``, and (c) admission-control so no replica is
pushed past its predicted starvation boundary.

``PlacementRouter`` is the *plan-level* tool: one model call decides the
initial adapter->replica packing.  (The request-level fleet path, the JAX
package's ``serving/cluster.py`` with its online rebalancing, is not
ported yet: ROADMAP item 16.)

The port's copy of ``repro.serving.router``, verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .request import Adapter


@dataclasses.dataclass
class ReplicaPlan:
    replica: int
    adapters: List[Adapter]
    slots: int
    predicted_throughput: float
    alive: bool = True
    straggler: bool = False


@dataclasses.dataclass
class RouterState:
    plans: List[ReplicaPlan]
    assignment: Dict[int, int]      # adapter uid -> replica

    def replica_for(self, adapter_uid: int) -> Optional[int]:
        return self.assignment.get(adapter_uid)


class PlacementRouter:
    def __init__(self, pipeline, n_replicas: int,
                 straggler_factor: float = 2.0):
        self.pipeline = pipeline
        self.n_replicas = n_replicas
        self.straggler_factor = straggler_factor
        self.state: Optional[RouterState] = None

    # ------------------------------------------------------------------ #
    def plan(self, pool: Sequence[Adapter], length_stats: Dict[str, float]
             ) -> RouterState:
        """Greedy bin-pack: fill replicas up to the model-predicted
        per-node capacity, highest-rate adapters first."""
        pool = sorted(pool, key=lambda a: -a.rate)
        plans: List[ReplicaPlan] = []
        assignment: Dict[int, int] = {}
        remaining = list(pool)
        for rep in range(self.n_replicas):
            if not remaining:
                plans.append(ReplicaPlan(rep, [], 1, 0.0))
                continue
            # ask the model how many of the remaining adapters this node
            # can serve at max throughput without starvation
            rates = [a.rate for a in remaining]
            ranks = [a.rank for a in remaining]
            rec = self.pipeline.recommend(rates, ranks, length_stats)
            take = min(len(remaining), max(rec["served_adapters"], 1))
            # spread the load: do not put everything on one node if the
            # fleet has room
            fair = -(-len(pool) // self.n_replicas)
            take = min(take, max(fair, 1)) if rep < self.n_replicas - 1 \
                else take
            chosen = remaining[:take]
            remaining = remaining[take:]
            for a in chosen:
                assignment[a.uid] = rep
            plans.append(ReplicaPlan(
                rep, chosen, rec["adapter_slots"],
                rec["throughput"]))
        # overflow: round-robin any leftovers (over capacity -> flagged)
        for i, a in enumerate(remaining):
            rep = i % self.n_replicas
            plans[rep].adapters.append(a)
            assignment[a.uid] = rep
        self.state = RouterState(plans=plans, assignment=assignment)
        return self.state

    # ------------------------------------------------------------------ #
    def route(self, adapter_uid: int) -> int:
        assert self.state is not None
        rep = self.state.replica_for(adapter_uid)
        if rep is None or not self.state.plans[rep].alive:
            live = [p.replica for p in self.state.plans
                    if p.alive and not p.straggler]
            rep = live[adapter_uid % len(live)] if live else 0
        return rep

    def report_failure(self, replica: int, pool: Sequence[Adapter],
                       length_stats: Dict[str, float]) -> RouterState:
        """Drain a dead replica and re-pack its adapters on survivors."""
        assert self.state is not None
        dead = self.state.plans[replica]
        dead.alive = False
        orphans = dead.adapters
        dead.adapters = []
        survivors = [p for p in self.state.plans if p.alive]
        for i, a in enumerate(sorted(orphans, key=lambda x: -x.rate)):
            tgt = min(survivors,
                      key=lambda p: sum(x.rate for x in p.adapters))
            tgt.adapters.append(a)
            self.state.assignment[a.uid] = tgt.replica
        return self.state

    def observe_itl(self, itls: Dict[int, float]) -> List[int]:
        """Mark stragglers: replicas whose ITL exceeds factor x median."""
        assert self.state is not None
        vals = [v for v in itls.values() if v > 0]
        if not vals:
            return []
        med = float(np.median(vals))
        out = []
        for rep, itl in itls.items():
            bad = itl > self.straggler_factor * med
            self.state.plans[rep].straggler = bad
            if bad:
                out.append(rep)
        return out

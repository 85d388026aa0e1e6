"""Optimal-placement search (paper §IV / §VII-B), single node.

Given a workload condition (a pool of adapters with rates/ranks and request
length characteristics), find the placement that maximizes throughput
without starvation: the number of served adapters N* and the adapter-slot
count G* at which throughput peaks while staying >= 90% of the offered
(ideal) rate.  The search sweeps the Digital Twin.

The port's copy of the single-node part of ``repro.core.placement``
(placement.py:42-70 and :373-438); the cluster sweeps and the placement
models are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ..serving.request import Adapter
from .digital_twin import DigitalTwin
from .estimators import FittedEstimators
from .workload import WorkloadSpec


@dataclasses.dataclass
class PlacementPoint:
    n_adapters: int
    slots: int
    throughput: float
    ideal: float
    starved: bool


@dataclasses.dataclass
class PlacementResult:
    best: Optional[PlacementPoint]
    curve: List[PlacementPoint]

    @property
    def n_adapters(self) -> int:
        return self.best.n_adapters if self.best else 0

    @property
    def slots(self) -> int:
        return self.best.slots if self.best else 0

    @property
    def throughput(self) -> float:
        return self.best.throughput if self.best else 0.0


EARLY_STOP = 2   # counts in a row without a gain that end the sweep


def default_slot_grid(n: int) -> List[int]:
    grid = sorted({max(1, n // 8), max(1, n // 4), max(1, n // 2), n})
    return grid


def find_optimal_placement(
        est: FittedEstimators, pool: Sequence[Adapter], dataset: str,
        horizon: float = 300.0, seed: int = 0,
        measured_step_times=None) -> PlacementResult:
    """Sweep served-adapter counts (and slots) through the DT.

    Each point runs on the object-mode ``DigitalTwin``: the JAX package's
    ``fast=False``.  Its default, the struct-of-arrays ``FastTwin``, is
    not ported yet (ROADMAP.md queue 1); ``tests/test_fast_twin.py`` pins
    the two twins' labels equal, so the sweep picks the same (N*, G*).
    The sweep has the JAX defaults and no other: the twin in ``mean``
    mode, the default served-count grid and ``default_slot_grid``, FCFS
    scheduling, no shared-prefix cache, and a stop after two counts in a
    row that do not improve.  ``measured_step_times`` (a
    ``MeasuredStepTimes``) swaps the analytic Lat_model/Lat_adapters terms
    for kernel-measured fits, so the chosen (N*, G*) reflects real kernel
    costs; ``None`` is bitwise the pre-hook sweep."""
    dt = DigitalTwin(est, mode="mean",
                     measured_step_times=measured_step_times)
    n_grid = sorted({max(1, len(pool) // k) for k in (16, 8, 4, 3, 2)}
                    | {len(pool)})
    curve: List[PlacementPoint] = []
    best: Optional[PlacementPoint] = None
    drops = 0
    for n in n_grid:
        spec = WorkloadSpec(adapters=list(pool[:n]), dataset=dataset,
                            horizon=horizon, seed=seed)
        best_at_n: Optional[PlacementPoint] = None
        for g in default_slot_grid(n):
            res = dt.simulate(spec, slots=g)
            pt = PlacementPoint(
                n_adapters=n, slots=g,
                throughput=res.metrics.throughput,
                ideal=res.metrics.ideal_throughput,
                starved=res.metrics.starved)
            curve.append(pt)
            if not pt.starved and (best_at_n is None
                                   or pt.throughput > best_at_n.throughput):
                best_at_n = pt
        if best_at_n is None:
            drops += 1
            if best is not None and drops >= EARLY_STOP:
                break
            continue
        if best is None or best_at_n.throughput >= best.throughput:
            best = best_at_n
            drops = 0
        else:
            drops += 1
            if drops >= EARLY_STOP:
                break
    return PlacementResult(best=best, curve=curve)

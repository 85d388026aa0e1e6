"""Optimal-placement search (paper §IV / §VII-B), single node.

Given a workload condition (a pool of adapters with rates/ranks and request
length characteristics), find the placement that maximizes throughput
without starvation: the number of served adapters N* and the adapter-slot
count G* at which throughput peaks while staying >= 90% of the offered
(ideal) rate.  The search sweeps the Digital Twin.

The port's copy of the single-node part of ``repro.core.placement``
(placement.py:42-70 and :373-438), its functions verbatim; the cluster
sweeps and the placement models are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ..serving.request import Adapter
from .digital_twin import DigitalTwin
from .estimators import FittedEstimators
from .fast_twin import FastTwin
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


def default_slot_grid(n: int) -> List[int]:
    grid = sorted({max(1, n // 8), max(1, n // 4), max(1, n // 2), n})
    return grid


def find_optimal_placement(
        est: FittedEstimators, pool: Sequence[Adapter], dataset: str,
        horizon: float = 300.0, seed: int = 0,
        n_grid: Optional[Sequence[int]] = None,
        slot_grid=default_slot_grid, dt_mode: str = "mean",
        early_stop: int = 2, fast: bool = True,
        sched_policy: str = "fcfs",
        measured_step_times=None,
        prefix_share: float = 0.0,
        prefix_len: int = 0) -> PlacementResult:
    """Sweep served-adapter counts (and slots) through the DT.

    ``fast`` (default) runs each point on the struct-of-arrays
    ``FastTwin`` — identical labels to the legacy object-mode twin
    (``fast=False``, kept as the equivalence oracle), ~10x cheaper.
    ``sched_policy`` makes the scheduling policy a sweep axis: the same
    workload can have a different (N*, G*) under e.g. ``adapter-fair``.
    ``measured_step_times`` (a ``MeasuredStepTimes``) swaps the analytic
    Lat_model/Lat_adapters terms for kernel-measured fits, so the chosen
    (N*, G*) reflects real kernel costs; ``None`` is bitwise the
    pre-hook sweep.  ``prefix_share``/``prefix_len`` give the synthetic
    workload a shared-prefix structure and enable the twin's shared-prefix
    KV cache, so (N*, G*) reflects the cache's admission-capacity gain."""
    use_prefix = prefix_share > 0 and prefix_len > 0
    dt = (FastTwin if fast else DigitalTwin)(
        est, mode=dt_mode, sched_policy=sched_policy,
        measured_step_times=measured_step_times,
        prefix_cache=use_prefix)
    if n_grid is None:
        n_grid = sorted({max(1, len(pool) // k) for k in
                         (16, 8, 4, 3, 2)} | {len(pool)})
        n_grid = [n for n in n_grid if n >= 1]
    curve: List[PlacementPoint] = []
    best: Optional[PlacementPoint] = None
    drops = 0
    for n in sorted(n_grid):
        adapters = list(pool[:n])
        spec = WorkloadSpec(adapters=adapters, dataset=dataset,
                            horizon=horizon, seed=seed,
                            prefix_share=prefix_share,
                            prefix_len=prefix_len)
        best_at_n: Optional[PlacementPoint] = None
        for g in slot_grid(n):
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
            if best is not None and drops >= early_stop:
                break
            continue
        if best is None or best_at_n.throughput >= best.throughput:
            best = best_at_n
            drops = 0
        else:
            drops += 1
            if drops >= early_stop:
                break
    return PlacementResult(best=best, curve=curve)

"""SweepRunner: parallel, reproducible twin sweeps for training-data
generation.

The placement model's creation phase labels (scenario x fleet-size) grid
points with Digital Twin sweeps — embarrassingly parallel work that the
legacy path ran serially.  ``SweepRunner`` fans ``SweepTask``s across a
process pool:

  * **reproducible** — every task carries its own workload seed, so the
    labels are a pure function of (estimators, task); results return in
    task order regardless of pool size or worker scheduling.  Serial
    (``n_workers<=1``) and parallel runs produce identical labels
    (``tests/test_torch_pipeline.py`` enforces it).
  * **memoized estimator fits** — the fitted estimators are shipped to
    each worker exactly once (pool initializer), not per task.
  * **robust** — on any pool-creation failure the runner degrades to the
    serial path (same results, no parallelism).

The default ``spawn`` start method keeps workers clean of whatever
threads the parent accumulated (JAX's XLA client makes ``fork`` unsafe
mid-benchmark); pass ``mp_context="fork"`` for the cheapest start-up in
pure-numpy parents.

The port's copy of ``repro.core.sweep``, verbatim but for the cluster
sweep: a task with ``n_replicas > 0`` raises ``NotImplementedError``, as
the port has no cluster placement yet (ROADMAP item 16).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor
from typing import List, Optional, Sequence, Tuple

from ..serving.request import Adapter
from .estimators import FittedEstimators
from .placement import PlacementResult, find_optimal_placement


@dataclasses.dataclass(frozen=True)
class SweepTask:
    """One twin sweep: a single-node (N*, G*) search when
    ``n_replicas == 0``, a joint cluster sweep otherwise."""
    pool: Tuple[Adapter, ...]
    dataset: str
    horizon: float
    seed: int
    n_replicas: int = 0
    n_grid: Optional[Tuple[int, ...]] = None
    dt_mode: str = "mean"
    early_stop: int = 2
    policy: str = "affinity"
    sched_policy: str = "fcfs"
    prefix_share: float = 0.0
    prefix_len: int = 0


def run_task(est: FittedEstimators, task: SweepTask) -> PlacementResult:
    """Evaluate one sweep task (the unit of work a worker executes)."""
    n_grid = list(task.n_grid) if task.n_grid is not None else None
    if task.n_replicas:
        raise NotImplementedError(
            "cluster sweep tasks (n_replicas > 0) need the cluster "
            "placement, not ported yet (ROADMAP item 16)")
    return find_optimal_placement(
        est, list(task.pool), task.dataset, horizon=task.horizon,
        seed=task.seed, n_grid=n_grid, dt_mode=task.dt_mode,
        early_stop=task.early_stop, sched_policy=task.sched_policy,
        prefix_share=task.prefix_share, prefix_len=task.prefix_len)


_WORKER_EST: Optional[FittedEstimators] = None


def _init_worker(est: FittedEstimators) -> None:
    global _WORKER_EST
    _WORKER_EST = est


def _run_in_worker(task: SweepTask) -> PlacementResult:
    return run_task(_WORKER_EST, task)


class SweepRunner:
    """Fan sweep tasks across a process pool; fall back to serial."""

    def __init__(self, est: FittedEstimators,
                 n_workers: Optional[int] = None,
                 mp_context: str = "spawn"):
        self.est = est
        if n_workers is None:
            n_workers = min(os.cpu_count() or 1, 8)
        self.n_workers = max(int(n_workers), 0)
        self.mp_context = mp_context

    def map(self, tasks: Sequence[SweepTask]) -> List[PlacementResult]:
        """Evaluate every task; results are returned in task order and
        are identical for any worker count (including serial)."""
        tasks = list(tasks)
        if self.n_workers <= 1 or len(tasks) <= 1:
            return [run_task(self.est, t) for t in tasks]
        try:
            ctx = multiprocessing.get_context(self.mp_context)
            with ProcessPoolExecutor(
                    max_workers=min(self.n_workers, len(tasks)),
                    mp_context=ctx, initializer=_init_worker,
                    initargs=(self.est,)) as pool:
                return list(pool.map(_run_in_worker, tasks))
        except (OSError, PermissionError, ValueError, ImportError,
                BrokenExecutor):
            # restricted environments (no fork/spawn, or workers killed at
            # startup — pool creation is lazy, so that surfaces as
            # BrokenProcessPool from map): serial fallback, same labels
            return [run_task(self.est, t) for t in tasks]

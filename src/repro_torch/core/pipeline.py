"""End-to-end pipeline (paper Fig. 1).

Creation phase:
  1. benchmark the real serving engine (controlled probes),
  2. fit the Eq. (1) estimators,
  3. sweep the Digital Twin over scenario grids -> labelled dataset,
  4. train the interpretable placement model (RF by default).

Production phase:
  ``recommend(rates, ranks, length_stats)`` -> (throughput, N*, G*) in
  sub-millisecond time, suitable for routers / autoscalers.

The port's copy of ``repro.core.pipeline``, verbatim.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serving.executor import HardwareProfile, SyntheticExecutor
from ..serving.metrics import smape_vec
from .dataset import (FEATURE_NAMES, TARGET_NAMES, Scenario, encode_features,
                      label_scenarios, scenario_grid)
from .estimators import (FittedEstimators, collect_benchmark, collect_memmax,
                         fit_estimators)
from .forest import MODEL_ZOO


@dataclasses.dataclass
class PlacementPipeline:
    est: FittedEstimators
    model: object
    model_name: str
    feature_names: Tuple[str, ...] = FEATURE_NAMES
    target_names: Tuple[str, ...] = TARGET_NAMES
    fit_report: Dict[str, float] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #
    def recommend(self, rates: Sequence[float], ranks: Sequence[int],
                  length_stats: Dict[str, float],
                  sched_policy: str = "fcfs",
                  prefix_hit_rate: float = 0.0) -> Dict[str, float]:
        x = encode_features(rates, ranks, length_stats,
                            sched_policy=sched_policy,
                            prefix_hit_rate=prefix_hit_rate)[None]
        t0 = time.perf_counter()
        y = np.asarray(self.model.predict(x))[0]
        dt = time.perf_counter() - t0
        return {
            "throughput": float(y[0]),
            "served_adapters": max(int(round(y[1])), 1),
            "adapter_slots": max(int(round(y[2])), 1),
            "inference_ms": dt * 1e3,
        }


def build_pipeline(
        profile: Optional[HardwareProfile] = None,
        slots_for_bench: int = 32, n_adapters_for_bench: int = 96,
        scenarios: Optional[List[Scenario]] = None,
        n_scenarios: int = 40, max_adapters: int = 96,
        horizon: float = 150.0, model_name: str = "forest",
        seed: int = 0, verbose: bool = False,
        n_workers: int = 0,
        sched_policies: Sequence[str] = ("fcfs",)) -> PlacementPipeline:
    """Creation phase end-to-end (sizes default to test-scale; the Table-I
    benchmark scales them up).  ``n_workers > 1`` fans the DT scenario
    sweeps across a ``SweepRunner`` process pool (identical labels).
    ``sched_policies`` widens the scenario grid with the scheduling-policy
    axis, so the model can learn e.g. that ``adapter-fair`` shifts N*."""
    profile = profile or HardwareProfile()
    ranks = {i: (8, 16, 32)[i % 3] for i in range(n_adapters_for_bench)}
    executor = SyntheticExecutor(profile, ranks, slots=slots_for_bench,
                                 n_adapters=n_adapters_for_bench, seed=seed)
    step_rows = collect_benchmark(executor, slots_for_bench,
                                  n_adapters_for_bench, ranks)
    mem_rows = collect_memmax(profile, seed=seed)
    est = fit_estimators(step_rows, mem_rows, slots_for_bench,
                         n_adapters_for_bench)

    scenarios = scenarios or scenario_grid(limit=n_scenarios, seed=seed,
                                           sched_policies=sched_policies)
    runner = None
    if n_workers > 1:
        from .sweep import SweepRunner
        runner = SweepRunner(est, n_workers=n_workers)
    xs, ys, _ = label_scenarios(est, scenarios, max_adapters=max_adapters,
                                horizon=horizon, seed=seed, verbose=verbose,
                                runner=runner)

    model = MODEL_ZOO[model_name]()
    n_train = max(int(0.8 * len(xs)), 1)
    model.fit(xs[:n_train], ys[:n_train])
    report: Dict[str, float] = {}
    if len(xs) > n_train:
        pred = np.asarray(model.predict(xs[n_train:]))
        for j, name in enumerate(TARGET_NAMES):
            report[f"smape_{name}"] = smape_vec(pred[:, j], ys[n_train:, j])
    return PlacementPipeline(est=est, model=model, model_name=model_name,
                             fit_report=report)

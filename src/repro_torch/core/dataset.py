"""DT-generated training dataset for the placement model (paper §VII-B).

Scenarios = combinations of (three rates out of the paper's rate set) x
(ranks out of {8,16,32}) x dataset profile.  Each scenario is labelled by
the starvation-bounded optimal placement found with the Digital Twin.
Features encode the workload condition as max/min/mean/std of each varying
characteristic — exactly the paper's encoding.

The port's copy of ``repro.core.dataset``, verbatim.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serving.policy import sched_policy_index
from ..serving.request import Adapter
from .estimators import FittedEstimators
from .placement import PlacementResult, find_optimal_placement
from .workload import (WorkloadSpec, expected_prefix_hit_rate,
                       make_adapter_pool)

PAPER_RATES = (3.2, 1.6, 0.8, 0.4, 0.1, 0.05, 0.025,
               0.0125, 0.00625, 0.003125)
PAPER_RANKS = (8, 16, 32)

FEATURE_NAMES = (
    "rate_max", "rate_min", "rate_mean", "rate_std",
    "rank_max", "rank_min", "rank_mean", "rank_std",
    "in_mean", "in_std", "out_mean", "out_std",
    "sched_policy", "prefix_hit_rate",
)
TARGET_NAMES = ("throughput", "served_adapters", "adapter_slots")


def encode_features(rates: Sequence[float], ranks: Sequence[int],
                    stats: Dict[str, float],
                    sched_policy: str = "fcfs",
                    prefix_hit_rate: float = 0.0) -> np.ndarray:
    # ``prefix_hit_rate``: expected shared-prefix cache hit rate of the
    # workload (repro_torch.core.workload.expected_prefix_hit_rate); 0.0 = no
    # shared prefixes (the paper's original encoding)
    r = np.asarray(rates, float)
    k = np.asarray(ranks, float)
    return np.array([
        r.max(), r.min(), r.mean(), r.std(),
        k.max(), k.min(), k.mean(), k.std(),
        stats["in_mean"], stats["in_std"],
        stats["out_mean"], stats["out_std"],
        float(sched_policy_index(sched_policy)),
        float(prefix_hit_rate),
    ])


@dataclasses.dataclass
class Scenario:
    rates: Tuple[float, ...]
    ranks: Tuple[int, ...]
    dataset: str
    sched_policy: str = "fcfs"
    # shared-prefix workload statistics (0.0/0 = the paper's original
    # prefix-free scenarios)
    prefix_share: float = 0.0
    prefix_len: int = 0

    def pool(self, max_adapters: int) -> List[Adapter]:
        return make_adapter_pool(max_adapters, self.ranks, self.rates)


def scenario_grid(rate_set: Sequence[float] = PAPER_RATES,
                  rank_set: Sequence[int] = PAPER_RANKS,
                  datasets: Sequence[str] = ("medium",),
                  n_rates: int = 3,
                  limit: Optional[int] = None,
                  seed: int = 0,
                  sched_policies: Sequence[str] = ("fcfs",)
                  ) -> List[Scenario]:
    """Scenario grid; ``sched_policies`` adds the scheduling-policy
    dimension (the default keeps the paper's FCFS-only grid)."""
    combos = list(itertools.combinations_with_replacement(rate_set, n_rates))
    out = []
    for rates in combos:
        for ds in datasets:
            for sp in sched_policies:
                out.append(Scenario(rates=tuple(rates),
                                    ranks=tuple(rank_set),
                                    dataset=ds, sched_policy=sp))
    rng = np.random.default_rng(seed)
    rng.shuffle(out)
    if limit:
        out = out[:limit]
    return out


def label_scenarios(est: FittedEstimators, scenarios: Sequence[Scenario],
                    max_adapters: int = 96, horizon: float = 200.0,
                    seed: int = 0, verbose: bool = False, runner=None
                    ) -> Tuple[np.ndarray, np.ndarray, List[PlacementResult]]:
    """Label scenarios with twin placement sweeps.  ``runner`` (a
    ``repro_torch.core.sweep.SweepRunner``) distributes scenarios across a
    process pool; per-scenario seeds keep the labels identical to the
    serial path for any pool size."""
    if runner is not None:
        from .sweep import SweepTask
        tasks = [SweepTask(pool=tuple(sc.pool(max_adapters)),
                           dataset=sc.dataset, horizon=horizon,
                           seed=seed + i, sched_policy=sc.sched_policy,
                           prefix_share=sc.prefix_share,
                           prefix_len=sc.prefix_len)
                 for i, sc in enumerate(scenarios)]
        results = runner.map(tasks)
    else:
        results = [find_optimal_placement(est, sc.pool(max_adapters),
                                          sc.dataset, horizon=horizon,
                                          seed=seed + i,
                                          sched_policy=sc.sched_policy,
                                          prefix_share=sc.prefix_share,
                                          prefix_len=sc.prefix_len)
                   for i, sc in enumerate(scenarios)]
    xs, ys = [], []
    for i, (sc, res) in enumerate(zip(scenarios, results)):
        pool = sc.pool(max_adapters)
        spec = WorkloadSpec(adapters=pool, dataset=sc.dataset,
                            prefix_share=sc.prefix_share,
                            prefix_len=sc.prefix_len)
        feats = encode_features([a.rate for a in pool],
                                [a.rank for a in pool], spec.length_stats(),
                                sched_policy=sc.sched_policy,
                                prefix_hit_rate=expected_prefix_hit_rate(
                                    spec))
        xs.append(feats)
        ys.append([res.throughput, res.n_adapters, res.slots])
        if verbose and (i + 1) % 10 == 0:
            print(f"  labelled {i + 1}/{len(scenarios)}")
    return np.asarray(xs), np.asarray(ys), results

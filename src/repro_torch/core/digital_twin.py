"""The Digital Twin: an offline simulator of the online adapter-serving
system (paper §VI).

Architecture mirrors Fig. 8: the continuous-batching loop with scheduler,
adapter cache and model components — implemented by *reusing the engine's
scheduling machinery verbatim* (that is the replication) while every step
time and the KV capacity come from the fitted estimators of Eq. (1).

Modes:
  * ``full`` — exact per-request prompt/output lengths are known.
  * ``mean`` — only aggregate length stats (mean/std) are known; the DT
    resamples a statistically equivalent request stream (production mode).

Resource footprint matches the paper's claims trivially: single process,
no accelerator, O(requests) memory.

The port's verbatim copy of ``repro.core.digital_twin``, running on the
port's copy of the engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..serving.engine import EngineConfig, ServingEngine
from ..serving.executor import StepTiming
from ..serving.metrics import ServingMetrics
from ..serving.request import Request
from .estimators import FittedEstimators
from .workload import WorkloadSpec, resample_requests


class EstimatorExecutor:
    """Executor whose step times come from Eq. (1) fits."""

    def __init__(self, est: FittedEstimators, slots: int, n_adapters: int,
                 ranks: Dict[int, int]):
        self.est = est
        self.slots = slots
        self.n_adapters = n_adapters
        self.ranks = ranks

    def step(self, plan, n_waiting: int) -> StepTiming:
        return self.est.lat_step(plan, n_waiting, self.slots,
                                 self.n_adapters, self.ranks)


@dataclasses.dataclass
class DTResult:
    metrics: ServingMetrics
    sim_wall_time: float
    mode: str


class DigitalTwin:
    def __init__(self, est: FittedEstimators, mode: str = "full",
                 max_running: int = 256, sched_policy: str = "fcfs",
                 measured_step_times=None, prefix_cache: bool = False):
        assert mode in ("full", "mean")
        # opt-in hook: a MeasuredStepTimes surface (fitted from real
        # kernel launches by repro_torch/bench/kernels_bench.py) replaces
        # the analytic Lat_model x Lat_adapters terms.  None is provably a
        # no-op (tests/test_torch_twin.py pins bitwise equality).
        if measured_step_times is not None:
            est = est.with_measured(measured_step_times)
        self.est = est
        self.mode = mode
        self.max_running = max_running
        self.sched_policy = sched_policy
        self.prefix_cache = prefix_cache

    def simulate(self, spec: WorkloadSpec, slots: int,
                 requests: Optional[List[Request]] = None,
                 horizon: Optional[float] = None,
                 dynamic_slots: bool = False) -> DTResult:
        t0 = time.perf_counter()
        ranks = {a.uid: a.rank for a in spec.adapters}
        mean_rank = (sum(ranks.values()) / len(ranks)) if ranks else 8.0
        n = len(spec.adapters)
        if self.mode == "mean" or requests is None:
            requests = resample_requests(spec, spec.length_stats())
        else:
            # full mode gets the exact stream (deep copy to keep caller's);
            # progress AND reliability lifecycle restart clean — replaying
            # a chaos run's stream must not inherit its retry state
            requests = [dataclasses.replace(
                r, generated=0, admitted_at=None, first_token_at=None,
                finished_at=None, token_times=[], n_preemptions=0,
                n_retries=0, n_timeouts=0, failed_at=None, retry_at=None,
                disconnected_at=None)
                for r in requests]
        if dynamic_slots:
            # S-LoRA mode: the whole pool is available; each loaded adapter
            # is charged its Mem_max-estimated KV-token footprint.
            per_rank = max(-float(self.est.memmax[1]), 0.0)
            cfg = EngineConfig(
                kv_capacity_tokens=self.est.kv_capacity(0, mean_rank),
                adapter_slots=0, max_running=self.max_running,
                sched_policy=self.sched_policy, dynamic_slots=True,
                adapter_kv_tokens={u: max(int(per_rank * r), 1)
                                   for u, r in ranks.items()},
                prefix_cache=self.prefix_cache)
            slots_for_est = n
        else:
            cfg = EngineConfig(
                kv_capacity_tokens=self.est.kv_capacity(slots, mean_rank),
                adapter_slots=slots, max_running=self.max_running,
                sched_policy=self.sched_policy,
                prefix_cache=self.prefix_cache)
            slots_for_est = slots
        engine = ServingEngine(cfg, EstimatorExecutor(
            self.est, slots_for_est, n, ranks))
        metrics = engine.run(requests, horizon=horizon or spec.horizon)
        return DTResult(metrics=metrics,
                        sim_wall_time=time.perf_counter() - t0,
                        mode=self.mode)

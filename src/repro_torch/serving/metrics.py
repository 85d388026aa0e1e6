"""Serving metrics: throughput / ITL / TTFT + starvation detection.

Beyond the paper's aggregate starvation rule (<90% of offered
throughput), metrics carry the request-level view scheduling policies
are compared on: per-adapter starved-request counters (a request that
arrived inside the measured window but never received its first token)
and the TTFT tail (p50/p99) — a policy can hold aggregate throughput
while quietly starving one adapter, and these fields expose it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .request import Request


@dataclasses.dataclass
class ServingMetrics:
    throughput: float          # output tokens / s
    itl: float                 # mean inter-token latency (s)
    ttft: float                # mean time-to-first-token (s)
    ideal_throughput: float    # offered output tokens / s
    duration: float
    n_finished: int
    n_preemptions: int
    max_kv_used: float = 0.0
    n_loads: int = 0
    ttft_p50: float = 0.0      # TTFT median (s), 0 when nothing served
    ttft_p99: float = 0.0      # TTFT 99th percentile (s)
    n_starved_requests: int = 0  # arrived but never got a first token
    starved_per_adapter: Dict[int, int] = dataclasses.field(
        default_factory=dict)  # adapter uid -> starved request count
    # reliability counters (all 0 on the healthy path — defaults keep
    # pre-fault-layer runs bitwise-identical)
    n_timeouts: int = 0        # deadline expiries observed
    n_retries: int = 0         # re-submissions performed
    n_failed_requests: int = 0  # requests explicitly failed (retries spent)
    n_load_faults: int = 0     # adapter preloads/restores refused by faults
    # shared-prefix cache counters (all 0 with the cache off — defaults
    # keep pre-prefix-cache runs bitwise-identical)
    n_prefix_hits: int = 0       # admissions that reused a cached prefix
    n_prefix_misses: int = 0     # prefix-carrying admissions that did not
    n_prefix_evictions: int = 0  # idle (zero-ref) entries reclaimed
    prefix_tokens_saved: int = 0  # prefill tokens skipped via hits
    # raw per-request TTFT samples: ``ClusterMetrics.aggregate`` pools
    # these across replicas to compute *exact* cluster percentiles (a
    # finished-weighted mean of per-replica percentiles is biased
    # whenever replicas see different TTFT distributions)
    ttft_samples: List[float] = dataclasses.field(default_factory=list)

    @property
    def starved(self) -> bool:
        """Paper definition: observed < 90% of ideal throughput."""
        if self.ideal_throughput <= 0:
            return False
        return self.throughput < 0.9 * self.ideal_throughput


# --- canonical twin-equivalence contract ------------------------------
# Every ``ServingMetrics`` field must appear in exactly one of the three
# tuples below; ``repro.analysis`` (rule twin-metrics-fields) fails the
# build otherwise.  Tests compare object-mode engines/twins against the
# SoA fast twins field-by-field over TWIN_EXACT_FIELDS and require
# bitwise equality — this tuple IS the paper's twin-fidelity contract.
TWIN_EXACT_FIELDS = (
    "throughput", "ideal_throughput", "duration", "n_finished",
    "n_preemptions", "n_loads", "max_kv_used", "ttft",
    "ttft_p50", "ttft_p99", "n_starved_requests", "starved_per_adapter",
    "n_timeouts", "n_retries", "n_failed_requests", "n_load_faults",
    "n_prefix_hits", "n_prefix_misses", "n_prefix_evictions",
    "prefix_tokens_saved",
)

# Compared with a float tolerance only: the object path averages ITL
# per request then over requests, the SoA path telescopes token gaps —
# algebraically equal, but the summation orders differ in the last ulp.
TWIN_TOLERANT_FIELDS = ("itl",)

# Raw per-request sample pools (order-sensitive lists, not aggregates):
# consumed by ``ClusterMetrics.aggregate`` for exact cluster
# percentiles, compared as multisets where tests need them.
TWIN_SAMPLE_FIELDS = ("ttft_samples",)


def ttft_percentiles(ttfts) -> Dict[str, float]:
    """p50/p99 of a TTFT sample (0.0 when empty) — shared by the
    object-mode ``summarize`` and the fast twin's vectorized finalize so
    both compute bit-identical values."""
    if len(ttfts) == 0:
        return {"p50": 0.0, "p99": 0.0}
    arr = np.asarray(ttfts, float)
    return {"p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99))}


def summarize(reqs: List[Request], duration: float,
              offered_tokens: float, max_kv_used: float = 0.0,
              n_loads: int = 0, n_load_faults: int = 0,
              n_prefix_hits: int = 0, n_prefix_misses: int = 0,
              n_prefix_evictions: int = 0,
              prefix_tokens_saved: int = 0) -> ServingMetrics:
    finished = [r for r in reqs if r.finished_at is not None]
    out_tokens = sum(r.generated for r in reqs)
    itls = [r.itl for r in finished if r.itl is not None]
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    pct = ttft_percentiles(ttfts)
    starved_per_adapter: Dict[int, int] = {}
    for r in reqs:
        if r.arrival <= duration and r.first_token_at is None:
            starved_per_adapter[r.adapter] = \
                starved_per_adapter.get(r.adapter, 0) + 1
    return ServingMetrics(
        throughput=out_tokens / duration if duration > 0 else 0.0,
        itl=float(np.mean(itls)) if itls else 0.0,
        ttft=float(np.mean(ttfts)) if ttfts else 0.0,
        ideal_throughput=offered_tokens / duration if duration > 0 else 0.0,
        duration=duration,
        n_finished=len(finished),
        n_preemptions=sum(r.n_preemptions for r in reqs),
        max_kv_used=max_kv_used,
        n_loads=n_loads,
        ttft_p50=pct["p50"],
        ttft_p99=pct["p99"],
        n_starved_requests=sum(starved_per_adapter.values()),
        starved_per_adapter=starved_per_adapter,
        n_timeouts=sum(r.n_timeouts for r in reqs),
        n_retries=sum(r.n_retries for r in reqs),
        n_failed_requests=sum(1 for r in reqs if r.failed_at is not None),
        n_load_faults=n_load_faults,
        n_prefix_hits=n_prefix_hits,
        n_prefix_misses=n_prefix_misses,
        n_prefix_evictions=n_prefix_evictions,
        prefix_tokens_saved=prefix_tokens_saved,
        ttft_samples=[float(t) for t in ttfts],
    )


def smape(a: float, b: float) -> float:
    """Symmetric mean absolute percentage error of two scalars (%)."""
    if a == 0 and b == 0:
        return 0.0
    return 100.0 * abs(a - b) / ((abs(a) + abs(b)) / 2.0)


def smape_vec(xs, ys) -> float:
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    denom = (np.abs(xs) + np.abs(ys)) / 2.0
    mask = denom > 0
    if not mask.any():
        return 0.0
    return float(100.0 * np.mean(np.abs(xs - ys)[mask] / denom[mask]))

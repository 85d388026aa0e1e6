"""Workload generation: multi-adapter request streams (paper §IV-A Setup).

The port's copy of the part of ``repro.core.workload`` that the serve
launcher, the Digital Twins and their tests need; the functions are
verbatim.  The open-loop arrivals and the trace functions (the
gateway's inputs) are not ported yet.  Each adapter has an independent
Poisson arrival process; request lengths come from the paper's datasets: the
three synthetic single-length profiles (SmallRequest 23/27, MediumRequest
250/231, LargeRequest 423/358 — P25 / mean / P75 of cleaned ShareGPT) or a
ShareGPT-like lognormal sampler.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..serving.request import Adapter, Request

DATASETS: Dict[str, Tuple[int, int]] = {
    "small": (23, 27),
    "medium": (250, 231),
    "large": (423, 358),
}

# lognormal parameters roughly matching cleaned-ShareGPT in/out lengths
SHAREGPT_IN = (5.0, 1.0)     # mu, sigma  (median ~148, mean ~244)
SHAREGPT_OUT = (5.0, 0.9)


@dataclasses.dataclass
class WorkloadSpec:
    adapters: List[Adapter]
    dataset: str = "medium"           # small | medium | large | sharegpt
    horizon: float = 600.0
    seed: int = 0
    # shared-prefix statistics: each adapter (tenant) owns one system
    # prompt of ``prefix_len`` tokens; a ``prefix_share`` fraction of its
    # requests carry it (prepended to the sampled prompt).  0.0/0 = no
    # prefixes — generated streams are bitwise identical to before.
    prefix_share: float = 0.0
    prefix_len: int = 0

    @property
    def total_rate(self) -> float:
        return sum(a.rate for a in self.adapters)

    def length_stats(self) -> Dict[str, float]:
        """Aggregate stats for the DT *mean* mode."""
        if self.dataset in DATASETS:
            i, o = DATASETS[self.dataset]
            return {"in_mean": i, "in_std": 0.0, "out_mean": o, "out_std": 0.0}
        mi, si = SHAREGPT_IN
        mo, so = SHAREGPT_OUT
        return {
            "in_mean": math.exp(mi + si ** 2 / 2),
            "in_std": math.exp(mi + si ** 2 / 2)
            * math.sqrt(math.exp(si ** 2) - 1),
            "out_mean": math.exp(mo + so ** 2 / 2),
            "out_std": math.exp(mo + so ** 2 / 2)
            * math.sqrt(math.exp(so ** 2) - 1),
        }


def _sample_lengths(dataset: str, n: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    if dataset in DATASETS:
        i, o = DATASETS[dataset]
        return np.full(n, i, int), np.full(n, o, int)
    if dataset == "sharegpt":
        i = np.clip(rng.lognormal(*SHAREGPT_IN, n), 4, 4096).astype(int)
        o = np.clip(rng.lognormal(*SHAREGPT_OUT, n), 4, 2048).astype(int)
        return i, o
    raise ValueError(dataset)


def assign_shared_prefixes(reqs: List[Request], share: float,
                           prefix_len: int, seed: int = 0) -> List[Request]:
    """Mark a ``share`` fraction of requests as carrying their tenant's
    shared system prompt: the carrier's ``prompt_len`` grows by
    ``prefix_len`` and ``prefix_id`` is set to the adapter uid (one
    prompt per tenant, shared across all its requests).

    Carrier selection uses its own RNG stream (``seed + 7919``), so the
    base arrival/length draws are untouched — ``share=0`` leaves the
    stream bitwise identical, and two shares of the same stream differ
    only in the prefix fields."""
    if share <= 0 or prefix_len <= 0 or not reqs:
        return reqs
    rng = np.random.default_rng(seed + 7919)
    carrier = rng.random(len(reqs)) < share
    for r, c in zip(reqs, carrier):
        if c:
            r.prefix_id = r.adapter
            r.prefix_len = prefix_len
            r.prompt_len += prefix_len
    return reqs


def expected_prefix_hit_rate(spec: WorkloadSpec) -> float:
    """Analytic prefix-cache hit-rate estimate from workload statistics
    (the twin-side model and the placement features consume this): per
    tenant, every carrier after the first is an expected hit, so the
    expected hit count is ``max(rate * horizon * share - 1, 0)``,
    normalized by total offered requests.  Ignores capacity evictions —
    an upper bound that tightens as slot pressure falls."""
    if spec.prefix_share <= 0 or spec.prefix_len <= 0:
        return 0.0
    total = sum(a.rate * spec.horizon for a in spec.adapters if a.rate > 0)
    if total <= 0:
        return 0.0
    hits = sum(max(a.rate * spec.horizon * spec.prefix_share - 1.0, 0.0)
               for a in spec.adapters if a.rate > 0)
    return hits / total


def generate_requests(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    reqs: List[Request] = []
    uid = 0
    for ad in spec.adapters:
        if ad.rate <= 0:
            continue
        t = 0.0
        arrivals = []
        while True:
            t += rng.exponential(1.0 / ad.rate)
            if t >= spec.horizon:
                break
            arrivals.append(t)
        ins, outs = _sample_lengths(spec.dataset, len(arrivals), rng)
        for a, i, o in zip(arrivals, ins, outs):
            reqs.append(Request(uid=uid, adapter=ad.uid, arrival=a,
                                prompt_len=int(i), output_len=max(int(o), 1)))
            uid += 1
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.uid = i
    return assign_shared_prefixes(reqs, spec.prefix_share, spec.prefix_len,
                                  seed=spec.seed)


def _moment_sampler(mean: float, std: float, rng, lo: int):
    """Positive-valued sampler matching (mean, std) via a lognormal
    (method of moments) — request lengths are heavy-tailed, so this
    preserves queueing behaviour far better than a clipped normal."""
    if std <= 0:
        return lambda: max(int(mean), lo)
    sigma2 = math.log(1.0 + (std / mean) ** 2)
    mu = math.log(mean) - sigma2 / 2.0
    sig = math.sqrt(sigma2)
    return lambda: max(int(rng.lognormal(mu, sig)), lo)


def resample_requests(spec: WorkloadSpec, stats: Dict[str, float],
                      seed_shift: int = 1) -> List[Request]:
    """DT *mean* mode: regenerate a statistically equivalent stream from
    aggregate in/out length stats and the adapter rates."""
    rng = np.random.default_rng(spec.seed + seed_shift)
    sample_in = _moment_sampler(stats["in_mean"], stats["in_std"], rng, 4)
    sample_out = _moment_sampler(stats["out_mean"], stats["out_std"], rng, 1)
    reqs: List[Request] = []
    uid = 0
    for ad in spec.adapters:
        if ad.rate <= 0:
            continue
        t = 0.0
        while True:
            t += rng.exponential(1.0 / ad.rate)
            if t >= spec.horizon:
                break
            reqs.append(Request(uid=uid, adapter=ad.uid, arrival=t,
                                prompt_len=sample_in(), output_len=sample_out()))
            uid += 1
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.uid = i
    return assign_shared_prefixes(reqs, spec.prefix_share, spec.prefix_len,
                                  seed=spec.seed + seed_shift)


def make_adapter_pool(n: int, ranks: Sequence[int], rates: Sequence[float],
                      location: str = "cpu") -> List[Adapter]:
    """Round-robin rank/rate assignment (paper's 'equal distribution')."""
    return [Adapter(uid=i, rank=ranks[i % len(ranks)],
                    rate=rates[i % len(rates)], location=location)
            for i in range(n)]


# --------------------------------------------------------------------------- #
# drifting adapter popularity (the rebalancing workload)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class DriftPhase:
    """Piecewise-constant adapter rates on [start, <next phase start>)."""
    start: float
    rates: Dict[int, float]              # adapter uid -> req/s


def rotating_hot_phases(pool: Sequence[Adapter], horizon: float,
                        n_phases: int = 3, hot_fraction: float = 0.25,
                        hot_rate: float = 0.5,
                        cold_rate: float = 0.02) -> List[DriftPhase]:
    """The drifting-popularity scenario: in each phase a different
    contiguous slice of the pool is 'hot' (skewed traffic), everything
    else trickles.  Phase k's hot set is disjoint from phase k+1's, so
    residency earned in one phase is exactly wrong for the next — the
    workload static routing degrades on and a rebalancer fixes."""
    if n_phases < 1:
        raise ValueError("need at least one phase")
    uids = [a.uid for a in pool]
    hot_n = max(int(len(uids) * hot_fraction), 1)
    phases: List[DriftPhase] = []
    for k in range(n_phases):
        start = horizon * k / n_phases
        hot = {uids[(k * hot_n + j) % len(uids)] for j in range(hot_n)}
        phases.append(DriftPhase(
            start=start,
            rates={u: (hot_rate if u in hot else cold_rate)
                   for u in uids}))
    return phases


def generate_drifting_requests(pool: Sequence[Adapter], dataset: str,
                               horizon: float, phases: Sequence[DriftPhase],
                               seed: int = 0, prefix_share: float = 0.0,
                               prefix_len: int = 0) -> List[Request]:
    """Poisson arrivals with piecewise-constant per-adapter rates."""
    rng = np.random.default_rng(seed)
    phases = sorted(phases, key=lambda p: p.start)
    reqs: List[Request] = []
    uid = 0
    for i, ph in enumerate(phases):
        end = phases[i + 1].start if i + 1 < len(phases) else horizon
        for ad in pool:
            rate = ph.rates.get(ad.uid, ad.rate)
            if rate <= 0:
                continue
            t = ph.start
            arrivals = []
            while True:
                t += rng.exponential(1.0 / rate)
                if t >= end:
                    break
                arrivals.append(t)
            ins, outs = _sample_lengths(dataset, len(arrivals), rng)
            for a, in_len, out_len in zip(arrivals, ins, outs):
                reqs.append(Request(uid=uid, adapter=ad.uid, arrival=a,
                                    prompt_len=int(in_len),
                                    output_len=max(int(out_len), 1)))
                uid += 1
    reqs.sort(key=lambda r: (r.arrival, r.uid))
    for i, r in enumerate(reqs):
        r.uid = i
    return assign_shared_prefixes(reqs, prefix_share, prefix_len, seed=seed)

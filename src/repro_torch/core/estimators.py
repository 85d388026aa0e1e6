"""The five estimators of Eq. (1) + their fitting from benchmark data.

The port's verbatim copy of ``repro.core.estimators``, on the port's own
``StepTiming``, ``StepPlan`` and ``Request``; the measured surface's rows
come from ``repro_torch.bench.kernels_bench`` (kernel launches on the
card).

    Lat_step     = Lat_sched + Lat_load + Lat_model * Lat_adapters
    Lat_sched    = K0 + K1*R_running + K2*R_waiting + K3*R_waiting*(G/N)
    Lat_model    = K4*R_running + K4p*prefill_tokens + K5
    Lat_adapters = K6*A_running + K7
    Lat_load     = per-rank linear (CPU->GPU; disk is a multiplier)
    Mem_max      = KV-token capacity ~ base - c*(slots * mean_rank)

K4p (prefill-token term) is our extension over the paper's Lat_model — the
paper folds prefill into K4*R; we found the explicit term necessary once
prompts exceed a few hundred tokens (recorded as a deviation in DESIGN.md).
Setting ``prefill_term=False`` recovers the paper-exact form.

All constants are FITTED from benchmark rows collected on the real engine
(`collect_benchmark` below drives the engine's executor over controlled
grids, mirroring the paper's §V controlled settings).  The Digital Twin
only ever sees these fits — never the executor's hidden profile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..serving.executor import StepTiming
from ..serving.scheduler import StepPlan
from ..serving.request import Request


@dataclasses.dataclass
class MeasuredStepTimes:
    """Per-step decode-time surface fitted from kernel microbenchmarks.

    The analytic ``Lat_model``/``Lat_adapters`` terms of Eq. (1) come
    from controlled probes of a (possibly synthetic) executor;
    ``MeasuredStepTimes`` replaces them with coefficients fitted from
    *actual kernel launches* (``repro_torch/bench/kernels_bench.py``'s
    measurement mode: the fused flash-decode+LoRA kernel over a
    (rank, batch, seq) grid), so twin/placement decisions reflect what
    the hardware kernels really cost:

        Lat_model(B, pf)  = c0 + cB·B + cBS·B·mean_seq + cBr·B·mean_rank
                            + prefill_per_token · pf
        Lat_adapters(A)   = m0 + m1·A   (unique-adapter multiplier)

    All coefficients are seconds (multiplier dimensionless).  The hook is
    strictly opt-in: a ``FittedEstimators`` with ``measured=None`` is
    bitwise-identical to one fitted before this class existed (pinned by
    ``tests/test_measured_step_times.py``, and for the port by
    ``tests/test_torch_twin.py``).
    """
    decode: np.ndarray          # [c0, cB, cBS, cBr] seconds
    prefill_per_token: float    # seconds per prefill token
    adapters: np.ndarray        # [m0, m1] unique-adapter multiplier
    mean_seq: float = 512.0     # decode context the surface is centred on
    mean_rank: float = 8.0
    source: str = "kernels_bench"

    def lat_model(self, r_run: int, prefill_tokens: int = 0) -> float:
        feats = [1.0, r_run, r_run * self.mean_seq, r_run * self.mean_rank]
        return float(self.decode @ feats) \
            + self.prefill_per_token * prefill_tokens

    def lat_adapters(self, a_run: int) -> float:
        if a_run == 0:
            return 1.0
        return float(self.adapters @ [1.0, a_run])


def fit_measured_step_times(rows: List[dict], mean_seq: float = 512.0,
                            mean_rank: float = 8.0) -> MeasuredStepTimes:
    """Fit the measured step-time surface from kernel benchmark rows.

    ``rows`` come from ``repro_torch.bench.kernels_bench.collect_kernel_rows``:

    * ``kind='decode'``   — batch, seq, rank, t (seconds): one fused
      decode-step launch;
    * ``kind='prefill'``  — tokens, t: one SGMV prefill launch;
    * ``kind='adapters'`` — a_unique, mult: step-time multiplier versus
      the single-adapter launch at the same shape.
    """
    dec = [r for r in rows if r["kind"] == "decode"]
    if not dec:
        raise ValueError("no decode rows to fit a step-time surface from")
    fd = np.array([[1.0, r["batch"], r["batch"] * r["seq"],
                    r["batch"] * r["rank"]] for r in dec])
    decode, *_ = np.linalg.lstsq(fd, np.array([r["t"] for r in dec]),
                                 rcond=None)

    pf = [r for r in rows if r["kind"] == "prefill"]
    if pf:
        fp = np.array([[1.0, r["tokens"]] for r in pf])
        coef, *_ = np.linalg.lstsq(fp, np.array([r["t"] for r in pf]),
                                   rcond=None)
        prefill_per_token = max(float(coef[1]), 0.0)
    else:
        prefill_per_token = 0.0

    ad = [r for r in rows if r["kind"] == "adapters"]
    if ad:
        fa = np.array([[1.0, r["a_unique"]] for r in ad])
        adapters, *_ = np.linalg.lstsq(
            fa, np.array([r["mult"] for r in ad]), rcond=None)
    else:
        adapters = np.array([1.0, 0.0])

    return MeasuredStepTimes(decode=decode,
                             prefill_per_token=prefill_per_token,
                             adapters=adapters, mean_seq=mean_seq,
                             mean_rank=mean_rank)


@dataclasses.dataclass
class FittedEstimators:
    sched: np.ndarray           # [K0, K1, K2, K3]
    model: np.ndarray           # [K5, K4, K4p]
    adapters: np.ndarray        # [K7, K6]
    load: np.ndarray            # [base, per_rank] (cpu)
    load_disk_mult: float
    memmax: np.ndarray          # [base_tokens, per_slot_rank]
    prefill_term: bool = True
    # opt-in: measured kernel step-time surface replacing the analytic
    # Lat_model × Lat_adapters terms (None = paper-exact analytic path)
    measured: Optional[MeasuredStepTimes] = None

    # ------------------------------------------------------------------ #
    def with_measured(self, measured: Optional[MeasuredStepTimes]
                      ) -> "FittedEstimators":
        """Copy of these fits with the measured-kernel surface attached
        (or detached, with ``None``)."""
        return dataclasses.replace(self, measured=measured)

    def lat_sched(self, r_run: int, r_wait: int, slots: int, n: int) -> float:
        g_ratio = slots / max(n, 1)
        return float(self.sched @ [1.0, r_run, r_wait, r_wait * g_ratio])

    def lat_model(self, r_run: int, prefill_tokens: int = 0) -> float:
        if self.measured is not None:
            return self.measured.lat_model(r_run, prefill_tokens)
        pf = prefill_tokens if self.prefill_term else 0
        return float(self.model @ [1.0, r_run, pf])

    def lat_adapters(self, a_run: int) -> float:
        if self.measured is not None:
            return self.measured.lat_adapters(a_run)
        if a_run == 0:
            return 1.0
        return float(self.adapters @ [1.0, a_run])

    def lat_load(self, rank: int, location: str = "cpu") -> float:
        base = float(self.load @ [1.0, rank])
        return base * (self.load_disk_mult if location == "disk" else 1.0)

    def kv_capacity(self, slots: int, mean_rank: float) -> int:
        cap = self.memmax @ [1.0, slots * mean_rank]
        return max(int(cap), 0)

    def lat_step(self, plan: StepPlan, n_waiting: int, slots: int, n: int,
                 ranks: Dict[int, int]) -> StepTiming:
        load = sum(self.lat_load(ranks.get(u, 8)) for u in plan.cold_loads)
        model = self.lat_model(len(plan.running), plan.prefill_tokens)
        model *= self.lat_adapters(len(plan.unique_adapters))
        return StepTiming(
            sched=self.lat_sched(len(plan.running), n_waiting, slots, n),
            load=load, model=model)


# --------------------------------------------------------------------------- #
# benchmark collection (controlled probes of the real engine's executor)
# --------------------------------------------------------------------------- #

def _mk_plan(r_run: int, n_unique: int, prefill_tokens: int,
             cold_loads: Sequence[int] = ()) -> StepPlan:
    running = [Request(uid=i, adapter=i % max(n_unique, 1), arrival=0.0,
                       prompt_len=1, output_len=8) for i in range(r_run)]
    admitted = []
    if prefill_tokens and running:
        running[0].prompt_len = prefill_tokens
        admitted = [running[0]]
    return StepPlan(admitted=admitted, preempted=[],
                    cold_loads=list(cold_loads), running=running)


def collect_benchmark(executor, slots: int, n_adapters: int,
                      ranks: Dict[int, int],
                      r_grid: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
                      a_grid: Sequence[int] = (0, 1, 2, 4, 8, 16, 32),
                      w_grid: Sequence[int] = (0, 8, 64, 256),
                      pf_grid: Sequence[int] = (0, 128, 512, 2048),
                      reps: int = 3) -> List[dict]:
    """Probe the executor over controlled grids; returns benchmark rows."""
    rows: List[dict] = []
    for _ in range(reps):
        for r in r_grid:
            for a in [x for x in a_grid if x <= r] or [1]:
                for w in w_grid:
                    plan = _mk_plan(r, max(a, 1) if a else 0, 0)
                    if a == 0:
                        plan = StepPlan([], [], [], [
                            Request(uid=i, adapter=-1, arrival=0.0,
                                    prompt_len=1, output_len=8)
                            for i in range(r)])
                    t = executor.step(plan, w)
                    rows.append(dict(kind="step", r_run=r, a_run=a,
                                     n_wait=w, prefill=0,
                                     sched=t.sched, model=t.model))
            for pf in pf_grid[1:]:
                plan = _mk_plan(r, 1, pf)
                t = executor.step(plan, 0)
                rows.append(dict(kind="step", r_run=r, a_run=1, n_wait=0,
                                 prefill=pf, sched=t.sched, model=t.model))
        for rank in sorted(set(ranks.values()) or {8, 16, 32}):
            plan = _mk_plan(1, 1, 0, cold_loads=[0])
            executor.ranks = dict(executor.ranks) if hasattr(
                executor, "ranks") else {}
            if hasattr(executor, "ranks"):
                executor.ranks[0] = rank
            t = executor.step(plan, 0)
            rows.append(dict(kind="load", rank=rank, load=t.load))
    return rows


def collect_memmax(profile, slot_grid=(8, 32, 128, 384),
                   rank_grid=(8, 16, 32), seed: int = 0) -> List[dict]:
    """Measure observed KV capacity per (slots, rank) — in a real deployment
    this is the max-batch-before-OOM probe; here it queries the engine's
    memory accounting (with measurement noise)."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in slot_grid:
        for rk in rank_grid:
            cap = profile.kv_capacity(s, rk)
            cap = int(cap * (1.0 + rng.normal(0, 0.01)))
            rows.append(dict(slots=s, rank=rk, capacity=cap))
    return rows


# --------------------------------------------------------------------------- #
# fitting
# --------------------------------------------------------------------------- #

def _lstsq(feats: np.ndarray, y: np.ndarray) -> np.ndarray:
    coef, *_ = np.linalg.lstsq(feats, y, rcond=None)
    return coef


def fit_estimators(step_rows: List[dict], mem_rows: List[dict],
                   slots: int, n_adapters: int,
                   load_disk_mult: float = 1.7,
                   prefill_term: bool = True) -> FittedEstimators:
    srows = [r for r in step_rows if r["kind"] == "step"]
    lrows = [r for r in step_rows if r["kind"] == "load"]

    # scheduler: K0 + K1 R + K2 W + K3 W*(G/N)
    g_ratio = slots / max(n_adapters, 1)
    fs = np.array([[1.0, r["r_run"], r["n_wait"], r["n_wait"] * g_ratio]
                   for r in srows])
    sched = _lstsq(fs, np.array([r["sched"] for r in srows]))

    # model+adapters (joint): model_obs = (K5 + K4 R + K4p pf) * (K7 + K6 A)
    # two-stage: fit base on A<=1 rows, then fit multiplier.
    base_rows = [r for r in srows if r["a_run"] <= 1]
    fb = np.array([[1.0, r["r_run"], r["prefill"]] for r in base_rows])
    model = _lstsq(fb, np.array([r["model"] for r in base_rows]))
    if not prefill_term:
        model = np.array([model[0], model[1], 0.0])

    multi_rows = [r for r in srows if r["a_run"] >= 1 and r["prefill"] == 0]
    base_pred = np.array([[1.0, r["r_run"], r["prefill"]] for r in multi_rows]
                         ) @ model
    ratio = np.array([r["model"] for r in multi_rows]) / np.maximum(
        base_pred, 1e-9)
    fa = np.array([[1.0, r["a_run"]] for r in multi_rows])
    adapters = _lstsq(fa, ratio)

    # base was fitted on A==1 rows which already include the 1-adapter
    # multiplier; renormalise so (adapters @ [1, a]) is the multiplier on
    # the adapterless base.
    one = float(adapters @ [1.0, 1.0])
    if one > 0:
        model = model / one * 1.0
        # refit multiplier against the adapterless base
        base_pred = np.array(
            [[1.0, r["r_run"], r["prefill"]] for r in multi_rows]) @ model
        ratio = np.array([r["model"] for r in multi_rows]) / np.maximum(
            base_pred, 1e-9)
        adapters = _lstsq(fa, ratio)

    fl = np.array([[1.0, r["rank"]] for r in lrows]) if lrows else \
        np.array([[1.0, 8.0]])
    load = _lstsq(fl, np.array([r["load"] for r in lrows])) if lrows else \
        np.array([0.008, 0.001])

    fm = np.array([[1.0, r["slots"] * r["rank"]] for r in mem_rows])
    memmax = _lstsq(fm, np.array([float(r["capacity"]) for r in mem_rows]))

    return FittedEstimators(sched=sched, model=model, adapters=adapters,
                            load=load, load_disk_mult=load_disk_mult,
                            memmax=memmax, prefill_term=prefill_term)

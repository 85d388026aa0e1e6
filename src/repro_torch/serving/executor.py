"""Executors of the port: supply the step-time components of Eq. (1).

``TorchExecutor`` mirrors ``repro.serving.executor.JaxExecutor``
(executor.py:100-149) line for line: it runs one ``Model.decode_step`` per
engine step over a fixed ``max_batch`` and ``cache_len`` with per-request
adapter ids, and reports measured wall times.  As the JAX executor compiles
its step once (``jax.jit``, executor.py:118), on CUDA it captures the step
once as a CUDA graph and replays that graph every step; on the CPU it runs
the step eagerly with the kernels' plain versions.

``HardwareProfile`` and ``SyntheticExecutor`` are verbatim copies of the
JAX package's (executor.py:37-98): step times from a hidden profile, which
the twin's base estimators are fitted from (``core.estimators``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .scheduler import StepPlan


@dataclasses.dataclass
class StepTiming:
    sched: float
    load: float
    model: float

    @property
    def total(self) -> float:
        return self.sched + self.load + self.model


@dataclasses.dataclass
class HardwareProfile:
    """Hidden ground-truth constants of the synthetic serving node."""
    name: str = "h100-llama8b"
    # Lat_sched = s1*R_run + s2*R_wait + s3*R_wait*(slots/adapters)
    s1: float = 8e-6
    s2: float = 4e-6
    s3: float = 2.5e-5
    sched_base: float = 4e-4
    # Lat_model = m1*R_run + m2*prefill_tokens + m_base
    m1: float = 2.2e-4
    m2: float = 6.5e-6
    m_base: float = 2.4e-2
    # Lat_adapters (multiplicative) = 1 + a1*A_unique (+a0 if any adapter)
    a0: float = 0.06
    a1: float = 0.004
    # loading: seconds per rank unit from cpu / disk
    load_cpu_per_rank: float = 1.1e-3
    load_cpu_base: float = 8e-3
    load_disk_mult: float = 1.7
    # memory model (tokens of KV per device after weights)
    total_kv_tokens: int = 200_000
    kv_tokens_per_rank_slot: float = 220.0
    noise: float = 0.015

    def kv_capacity(self, slots: int, mean_rank: float) -> int:
        cap = self.total_kv_tokens - \
            int(slots * mean_rank / 8.0 * self.kv_tokens_per_rank_slot)
        return max(cap, 0)


class SyntheticExecutor:
    def __init__(self, profile: Optional[HardwareProfile] = None,
                 ranks: Optional[Dict[int, int]] = None,
                 slots: int = 0, n_adapters: int = 1, seed: int = 0):
        self.profile = profile or HardwareProfile()
        self.ranks = ranks or {}
        self.slots = max(slots, 1)
        self.n_adapters = max(n_adapters, 1)
        self.rng = np.random.default_rng(seed)

    def _noise(self) -> float:
        p = self.profile
        return float(1.0 + self.rng.normal(0.0, p.noise)) if p.noise else 1.0

    def step(self, plan: StepPlan, n_waiting: int) -> StepTiming:
        p = self.profile
        r_run = len(plan.running)
        sched = (p.sched_base + p.s1 * r_run + p.s2 * n_waiting
                 + p.s3 * n_waiting * (self.slots / self.n_adapters))
        load = 0.0
        for uid in plan.cold_loads:
            rank = self.ranks.get(uid, 8)
            load += (p.load_cpu_base + p.load_cpu_per_rank * rank)
        model = p.m_base + p.m1 * r_run + p.m2 * plan.prefill_tokens
        a = len(plan.unique_adapters)
        adapters_mult = 1.0 + (p.a0 + p.a1 * a if a > 0 else 0.0)
        model *= adapters_mult
        return StepTiming(sched=sched * self._noise(),
                          load=load * self._noise(),
                          model=model * self._noise())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchExecutor:
    """Runs a real model, one decode step per engine step.

    Fixed-capacity batch shapes (requests packed into ``max_batch`` rows),
    as the JAX executor keeps them for its one jit cache entry.  ``device``
    defaults to CUDA and must be the model's.

    On CUDA the constructor warms the step up eagerly on a side stream (the
    kernel build, cuBLAS's workspace), resets the cache (``pos`` and its
    tensors) and captures one ``decode_step`` into a
    ``torch.cuda.CUDAGraph``, the counterpart of the
    JAX executor's single jit cache entry; a failed capture raises.  The
    graph reads the adapter ids from ``ids`` and the position from the
    cache's ``pos``, both static device buffers, and writes ``last_logits``.
    ``graph_launches`` is what one replay launches (wrapper -> count) and
    ``replays`` how many replays ran.  On the CPU the step runs eagerly.
    """

    def __init__(self, model, lora, max_batch: int = 8,
                 cache_len: int = 256, device=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"executor on {self.device}, model on "
                             f"{model.device}")
        self.model = model
        self.lora = lora
        self.max_batch, self.cache_len = max_batch, cache_len
        self.cache = model.init_cache(max_batch, cache_len)
        # the JAX executor's constant zero token (executor.py:117)
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.long,
                                  device=self.device)
        self.ids = torch.zeros((max_batch,), dtype=torch.int32,
                               device=self.device)
        self.last_logits = None
        self.graph = None
        self.graph_launches: Dict[str, int] = {}
        self.replays = 0
        # the ids' host side, pinned on CUDA so their copy is asynchronous
        self._ids_host = torch.zeros((max_batch,), dtype=torch.int32,
                                     pin_memory=self.device.type == "cuda")
        if self.device.type == "cuda":
            self._capture()
        else:
            self._decode_eager(self.ids)   # warmup
            self._reset_cache()

    def _reset_cache(self) -> None:
        """Undo the warmup step: ``pos`` and every cache tensor back to 0.
        The JAX executor discards its warmup's cache (executor.py:120-123);
        here the step wrote in place, and an rglru or ssd layer's states,
        unlike a KV row the first step overwrites, would carry it on."""
        self.cache["pos"].zero_()
        for layer in self.cache["layers"]:
            for t in layer.values():
                t.zero_()

    def _decode_eager(self, ids):
        return self.model.decode_step(self.lora, self.cache, self.tokens,
                                      ids)[0]

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_eager(self.ids)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._reset_cache()
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.last_logits = self._decode_eager(self.ids)
        self.graph_launches = {k: n - before[k]
                               for k, n in ops.launch_counts().items()
                               if n != before[k]}
        # the capture counted its wrappers' calls but launched nothing
        ops.add_launches(self.graph_launches, -1)

    def decode(self, idx: np.ndarray) -> torch.Tensor:
        """One decode step with adapter ids ``idx`` (max_batch,) int32;
        returns the logits (max_batch, V), synchronised.  The ids go into
        the static buffer ``ids`` (on CUDA one copy from pinned memory),
        then the graph replays, or on the CPU the step runs eagerly."""
        self._ids_host.numpy()[:] = idx
        self.ids.copy_(self._ids_host, non_blocking=True)
        if self.graph is None:
            self.last_logits = self._decode_eager(self.ids)
        else:
            self.graph.replay()
            ops.add_launches(self.graph_launches)
            self.replays += 1
        _sync(self.device)
        return self.last_logits

    def step(self, plan: StepPlan, n_waiting: int) -> StepTiming:
        t0 = time.perf_counter()
        idx = np.zeros((self.max_batch,), np.int32)
        for i, req in enumerate(plan.running[: self.max_batch]):
            idx[i] = req.adapter % max(self.lora_count(), 1)
        t_sched = time.perf_counter() - t0

        t1 = time.perf_counter()
        self.decode(idx)
        # emulate prefill cost: extra decode steps pro-rated by tokens
        t_model = time.perf_counter() - t1
        if plan.prefill_tokens:
            t_model *= 1.0 + plan.prefill_tokens / max(len(plan.running), 1)
        t_load = 0.002 * len(plan.cold_loads)
        return StepTiming(sched=t_sched, load=t_load, model=t_model)

    def lora_count(self) -> int:
        """Adapters in the bank: axis 0 of the first LoRA leaf of the first
        layer that has a bank (axis 1 of the JAX package's stacked leaf).
        The JAX executor reads segment 0's first block whatever it is
        (executor.py:145-149): on recurrentgemma that is an rglru block,
        whose placeholder gives 1, so every request there is served on
        adapter 0; the port keeps each request's adapter (ROADMAP.md
        queue 3, reference behaviours).  With no bank at all (mamba2) it
        is 1, as the JAX placeholder gives: every request runs as adapter
        0 on both sides."""
        for layer in self.lora["layers"]:
            for v in layer.values():
                return v.shape[0]
        return 1

"""Executor of the port: supplies the engine's step times from a real model.

``TorchExecutor`` mirrors ``repro.serving.executor.JaxExecutor``
(executor.py:100-149) line for line: it runs one ``Model.decode_step`` per
engine step over a fixed ``max_batch`` and ``cache_len`` with per-request
adapter ids, and reports measured wall times.  Steps run eagerly; replaying
the step as a CUDA graph is ROADMAP.md queue 1 item 13.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from .scheduler import StepPlan


@dataclasses.dataclass
class StepTiming:
    sched: float
    load: float
    model: float

    @property
    def total(self) -> float:
        return self.sched + self.load + self.model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TorchExecutor:
    """Runs a real model, one decode step per engine step.

    Fixed-capacity batch shapes (requests packed into ``max_batch`` rows),
    as the JAX executor keeps them for its one jit cache entry.  ``device``
    defaults to CUDA and must be the model's.
    """

    def __init__(self, model, lora, max_batch: int = 8,
                 cache_len: int = 256, device=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"executor on {self.device}, model on "
                             f"{model.device}")
        self.model = model
        self.lora = lora
        self.max_batch = max_batch
        self.cache = model.init_cache(max_batch, cache_len)
        # the JAX executor's constant zero token (executor.py:117)
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.long,
                                  device=self.device)
        self.last_logits = None
        # warmup (its cache write at pos 0 is overwritten by the first step)
        idx = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        model.decode_step(lora, self.cache, self.tokens, idx)
        _sync(self.device)

    def step(self, plan: StepPlan, n_waiting: int) -> StepTiming:
        t0 = time.perf_counter()
        idx = np.zeros((self.max_batch,), np.int32)
        for i, req in enumerate(plan.running[: self.max_batch]):
            idx[i] = req.adapter % max(self.lora_count(), 1)
        t_sched = time.perf_counter() - t0

        t1 = time.perf_counter()
        logits, self.cache = self.model.decode_step(
            self.lora, self.cache, self.tokens,
            torch.from_numpy(idx).to(self.device))
        _sync(self.device)
        self.last_logits = logits
        # emulate prefill cost: extra decode steps pro-rated by tokens
        t_model = time.perf_counter() - t1
        if plan.prefill_tokens:
            t_model *= 1.0 + plan.prefill_tokens / max(len(plan.running), 1)
        t_load = 0.002 * len(plan.cold_loads)
        return StepTiming(sched=t_sched, load=t_load, model=t_model)

    def lora_count(self) -> int:
        """Adapters in the bank: axis 0 of the first per-layer LoRA leaf
        (axis 1 of the JAX package's stacked leaf)."""
        for v in self.lora["layers"][0].values():
            return v.shape[0]
        return 1

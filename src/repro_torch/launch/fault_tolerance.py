"""Fault-tolerant step loop of the port's train launcher (counterpart of
``repro.launch.fault_tolerance``).

The JAX package's step, checkpoint and restart arithmetic:
  * periodic async checkpoints with atomic commit (``CheckpointManager``),
  * a crash -> a restart from the latest committed step,
  * a straggler watchdog: a step slower than ``straggler_factor`` x the
    median of the last 20 is logged and counted,
  * failure injection for the tests.

The port's train step updates its tensors in place, so the loop's state
is live: ``{"params": the model's trainable parameters by name, "opt": the
AdamW state}``.  ``resume_or_init`` writes the checkpoint into the
skeleton's tensors in place (the model's parameters among them), and
``init_fn`` must reset the state in place and return it.  The state's
own tensors say which device it lives on.

The JAX ``shardings`` argument is ``specs`` and ``plan`` here: under a
train plan the state holds the rank's pieces, ``specs`` is their tree of
specs (``training.train_lib.train_state_specs``) and ``plan`` the plan
the state lives under.  Every rank runs the loop: each save gathers the
pieces whole and rank 0 writes them; a resume takes rank 0's newest
committed step on every rank (rank 0 joins its write first) and restores
each rank's pieces under ``plan``, which may lie on a mesh other than the
one that saved.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, copy_into
from ..checkpoint.manager import _flatten


@dataclasses.dataclass
class FTConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 3


@dataclasses.dataclass
class FTReport:
    steps_run: int = 0
    restarts: int = 0
    resumed_from: Optional[int] = None
    stragglers: List[int] = dataclasses.field(default_factory=list)
    step_times: List[float] = dataclasses.field(default_factory=list)


def _synchronize(state) -> None:
    """Wait for the CUDA devices the state's tensors live on."""
    for dev in {t.device for t in _flatten(state).values()
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class FaultTolerantLoop:
    def __init__(self, cfg: FTConfig, state_skeleton: Dict[str, Any],
                 specs: Optional[Any] = None, plan: Optional[Any] = None):
        self.cfg = cfg
        self.mgr = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep)
        self.skeleton = state_skeleton
        self.specs, self.plan = specs, plan
        self.report = FTReport()

    def resume_or_init(self, init_fn: Callable[[], Dict[str, Any]]
                       ) -> Dict[str, Any]:
        """``init_fn()`` when no step is committed; else the latest step
        written into the skeleton's tensors in place, and the skeleton."""
        latest = self.mgr.latest_step(self.plan)
        if latest is None:
            return init_fn()
        self.report.resumed_from = latest
        copy_into(self.skeleton, self.mgr.restore(
            self.skeleton, latest, specs=self.specs, plan=self.plan))
        return self.skeleton

    def run(self, state: Dict[str, Any], step_fn: Callable,
            batch_fn: Callable[[int], Any], n_steps: int,
            start_step: int = 0,
            failure_at: Optional[int] = None) -> Dict[str, Any]:
        """Run steps [start_step, n_steps); ``failure_at`` injects a crash.

        A step's time runs from the state's devices idle to their work
        done: the clock is read after a synchronise on each side, or on
        CUDA it would time only the host's dispatch."""
        step = start_step
        while step < n_steps:
            if failure_at is not None and step == failure_at:
                failure_at = None  # fail once
                raise RuntimeError(f"injected failure at step {step}")
            _synchronize(state)
            t0 = time.perf_counter()
            state = step_fn(state, batch_fn(step))
            _synchronize(state)
            dt = time.perf_counter() - t0
            self.report.step_times.append(dt)
            med = float(np.median(self.report.step_times[-20:]))
            if len(self.report.step_times) > 5 and \
                    dt > self.cfg.straggler_factor * med:
                self.report.stragglers.append(step)
            step += 1
            self.report.steps_run += 1
            if step % self.cfg.checkpoint_every == 0 or step == n_steps:
                self.mgr.save(step, state, specs=self.specs, plan=self.plan)
        self.mgr.wait()
        return state

    def run_with_restarts(self, init_fn, step_fn, batch_fn, n_steps: int,
                          failure_at: Optional[int] = None
                          ) -> Dict[str, Any]:
        restarts = 0
        while True:
            state = self.resume_or_init(init_fn)
            start = self.mgr.latest_step(self.plan) or 0
            try:
                return self.run(state, step_fn, batch_fn, n_steps,
                                start_step=start, failure_at=failure_at)
            except RuntimeError:
                restarts += 1
                self.report.restarts = restarts
                failure_at = None
                if restarts > self.cfg.max_restarts:
                    raise

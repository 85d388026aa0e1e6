"""The online LLM-adapter serving engine (our vLLM analogue).

Continuous-batching loop on a virtual clock advanced by executor-reported
step times: mixed prefill+decode batches, FCFS + loaded-adapter priority,
greedy paged-KV allocation with preemption-by-recompute, LRU adapter slots.

This is the "real system" that the Digital Twin (repro.core.digital_twin)
replicates: identical scheduling semantics, real (measured or
hidden-profile) step times.

The loop is *resumable*: ``submit()`` enqueues arrivals, ``run_until()``
advances the virtual clock to a bound and returns, ``finalize()``
summarizes.  Two front-ends drive the resumable surface: the cluster's
epoch loop (``ServingCluster.run_online`` interleaves replicas window by
window) and the open-loop async gateway
(``repro.serving.gateway.AsyncGateway`` submits arrivals as they happen
and advances the engine between them, streaming tokens through the
``on_token`` hook).  ``run()`` composes the three calls and keeps the
original single-shot closed-loop semantics — it is a convenience
entrypoint, not the only serving path.  Fault-tolerance hooks:
``drain()`` pulls every unfinished request off a dead replica for
re-routing; ``preload_adapter()`` / ``evict_adapter()`` let a rebalancer
migrate adapter residency between replicas, charging the migration's
load cost to this replica's clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

from .adapter_cache import AdapterSlotCache
from .executor import StepTiming
from .kv_cache import PagedKVCache
from .metrics import ServingMetrics, summarize
from .prefix_cache import SharedPrefixCache
from .request import Request
from .scheduler import Scheduler


@dataclasses.dataclass
class EngineConfig:
    kv_capacity_tokens: int
    adapter_slots: int
    max_running: int = 256
    block_size: int = 16
    max_steps: int = 2_000_000
    # admission/preemption policy (repro.serving.policy registry); "fcfs"
    # is the paper's fixed vLLM scheduler and the byte-identical default
    sched_policy: str = "fcfs"
    # S-LoRA mode (paper §V-B): no fixed slots; adapter weights share the
    # unified paged pool, charged per adapter in KV-token equivalents.
    dynamic_slots: bool = False
    adapter_kv_tokens: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    # cross-adapter shared-prefix KV reuse (repro.serving.prefix_cache);
    # off by default — requests with prefix_id=None behave identically
    # either way, so False keeps every pre-existing run bitwise-pinned
    prefix_cache: bool = False


@dataclasses.dataclass
class StepTrace:
    t: float
    n_running: int
    n_waiting: int
    kv_used: float
    lat: float


class ServingEngine:
    def __init__(self, cfg: EngineConfig, executor):
        self.cfg = cfg
        self.executor = executor
        self.kv = PagedKVCache(cfg.kv_capacity_tokens, cfg.block_size)
        if cfg.dynamic_slots:
            def reserve(uid: int, dry: bool = False) -> bool:
                toks = cfg.adapter_kv_tokens.get(uid, 256)
                if dry:
                    # uid-aware: a re-reserve for an adapter with block
                    # slack must not be priced from an empty table
                    return self.kv.can_allocate(toks, uid=-(uid + 1))
                return self.kv.allocate(-(uid + 1), toks)

            def release(uid: int) -> None:
                self.kv.free(-(uid + 1))

            self.adapters = AdapterSlotCache(
                0, dynamic=True, reserve=reserve, release=release)
        else:
            self.adapters = AdapterSlotCache(cfg.adapter_slots)
        self.prefix: Optional[SharedPrefixCache] = \
            SharedPrefixCache(self.kv) if cfg.prefix_cache else None
        self.scheduler = Scheduler(self.kv, self.adapters, cfg.max_running,
                                   policy=cfg.sched_policy,
                                   prefix=self.prefix)
        self.trace: List[StepTrace] = []
        # streaming hook: called as ``on_token(req, t)`` for every token
        # the step loop generates (the async gateway fans these out to
        # per-request SSE streams).  None = no overhead on the hot loop.
        self.on_token: Optional[Callable[[Request, float], None]] = None
        self.reset_stream()

    # ------------------------------------------------------------------ #
    # resumable stream state
    # ------------------------------------------------------------------ #
    def reset_stream(self) -> None:
        """Start a fresh request stream (clock back to zero)."""
        self.scheduler.policy.reset()
        if self.prefix is not None:
            self.prefix.reset()
        self.clock = 0.0
        self.halted = False
        self._pending: List[Request] = []
        self._next = 0
        self._accepted: List[Request] = []
        self._iters = 0
        self._max_kv = 0.0
        # busy-time / executed-step / output-token counters (straggler
        # detection + the rebalancer's observed service rate)
        self.busy_time = 0.0
        self.n_exec_steps = 0
        self.n_tokens_out = 0
        # fault-injection state: >1.0 slows every step (straggler
        # window); n_load_faults counts refused preloads/restores
        self.slow_factor = 1.0
        self.n_load_faults = 0

    def submit(self, requests: List[Request]) -> None:
        """Enqueue arrivals (any order); may be called between epochs."""
        if not requests:
            return
        rest = self._pending[self._next:]
        self._pending = sorted(rest + list(requests), key=lambda r: r.arrival)
        self._next = 0
        self._accepted.extend(requests)

    def run_until(self, t_end: Optional[float] = None,
                  record_trace: bool = False, strict: bool = False) -> None:
        """Advance the continuous-batching loop until the clock reaches
        ``t_end`` (None = run the submitted stream to completion).

        ``strict`` keeps the clock from fast-forwarding past ``t_end``
        toward future arrivals — the online epoch loop needs that so a
        replica idle *this* epoch is still at ``t_end`` when the next
        epoch submits more work.  Non-strict mode reproduces the original
        single-shot ``run()`` semantics exactly.
        """
        if self.halted:
            return
        while self._iters < self.cfg.max_steps:
            self._iters += 1
            t = self.clock
            if t_end is not None and t >= t_end:
                return
            # idle fast-forward
            if not self.scheduler.has_work:
                if self._next >= len(self._pending):
                    return
                nxt = self._pending[self._next].arrival
                if strict and t_end is not None and nxt >= t_end:
                    self.clock = max(self.clock, min(nxt, t_end))
                    return
                t = max(t, nxt)
            while self._next < len(self._pending) and \
                    self._pending[self._next].arrival <= t:
                self.scheduler.add([self._pending[self._next]])
                self._next += 1
            plan = self.scheduler.schedule(t)
            if not plan.running:
                # blocked (e.g. waiting requests that cannot be admitted yet)
                if self._next < len(self._pending):
                    nxt = self._pending[self._next].arrival
                    if strict and t_end is not None and nxt >= t_end:
                        self.clock = max(self.clock, min(nxt, t_end))
                        return
                    self.clock = max(t, nxt)
                    continue
                self.clock = t
                return
            timing: StepTiming = self.executor.step(
                plan, self.scheduler.n_waiting)
            total = timing.total
            # guarded multiply: float * 1.0 is an identity but the guard
            # keeps the healthy path free of any fp op (bitwise pinning)
            if self.slow_factor != 1.0:
                total *= self.slow_factor
            t += total
            self.busy_time += total
            self.n_exec_steps += 1
            self.n_tokens_out += len(plan.running)
            self._max_kv = max(self._max_kv, self.kv.used_fraction)
            if record_trace:
                self.trace.append(StepTrace(
                    t, len(plan.running), self.scheduler.n_waiting,
                    self.kv.used_fraction, total))
            # plan.running is already a snapshot; finish() mutates only the
            # scheduler's own list, so no per-step defensive copy is needed
            on_token = self.on_token
            for req in plan.running:
                req.generated += 1
                req.token_times.append(t)
                if req.first_token_at is None:
                    req.first_token_at = t
                if req.done:
                    req.finished_at = t
                    self.scheduler.finish(req)
                if on_token is not None:
                    on_token(req, t)
            self.clock = t

    @property
    def queue_depth(self) -> int:
        """Admitted-but-unfinished requests on this engine: the scheduler's
        waiting + running sets plus submitted arrivals the clock has not
        reached yet.  The gateway's admission controller multiplies this
        by a predicted per-request service time to estimate backlog."""
        return (self.scheduler.n_waiting + self.scheduler.n_running
                + len(self._pending) - self._next)

    def finalize(self) -> ServingMetrics:
        duration = max(self.clock, 1e-9)
        arrived = [r for r in self._accepted if r.arrival <= duration]
        offered = sum(r.output_len for r in arrived)
        pc = self.prefix
        return summarize(self._accepted, duration, offered, self._max_kv,
                         self.adapters.load_count, self.n_load_faults,
                         n_prefix_hits=pc.n_hits if pc else 0,
                         n_prefix_misses=pc.n_misses if pc else 0,
                         n_prefix_evictions=pc.n_evictions if pc else 0,
                         prefix_tokens_saved=pc.tokens_saved if pc else 0)

    # ------------------------------------------------------------------ #
    # fault-tolerance / rebalancing hooks
    # ------------------------------------------------------------------ #
    def drain(self) -> List[Request]:
        """Pull every unfinished request off this (dead) replica.

        Frees their KV blocks and adapter pins, halts the engine, and
        removes them from this engine's accounting so the survivor that
        re-serves them is the only replica counting them.  Progress is
        NOT reset here — the re-router decides recompute semantics.
        """
        orphans = (list(self.scheduler.running)
                   + list(self.scheduler.waiting)
                   + self._pending[self._next:])
        for req in list(self.scheduler.running):
            self.kv.free(req.uid)
            self.adapters.unpin(req.adapter)
            if self.prefix is not None:
                self.prefix.release(req.uid)
        self.scheduler.clear()
        self._pending = []
        self._next = 0
        dead_uids = {r.uid for r in orphans}
        self._accepted = [r for r in self._accepted
                          if r.uid not in dead_uids]
        self.halted = True
        return orphans

    def preload_adapter(self, uid: int, cost_s: float = 0.0) -> bool:
        """Warm-load an adapter (migration target side), charging the
        Fig. 4 load cost to this replica's clock.  An adapter already
        resident here is a free success (the migration is belief-only).
        Returns False when the cache has no loadable slot (migration
        must be declined)."""
        if self.adapters.is_loaded(uid):
            self.adapters.touch(uid, self.clock)
            return True
        if uid in self.adapters.failing:
            self.n_load_faults += 1
            return False
        if not self.adapters.can_load(uid):
            return False
        self.adapters.load(uid, self.clock)
        # the clock pays the Fig. 4 cost, but busy_time stays pure step
        # execution time: it feeds the straggler detector's mean-step
        # estimate, which a migration must not inflate
        self.clock += cost_s
        return True

    def evict_adapter(self, uid: int) -> bool:
        """Drop an adapter's residency (migration source side)."""
        return self.adapters.evict(uid)

    def stall_until(self, t: float) -> None:
        """Transient executor fault: jump the clock to ``t`` without
        serving anything (no busy time, no heartbeat-worthy progress)."""
        self.clock = max(self.clock, t)

    def snapshot(self) -> dict:
        """Crash-recovery checkpoint: clock + resident adapter set.
        Request state is NOT captured — orphans re-route via drain()."""
        return {"clock": self.clock,
                "adapters": sorted(self.adapters.loaded)}

    def restore(self, snap: dict, now: float,
                load_cost_fn: Optional[Callable[[int], float]] = None
                ) -> List[int]:
        """Rejoin after a crash: un-halt, advance the clock to ``now``
        and reload the snapshot's adapter set, charging the Fig. 4 cost
        per adapter via ``load_cost_fn``.  Adapters currently
        fault-failing are skipped (counted ``n_load_faults``).  Returns
        the uids actually reloaded."""
        self.halted = False
        self.clock = max(now, self.clock)
        # the crash wiped GPU state: residency/pins restart from the
        # snapshot without counting phantom evictions; cached prefixes
        # are gone too (counters survive — they are lifetime metrics)
        self.adapters.loaded.clear()
        self.adapters.pinned.clear()
        if self.prefix is not None:
            self.prefix.wipe()
        reloaded: List[int] = []
        for uid in snap.get("adapters", []):
            if uid in self.adapters.failing:
                self.n_load_faults += 1
                continue
            self.adapters.load(uid, self.clock)
            if load_cost_fn is not None:
                self.clock += load_cost_fn(uid)
            reloaded.append(uid)
        return reloaded

    def cancel(self, uid: int, forget: bool = False) -> Optional[Request]:
        """Pull one request out of the engine (timeout retry / client
        disconnect).  Frees its KV blocks and adapter pin if running.
        ``forget`` also removes it from this engine's accounting — used
        when the request is re-submitted elsewhere (no double-count);
        a finally-failed request stays accounted here."""
        found: Optional[Request] = None
        for i in range(self._next, len(self._pending)):
            if self._pending[i].uid == uid:
                found = self._pending.pop(i)
                break
        if found is None:
            for req in self.scheduler.waiting:
                if req.uid == uid:
                    found = req
                    break
            if found is not None:
                self.scheduler.waiting = type(self.scheduler.waiting)(
                    r for r in self.scheduler.waiting if r.uid != uid)
        if found is None and uid in self.scheduler._pos:
            found = self.scheduler.running[self.scheduler._pos[uid]]
            self.scheduler._remove_running(found)
            self.kv.free(uid)
            self.adapters.unpin(found.adapter)
            if self.prefix is not None:
                self.prefix.release(uid)
        if found is not None and forget:
            self._accepted = [r for r in self._accepted if r.uid != uid]
        return found

    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request], horizon: Optional[float] = None,
            record_trace: bool = False) -> ServingMetrics:
        """Single-shot: submit the whole stream, run to horizon/completion,
        summarize.  Identical semantics to the pre-resumable engine."""
        self.reset_stream()
        self.submit(requests)
        self.run_until(horizon if horizon is not None else math.inf,
                       record_trace=record_trace)
        return self.finalize()

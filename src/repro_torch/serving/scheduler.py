"""Continuous-batching scheduler: greedy KV allocation with
preemption-by-recompute, admission order delegated to a pluggable
``SchedulingPolicy`` (default ``fcfs`` = FCFS + vLLM adapter-slot
priority, the paper's fixed scheduler).

This class is shared verbatim by the real engine and the Digital Twin —
the paper's DT replicates scheduling *logic* exactly (Fig. 8: "As vLLM, we
use a FCFS policy and a greedy allocation of KV cache"); only step *times*
and memory *capacity* differ (measured vs estimated).  The policy seam
(``repro.serving.policy``) keeps that replication intact: the same policy
instance drives identical decisions here and in the struct-of-arrays
``FastEngine``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Set, Union

from .adapter_cache import AdapterSlotCache
from .kv_cache import PagedKVCache
from .policy import (SchedulingPolicy, SchedView, make_sched_policy,
                     overrides_victim)
from .prefix_cache import SharedPrefixCache
from .request import Request


@dataclasses.dataclass
class StepPlan:
    admitted: List[Request]          # requests prefilling this step
    preempted: List[Request]
    cold_loads: List[int]            # adapter uids loaded from host this step
    running: List[Request]           # full running batch (incl. admitted)
    # prompt tokens served from the shared-prefix cache this step: the
    # Eq. (1) prefill term (and every executor's) skips them
    prefill_covered: int = 0

    @property
    def unique_adapters(self) -> Set[int]:
        return {r.adapter for r in self.running}

    @property
    def prefill_tokens(self) -> int:
        return sum(r.context_len for r in self.admitted) \
            - self.prefill_covered


class _RequestView(SchedView):
    """Policy accessors over ``Request`` objects."""

    __slots__ = ("_adapters",)

    def __init__(self, adapters: AdapterSlotCache):
        self._adapters = adapters

    def arrival(self, req: Request) -> float:
        return req.arrival

    def adapter(self, req: Request) -> int:
        return req.adapter

    def context_len(self, req: Request) -> int:
        return req.context_len

    def resident(self, adapter: int) -> bool:
        return self._adapters.is_loaded(adapter)


class Scheduler:
    def __init__(self, kv: PagedKVCache, adapters: AdapterSlotCache,
                 max_running: int = 256,
                 policy: Union[str, SchedulingPolicy] = "fcfs",
                 prefix: Optional[SharedPrefixCache] = None):
        self.kv = kv
        self.adapters = adapters
        self.prefix = prefix
        self.max_running = max_running
        self.policy = make_sched_policy(policy)
        self._view = _RequestView(adapters)
        self._custom_victim = overrides_victim(self.policy)
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self._pos: dict = {}               # request uid -> index in running

    # ------------------------------------------------------------------ #
    def add(self, reqs: List[Request]) -> None:
        self.waiting.extend(reqs)

    def _append_running(self, req: Request) -> None:
        self._pos[req.uid] = len(self.running)
        self.running.append(req)

    def _remove_running(self, req: Request) -> None:
        """O(1) swap-remove via the uid->index map.  ``list.remove`` on a
        dataclass list is an O(n) field-by-field equality scan — this is
        the engine step's (and the Digital Twin's) hottest removal."""
        i = self._pos.pop(req.uid)
        last = self.running.pop()
        if i < len(self.running):
            self.running[i] = last
            self._pos[last.uid] = i

    def clear(self) -> None:
        """Drop every queued/running request (fault-tolerance drain)."""
        self.running.clear()
        self._pos.clear()
        self.waiting.clear()
        self.policy.reset()

    def finish(self, req: Request) -> None:
        self._remove_running(req)
        self.kv.free(req.uid)
        self.adapters.unpin(req.adapter)
        if self.prefix is not None:
            self.prefix.release(req.uid)

    def _preempt_one(self) -> Optional[Request]:
        """Evict one running request (recompute).  Default rule — the
        most recently arrived — unless the policy overrides ``victim``."""
        if not self.running:
            return None
        if self._custom_victim:
            victim = self.policy.victim(self.running, self._view)
            if victim is None:
                return None
        else:
            victim = max(self.running, key=lambda r: r.arrival)
        self._remove_running(victim)
        self.kv.free(victim.uid)
        self.adapters.unpin(victim.adapter)
        if self.prefix is not None:
            self.prefix.release(victim.uid)
        victim.n_preemptions += 1
        self.waiting.appendleft(victim)
        return victim

    # ------------------------------------------------------------------ #
    def schedule(self, now: float) -> StepPlan:
        admitted: List[Request] = []
        preempted: List[Request] = []
        cold_loads: List[int] = []

        # 1. greedy decode allocation for already-running requests;
        #    preempt (policy victim, default newest-first) on memory
        #    exhaustion.
        for req in list(self.running):
            while not self.kv.allocate(req.uid, 1):
                # S-LoRA: idle adapter weights are evicted from the unified
                # pool before any request is preempted
                if self.adapters.dynamic and \
                        self.adapters.evict_idle_lru() is not None:
                    continue
                # idle (zero-ref) shared prefixes go next — still cheaper
                # than recomputing a live request
                if self.prefix is not None and self.prefix.evict_idle_lru():
                    continue
                victim = self._preempt_one()
                if victim is None:
                    break
                preempted.append(victim)
                if victim is req:
                    break  # req preempted itself; it no longer decodes

        # 2. admissions, in the policy's order.  The mechanical rules are
        #    policy-independent: a request whose adapter cannot get a slot
        #    is skipped (vLLM's loaded-adapter priority — later requests
        #    with loaded adapters pass it), KV exhaustion stops the scan
        #    (head-of-line blocking), and requests preempted in THIS step
        #    stay queued until the next step (no same-step thrash).
        #    Skipped requests keep their place: the waiting queue itself
        #    is never reordered, only the per-step attempt order is.
        just_preempted = {r.uid for r in preempted}
        admitted_uids: Set[int] = set()
        covered_total = 0
        # no admission is possible when the batch is full — skip the
        # policy's ordering work entirely (mirrors the fast path's guard)
        candidates = self.waiting if self.waiting and \
            len(self.running) < self.max_running else ()
        if candidates and self.policy.name != "fcfs":
            candidates = self.policy.order(candidates, self._view, now)
        for req in candidates:
            if len(self.running) >= self.max_running:
                break
            if req.uid in just_preempted:
                continue
            # dynamic (S-LoRA) mode may evict idle adapter weights from the
            # unified pool to make room; every eviction re-runs the full
            # eligibility check (the evicted adapter can be this request's)
            pfx = self.prefix is not None and req.prefix_id is not None \
                and min(req.prefix_len, req.prompt_len) > 0
            covered = want_insert = 0
            if pfx:
                covered, want_insert = self.prefix.plan(
                    req.prefix_id, req.prefix_len, req.prompt_len)
            verdict = "admit"
            while True:
                need_slots = not self.adapters.is_loaded(req.adapter)
                if need_slots and not self.adapters.can_load(req.adapter):
                    verdict = "skip"
                    break
                if covered or want_insert:
                    fits = self.prefix.fit_blocks(
                        covered, want_insert,
                        req.context_len) <= self.kv.free_blocks
                else:
                    fits = self.kv.can_allocate(req.context_len + 1,
                                                uid=req.uid)
                if not fits:
                    if self.adapters.dynamic and \
                            self.adapters.evict_idle_lru() is not None:
                        continue
                    if self.prefix is not None and self.prefix.evict_idle_lru(
                            exclude=req.prefix_id):
                        continue
                    if want_insert:
                        # pool too tight to cache the prefix even after
                        # evicting idle entries: serve uncached (a counted
                        # miss, no insert)
                        want_insert = 0
                        continue
                    verdict = "stop"
                break
            if verdict == "skip":
                continue
            if verdict == "stop":
                break
            if self.adapters.load(req.adapter, now):
                cold_loads.append(req.adapter)
            self.adapters.pin(req.adapter)
            if pfx:
                self.prefix.commit(req.uid, req.prefix_id, covered,
                                   want_insert)
            self.kv.allocate(req.uid,
                             req.context_len + 1 - covered - want_insert)
            covered_total += covered
            req.admitted_at = now
            self._append_running(req)
            admitted.append(req)
            admitted_uids.add(req.uid)
            self.policy.on_admit(req, self._view, now)
        if admitted_uids:
            # remaining requests keep FCFS (arrival) queue order
            self.waiting = deque(r for r in self.waiting
                                 if r.uid not in admitted_uids)

        for req in self.running:
            self.adapters.touch(req.adapter, now)
        return StepPlan(admitted=admitted, preempted=preempted,
                        cold_loads=cold_loads, running=list(self.running),
                        prefill_covered=covered_total)

    # ------------------------------------------------------------------ #
    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    @property
    def n_running(self) -> int:
        return len(self.running)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

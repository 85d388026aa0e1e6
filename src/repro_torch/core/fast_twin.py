"""FastTwin: the Digital Twin's struct-of-arrays fast path (paper §VI).

The legacy ``DigitalTwin`` replays every simulated step through
per-request Python objects — ``Request`` dataclasses, attribute access,
``token_times`` list appends, per-step list copies.  Training-data
generation (the placement-model sweeps of §VII) is bounded by how cheap
one twin evaluation is, so this module re-implements the same
continuous-batching semantics over preallocated numpy arrays:

  * the request stream lives in struct-of-arrays columns (arrival,
    prompt/output lengths, adapter, generated, admitted/first-token/
    finished timestamps, KV tokens/blocks held);
  * the per-step decode allocation advances the whole running batch with
    vectorized ops when memory suffices, falling back to the engine's
    exact sequential preempt-by-recompute loop only under pressure;
  * Eq. (1) step times are memoized per (R_run, R_wait, prefill,
    A_unique) key — each distinct key is computed once through the very
    same ``FittedEstimators`` methods the legacy twin calls, so cached
    values are bitwise identical to the object-mode twin's;
  * the starvation-regime admission scan short-circuits when no waiting
    request's adapter is resident and no slot can be freed (the legacy
    engine walks the whole waiting queue every step in that state).

Equivalence contract (enforced by ``tests/test_fast_twin.py``): with the
deterministic estimator executor (the twin never has noise), ``FastTwin``
reproduces ``DigitalTwin`` *exactly* — same scheduling decisions, same
virtual clock, same throughput/TTFT/finish/preemption/load counts.  The
one documented tolerance is mean ITL: the legacy twin averages per-token
gaps (``sum(spans)/len``) while the fast path uses the algebraically
equal telescoped form ``(last - first)/(n - 1)``, which differs by float
rounding only (≲1e-9 relative).

``FastEngine`` implements the resumable engine surface
(``submit``/``run_until``/``finalize``/``drain``/``preload_adapter``/
``evict_adapter``) so the ``ClusterDigitalTwin``'s offline and online
fleet simulations run on it replica-for-replica.  S-LoRA dynamic-slot
mode stays on the legacy twin (``FastTwin.simulate`` delegates).

The port's verbatim copy of ``repro.core.fast_twin``, on the port's copies
of the engine, the scheduling policies and the shared-prefix cache
(``tests/test_torch_fast_twin.py`` holds it to the JAX package's
``FastTwin`` and to the port's ``DigitalTwin``).  The cluster twin that
drives ``FastEngine`` replica by replica is not ported yet.  One line
differs from the JAX copy: a step's cold-load latencies are summed by
``sum()``, as the object-mode twin sums them, not by a running ``+=``.
From Python 3.12 ``sum()`` of floats is compensated, so the running sum
can differ from it in the last bit once three or more adapters load in
one step, and the clock, the throughput and the ideal throughput with it.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from ..serving.engine import EngineConfig, StepTrace
from ..serving.metrics import ServingMetrics, ttft_percentiles
from ..serving.policy import (SchedView, make_sched_policy,
                              overrides_on_admit, overrides_victim)
from ..serving.prefix_cache import SharedPrefixCache
from ..serving.request import Request
from .digital_twin import DigitalTwin, DTResult, EstimatorExecutor
from .estimators import FittedEstimators
from .workload import WorkloadSpec, resample_requests

_NAN = float("nan")


class _StepTimes:
    """Memoized Eq. (1) step-time components.

    Every cache miss is computed by the *same* ``FittedEstimators``
    method the legacy ``EstimatorExecutor`` calls, so memoized values are
    bitwise identical — the fast twin's clock advances through exactly
    the float additions the legacy twin performs.
    """

    __slots__ = ("est", "slots", "n", "ranks", "_sched", "_base", "_mult",
                 "_load")

    def __init__(self, est: FittedEstimators, slots: int, n_adapters: int,
                 ranks: Dict[int, int]):
        self.est = est
        self.slots = slots
        self.n = n_adapters
        self.ranks = ranks
        self._sched: Dict[tuple, float] = {}
        self._base: Dict[tuple, float] = {}
        self._mult: Dict[int, float] = {}
        self._load: Dict[int, float] = {}

    def sched(self, r_run: int, n_wait: int) -> float:
        key = (r_run, n_wait)
        v = self._sched.get(key)
        if v is None:
            v = self._sched[key] = self.est.lat_sched(
                r_run, n_wait, self.slots, self.n)
        return v

    def model(self, r_run: int, prefill: int, a_run: int) -> float:
        key = (r_run, prefill)
        b = self._base.get(key)
        if b is None:
            b = self._base[key] = self.est.lat_model(r_run, prefill)
        m = self._mult.get(a_run)
        if m is None:
            m = self._mult[a_run] = self.est.lat_adapters(a_run)
        return b * m

    def load(self, uid: int) -> float:
        v = self._load.get(uid)
        if v is None:
            v = self._load[uid] = self.est.lat_load(self.ranks.get(uid, 8))
        return v


class _FastAdapterCache:
    """Mirror of ``AdapterSlotCache`` (fixed-slot mode) on plain dicts.

    Same LRU/pinning semantics and tie-breaks (dict insertion order);
    ``can_load`` is O(1) because pinned adapters are always loaded, so an
    idle resident adapter exists iff ``len(pinned) < len(loaded)``.
    """

    __slots__ = ("slots", "loaded", "pinned", "load_count", "evict_count",
                 "failing")

    def __init__(self, slots: int):
        self.slots = slots
        self.loaded: Dict[int, float] = {}     # adapter uid -> last-use time
        self.pinned: Dict[int, int] = {}       # adapter uid -> #running reqs
        self.load_count = 0
        self.evict_count = 0
        self.failing: set = set()              # uids whose loads fault-fail

    def is_loaded(self, uid: int) -> bool:
        return uid in self.loaded

    def can_load(self, uid: int) -> bool:
        if uid in self.loaded:
            return True
        if uid in self.failing:
            return False
        return (len(self.loaded) < self.slots
                or len(self.pinned) < len(self.loaded))

    def evict_idle_lru(self) -> Optional[int]:
        lru, best = None, None
        for a, ts in self.loaded.items():
            if a not in self.pinned and (best is None or ts < best):
                lru, best = a, ts
        if lru is None:
            return None
        del self.loaded[lru]
        self.evict_count += 1
        return lru

    def load(self, uid: int, now: float) -> bool:
        if uid in self.loaded:
            self.loaded[uid] = now
            return False
        if len(self.loaded) >= self.slots:
            if self.evict_idle_lru() is None:
                raise RuntimeError("no evictable adapter slot")
        self.loaded[uid] = now
        self.load_count += 1
        return True

    def evict(self, uid: int) -> bool:
        if uid not in self.loaded or self.pinned.get(uid, 0) > 0:
            return False
        del self.loaded[uid]
        self.evict_count += 1
        return True

    def pin(self, uid: int) -> None:
        self.pinned[uid] = self.pinned.get(uid, 0) + 1

    def unpin(self, uid: int) -> None:
        n = self.pinned.get(uid, 0) - 1
        if n <= 0:
            self.pinned.pop(uid, None)
        else:
            self.pinned[uid] = n

    def touch(self, uid: int, now: float) -> None:
        if uid in self.loaded:
            self.loaded[uid] = now


class _FastKVPool:
    """``PagedKVCache``'s block-accounting surface over ``FastEngine``'s
    scalar free-block counter — the very same ``SharedPrefixCache``
    instance class drives both engines, so cache decisions are identical
    by construction."""

    __slots__ = ("_eng",)

    def __init__(self, eng: "FastEngine"):
        self._eng = eng

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self._eng._block_size)

    @property
    def free_blocks(self) -> int:
        return self._eng._free_blocks

    def reserve_blocks(self, n_blocks: int) -> bool:
        if n_blocks > self._eng._free_blocks:
            return False
        self._eng._free_blocks -= n_blocks
        return True

    def release_blocks(self, n_blocks: int) -> None:
        self._eng._free_blocks += n_blocks


class _RowView(SchedView):
    """Policy accessors over struct-of-arrays row ids.

    Returns the very same values the object-mode ``_RequestView`` yields
    for the corresponding ``Request`` (arrivals are float64 both sides),
    so a policy's ordering decisions are bit-identical across engines.
    """

    __slots__ = ("_eng",)

    def __init__(self, eng: "FastEngine"):
        self._eng = eng

    def arrival(self, i: int) -> float:
        return float(self._eng._arrival[i])

    def adapter(self, i: int) -> int:
        return self._eng._ads[i]

    def context_len(self, i: int) -> int:
        return self._eng._prompts[i] + int(self._eng._generated[i])

    def resident(self, adapter: int) -> bool:
        return adapter in self._eng._adapters.loaded


class _SchedCounts:
    """Duck-typed stand-in for ``engine.scheduler`` queue-depth reads."""

    __slots__ = ("_eng",)

    def __init__(self, eng: "FastEngine"):
        self._eng = eng

    @property
    def n_waiting(self) -> int:
        return len(self._eng.waiting)

    @property
    def n_running(self) -> int:
        return self._eng._n_run


class FastEngine:
    """Struct-of-arrays replica of ``ServingEngine`` over an
    ``EstimatorExecutor`` (fixed-slot mode).

    Presents the same resumable surface (``submit``/``run_until``/
    ``finalize``/``drain``/``preload_adapter``/``evict_adapter``/``run``)
    and the same counters (``clock``/``busy_time``/``n_exec_steps``/
    ``n_tokens_out``), so the cluster's online epoch loop drives it
    unchanged.  ``track_requests=True`` (the default) keeps references to
    submitted ``Request`` objects and writes progress back whenever a
    request finishes or is drained — required by the online loop's
    completion checks.  ``FastTwin`` disables it for pure offline sweeps.

    Deviations from ``ServingEngine`` (documented, not observable in any
    supported path): ``token_times`` is not populated (first/last token
    timestamps are tracked instead — mean ITL is derived from those), and
    ``reset_stream`` fully reinitializes KV/adapter state rather than
    leaking a prior stream's running set.
    """

    SMALL_BATCH = 12          # below this, scalar loops beat numpy dispatch

    def __init__(self, cfg: EngineConfig, executor,
                 track_requests: bool = True):
        if cfg.dynamic_slots:
            raise NotImplementedError(
                "FastEngine covers fixed-slot mode; use ServingEngine / "
                "DigitalTwin for S-LoRA dynamic-slot simulations")
        if not isinstance(executor, EstimatorExecutor):
            raise TypeError(
                "FastEngine requires an EstimatorExecutor (fitted Eq. (1) "
                f"step times); got {type(executor).__name__}")
        self.cfg = cfg
        self.executor = executor
        self._times = _StepTimes(executor.est, executor.slots,
                                 executor.n_adapters, executor.ranks)
        self._track = track_requests
        self._block_size = cfg.block_size
        self._total_blocks = max(int(cfg.kv_capacity_tokens)
                                 // cfg.block_size, 0)
        self._max_running = cfg.max_running
        self.trace: List[StepTrace] = []
        self._sched_view = _SchedCounts(self)
        self._policy_view = _RowView(self)
        self.reset_stream()

    # ------------------------------------------------------------------ #
    # stream state
    # ------------------------------------------------------------------ #
    def reset_stream(self) -> None:
        # fresh policy per stream; a passed-through instance is reset
        # instead (mirrors ServingEngine.reset_stream -> policy.reset)
        self._policy = make_sched_policy(self.cfg.sched_policy)
        self._policy.reset()
        self._policy_is_fcfs = self._policy.name == "fcfs"
        self._admit_hook = overrides_on_admit(self._policy)
        self._victim_hook = overrides_victim(self._policy)
        self.clock = 0.0
        self.halted = False
        self._iters = 0
        self._max_kv = 0.0
        self.busy_time = 0.0
        self.n_exec_steps = 0
        self.n_tokens_out = 0
        # fault-injection state (mirrors ServingEngine)
        self.slow_factor = 1.0
        self.n_load_faults = 0
        self._row_of: Dict[int, int] = {}      # request uid -> latest row
        # struct-of-arrays request table (rows appended per submit)
        self._n_rows = 0
        cap = 256
        self._arrival = np.empty(cap)
        self._prompt = np.empty(cap, np.int64)
        self._out_len = np.empty(cap, np.int64)
        self._adapter = np.empty(cap, np.int64)
        # plain-list mirrors of the static columns: the admission scan
        # reads them per waiting row, where list indexing beats numpy
        # scalar extraction ~3x
        self._ads: List[int] = []
        self._prompts: List[int] = []
        self._outs: List[int] = []
        # finish-check countdown: min output tokens remaining across the
        # running batch; the per-step done-scan only runs when it can hit 0
        self._rem_min = math.inf
        self._admitted_rows: List[int] = []
        self._adm_min = math.inf
        self._generated = np.empty(cap, np.int64)
        self._admitted_at = np.empty(cap)
        self._first_tok = np.empty(cap)
        self._last_tok = np.empty(cap)
        self._finished = np.empty(cap)
        self._n_pre = np.empty(cap, np.int64)
        self._kv_tokens = np.zeros(cap, np.int64)
        self._kv_blocks = np.zeros(cap, np.int64)
        self._drained = np.zeros(cap, bool)
        self._refs: List[Optional[Request]] = []
        # queues
        self._pend = np.empty(0, np.int64)      # row ids sorted by arrival
        self._pend_arr = np.empty(0)            # their arrival times
        self._pend_list: List[int] = []
        self._next = 0
        self.waiting: Deque[int] = deque()
        self._wait_ads: Dict[int, int] = {}     # adapter -> #waiting rows
        self._run = np.empty(self._max_running, np.int64)
        self._n_run = 0
        self._rpos: Dict[int, int] = {}         # row id -> slot in _run
        self._free_blocks = self._total_blocks
        self._adapters = _FastAdapterCache(self.cfg.adapter_slots)
        # shared-prefix cache over the scalar block pool; holder ids are
        # row indices (the object engine uses request uids — equivalent,
        # both are stable per in-flight request)
        self._pfx_id: List[Optional[int]] = []
        self._pfx_len: List[int] = []
        self.prefix: Optional[SharedPrefixCache] = \
            SharedPrefixCache(_FastKVPool(self)) \
            if self.cfg.prefix_cache else None

    @property
    def scheduler(self) -> _SchedCounts:
        return self._sched_view

    @property
    def adapters(self) -> _FastAdapterCache:
        return self._adapters

    @property
    def queue_depth(self) -> int:
        """Admitted-but-unfinished requests, mirroring
        ``ServingEngine.queue_depth``: waiting + running rows plus
        submitted arrivals the clock has not reached yet."""
        return (len(self.waiting) + self._n_run
                + len(self._pend) - self._next)

    # ------------------------------------------------------------------ #
    def _grow(self, need: int) -> None:
        cap = len(self._arrival)
        new = cap
        while new < need:
            new *= 2
        for name in ("_arrival", "_admitted_at", "_first_tok", "_last_tok",
                     "_finished"):
            a = np.empty(new)
            a[:cap] = getattr(self, name)
            setattr(self, name, a)
        for name in ("_prompt", "_out_len", "_adapter", "_generated",
                     "_n_pre", "_kv_tokens", "_kv_blocks"):
            a = np.zeros(new, np.int64)
            a[:cap] = getattr(self, name)
            setattr(self, name, a)
        d = np.zeros(new, bool)
        d[:cap] = self._drained
        self._drained = d

    def submit(self, requests: List[Request], fresh: bool = False) -> None:
        """Enqueue arrivals.  ``fresh=True`` zeroes progress fields (the
        twin's semantics — the legacy ``DigitalTwin`` deep-copies the
        stream with progress reset); otherwise current request progress
        is carried over, matching ``ServingEngine.submit``."""
        if not requests:
            return
        n0, n1 = self._n_rows, self._n_rows + len(requests)
        if n1 > len(self._arrival):
            self._grow(n1)
        for i, r in enumerate(requests, start=n0):
            self._arrival[i] = r.arrival
            self._prompt[i] = r.prompt_len
            self._out_len[i] = r.output_len
            self._adapter[i] = r.adapter
            self._ads.append(r.adapter)
            self._prompts.append(r.prompt_len)
            self._outs.append(r.output_len)
            self._pfx_id.append(r.prefix_id)
            self._pfx_len.append(r.prefix_len)
            if fresh:
                self._generated[i] = 0
                self._n_pre[i] = 0
                self._admitted_at[i] = _NAN
                self._first_tok[i] = _NAN
                self._finished[i] = _NAN
            else:
                self._generated[i] = r.generated
                self._n_pre[i] = r.n_preemptions
                self._admitted_at[i] = (_NAN if r.admitted_at is None
                                        else r.admitted_at)
                self._first_tok[i] = (_NAN if r.first_token_at is None
                                      else r.first_token_at)
                self._finished[i] = (_NAN if r.finished_at is None
                                     else r.finished_at)
            self._last_tok[i] = _NAN
            self._kv_tokens[i] = 0
            self._kv_blocks[i] = 0
        if self._track:
            self._refs.extend(requests)
            for i, r in enumerate(requests, start=n0):
                self._row_of[r.uid] = i
        self._n_rows = n1
        new = np.arange(n0, n1, dtype=np.int64)
        merged = np.concatenate([self._pend[self._next:], new])
        order = np.argsort(self._arrival[merged], kind="stable")
        self._pend = merged[order]
        self._pend_arr = self._arrival[self._pend]
        self._pend_list = self._pend.tolist()
        self._next = 0

    # ------------------------------------------------------------------ #
    # KV + running-set bookkeeping (mirrors PagedKVCache / Scheduler)
    # ------------------------------------------------------------------ #
    def _kv_alloc(self, i: int, n_tokens: int) -> bool:
        held = int(self._kv_tokens[i])
        bs = self._block_size
        need = -(-(held + n_tokens) // bs) - int(self._kv_blocks[i])
        if need > self._free_blocks:
            return False
        self._free_blocks -= need
        self._kv_blocks[i] += need
        self._kv_tokens[i] = held + n_tokens
        return True

    def _kv_free(self, i: int) -> None:
        self._free_blocks += int(self._kv_blocks[i])
        self._kv_blocks[i] = 0
        self._kv_tokens[i] = 0

    def _append_running(self, i: int) -> None:
        self._rpos[i] = self._n_run
        self._run[self._n_run] = i
        self._n_run += 1

    def _remove_running(self, i: int) -> None:
        s = self._rpos.pop(i)
        self._n_run -= 1
        if s < self._n_run:
            last = int(self._run[self._n_run])
            self._run[s] = last
            self._rpos[last] = s

    def _preempt_one(self) -> Optional[int]:
        n = self._n_run
        if not n:
            return None
        run = self._run[:n]
        if self._victim_hook:
            # policy-chosen victim; running order matches the object
            # scheduler's list, so a custom rule sees identical input
            victim = self._policy.victim([int(x) for x in run],
                                         self._policy_view)
            if victim is None:
                return None
        else:
            victim = int(run[np.argmax(self._arrival[run])])
        self._remove_running(victim)
        self._kv_free(victim)
        self._adapters.unpin(int(self._adapter[victim]))
        if self.prefix is not None:
            self.prefix.release(victim)
        self._n_pre[victim] += 1
        self.waiting.appendleft(victim)
        ad = int(self._adapter[victim])
        self._wait_ads[ad] = self._wait_ads.get(ad, 0) + 1
        return victim

    def _decode_alloc_slow(self, snapshot: List[int]) -> List[int]:
        """Sequential decode allocation under memory pressure — a faithful
        transcription of the scheduler's preempt-by-recompute loop,
        including its semantics for requests preempted mid-scan."""
        preempted: List[int] = []
        for i in snapshot:
            while not self._kv_alloc(i, 1):
                # idle (zero-ref) shared prefixes are reclaimed before any
                # request is preempted (mirrors Scheduler.schedule; the
                # vectorized fast path never reaches here when blocks
                # suffice, in which case the object loop would not evict
                # either)
                if self.prefix is not None and self.prefix.evict_idle_lru():
                    continue
                victim = self._preempt_one()
                if victim is None:
                    break
                preempted.append(victim)
                if victim == i:
                    break
        return preempted

    # ------------------------------------------------------------------ #
    def _schedule(self, now: float):
        """One scheduler pass; returns (r_run, n_wait, prefill, a_run,
        load_lat) for the step-time model."""
        bs = self._block_size
        cache = self._adapters
        kv_tokens = self._kv_tokens
        preempted: List[int] = []
        self._admitted_rows.clear()
        self._adm_min = math.inf

        # 1. decode allocation for the running batch
        n = self._n_run
        if n:
            if n < self.SMALL_BATCH:
                snapshot = [int(self._run[s]) for s in range(n)]
                need = 0
                for i in snapshot:
                    if kv_tokens[i] % bs == 0:
                        need += 1
                if need <= self._free_blocks:
                    kb = self._kv_blocks
                    for i in snapshot:
                        if kv_tokens[i] % bs == 0:
                            kb[i] += 1
                        kv_tokens[i] += 1
                    self._free_blocks -= need
                else:
                    preempted = self._decode_alloc_slow(snapshot)
            else:
                run = self._run[:n]
                mask = kv_tokens[run] % bs == 0
                need = int(np.count_nonzero(mask))
                if need <= self._free_blocks:
                    self._kv_blocks[run] += mask
                    kv_tokens[run] += 1
                    self._free_blocks -= need
                else:
                    preempted = self._decode_alloc_slow(
                        [int(x) for x in run])

        # 2. admissions in the policy's order (FCFS walks the queue as
        # is), with the shared mechanical rules: loaded-adapter priority
        # skip, KV head-of-line break, max_running.  Fast exit for the
        # starvation regime: slots exhausted, every resident adapter
        # pinned, and no waiting request's adapter resident -> no
        # ordering can admit anything, so the whole scan (and the
        # policy's sort) is skipped.
        pf = 0
        loads: Optional[List[float]] = None
        waiting = self.waiting
        loaded = cache.loaded
        pinned = cache.pinned
        if waiting and self._n_run < self._max_running and not (
                len(loaded) >= cache.slots
                and len(pinned) >= len(loaded)
                and self._wait_ads.keys().isdisjoint(loaded)):
            candidates = waiting if self._policy_is_fcfs else \
                self._policy.order(waiting, self._policy_view, now)
            just_pre = set(preempted) if preempted else None
            gen = self._generated
            ads = self._ads
            prompts = self._prompts
            outs = self._outs
            pc = self.prefix
            pfx_ids = self._pfx_id
            pfx_lens = self._pfx_len
            wa = self._wait_ads
            max_running = self._max_running
            adm_rows = self._admitted_rows
            adm_min = math.inf
            admitted: Optional[set] = None
            # "a non-resident adapter can get a slot" only *falls* during
            # a scan (admissions consume free slots and pin idle
            # residents), so the predicate is recomputed per admission,
            # not per skipped row
            can_new = (len(loaded) < cache.slots
                       or len(pinned) < len(loaded))
            failing = cache.failing
            for i in candidates:
                if self._n_run >= max_running:
                    break
                if just_pre is not None and i in just_pre:
                    continue
                a = ads[i]
                if a not in loaded and (not can_new or a in failing):
                    continue
                g = int(gen[i])
                ctx = prompts[i] + g
                # uid-aware need (mirrors PagedKVCache.can_allocate with
                # uid=): rows preempted mid-decode-scan can hold a
                # residual block that must be credited, not re-counted
                held_t = int(kv_tokens[i])
                held_b = int(self._kv_blocks[i])
                if pc is None:
                    if -(-(held_t + ctx + 1) // bs) - held_b \
                            > self._free_blocks:
                        break
                    covered = want_insert = 0
                    pfx_active = False
                else:
                    # prefix-aware KV gate — the retry chain (evict idle
                    # prefix -> serve uncached -> head-of-line stop) is a
                    # faithful transcription of Scheduler.schedule's
                    pid = pfx_ids[i]
                    pfx_active = pid is not None \
                        and 0 < min(pfx_lens[i], prompts[i])
                    covered = want_insert = 0
                    if pfx_active:
                        covered, want_insert = pc.plan(
                            pid, pfx_lens[i], prompts[i])
                    stop = False
                    while True:
                        if covered or want_insert:
                            fits = pc.fit_blocks(covered, want_insert,
                                                 ctx) <= self._free_blocks
                        else:
                            fits = -(-(held_t + ctx + 1) // bs) - held_b \
                                <= self._free_blocks
                        if fits:
                            break
                        if pc.evict_idle_lru(exclude=pid):
                            continue
                        if want_insert:
                            want_insert = 0
                            continue
                        stop = True
                        break
                    if stop:
                        break
                if cache.load(a, now):               # cold load
                    if loads is None:
                        loads = []
                    loads.append(self._times.load(a))
                cache.pin(a)
                if pfx_active:
                    pc.commit(i, pid, covered, want_insert)
                self._kv_alloc(i, ctx + 1 - covered - want_insert)
                # result unused — the
                # engine admits unconditionally once slots+KV checks passed
                self._admitted_at[i] = now
                self._append_running(i)
                adm_rows.append(i)
                rem = outs[i] - g
                if rem < adm_min:
                    adm_min = rem
                if admitted is None:
                    admitted = set()
                admitted.add(i)
                if self._admit_hook:
                    self._policy.on_admit(i, self._policy_view, now)
                c = wa[a] - 1
                if c:
                    wa[a] = c
                else:
                    del wa[a]
                pf += ctx - covered
                can_new = (len(loaded) < cache.slots
                           or len(pinned) < len(loaded))
            self._adm_min = adm_min
            if admitted is not None:
                self.waiting = deque(
                    w for w in waiting if w not in admitted)

        # 3. touch residency of every adapter with running work
        loaded = cache.loaded
        for a in cache.pinned:
            loaded[a] = now
        # summed by sum(), as FittedEstimators.lat_step sums a step's cold
        # loads: from Python 3.12 sum() of floats is compensated, and a
        # running += can differ from it in the last bit
        return (self._n_run, len(self.waiting), pf, len(cache.pinned),
                sum(loads) if loads else 0.0)

    # ------------------------------------------------------------------ #
    def _finish_step(self, t: float) -> None:
        """Per-token bookkeeping for the just-executed step."""
        n = self._n_run
        gen = self._generated
        first = self._first_tok
        # first-token timestamps can only be missing on rows admitted this
        # step (any earlier running step already stamped them)
        for i in self._admitted_rows:
            if first[i] != first[i]:                 # isnan
                first[i] = t
        rem_min = self._rem_min - 1
        if self._adm_min - 1 < rem_min:
            rem_min = self._adm_min - 1
        fin_rows: List[int] = []
        if n < self.SMALL_BATCH:
            last = self._last_tok
            out = self._outs
            for s in range(n):
                i = int(self._run[s])
                gen[i] += 1
                last[i] = t
                if rem_min <= 0 and gen[i] >= out[i]:
                    fin_rows.append(i)
        else:
            run = self._run[:n]
            gen[run] += 1
            self._last_tok[run] = t
            if rem_min <= 0:
                rem = self._out_len[run] - gen[run]
                done = rem <= 0
                fin_rows = [int(x) for x in run[done]]
        if rem_min <= 0:
            # a finish may have happened: remove done rows, refresh the
            # countdown from the survivors
            pc = self.prefix
            for i in fin_rows:
                self._finished[i] = t
                self._remove_running(i)
                self._kv_free(i)
                self._adapters.unpin(self._ads[i])
                if pc is not None:
                    pc.release(i)
            if fin_rows and self._track:
                self._sync_rows(fin_rows)
            m = self._n_run
            if m:
                run = self._run[:m]
                rem_min = int((self._out_len[run] - gen[run]).min())
            else:
                rem_min = math.inf
        self._rem_min = rem_min

    def _sync_rows(self, rows) -> None:
        """Write progress back to the tracked ``Request`` objects."""
        for i in rows:
            r = self._refs[i]
            r.generated = int(self._generated[i])
            v = float(self._admitted_at[i])
            r.admitted_at = None if v != v else v
            v = float(self._first_tok[i])
            r.first_token_at = None if v != v else v
            v = float(self._finished[i])
            r.finished_at = None if v != v else v
            r.n_preemptions = int(self._n_pre[i])

    # ------------------------------------------------------------------ #
    def run_until(self, t_end: Optional[float] = None,
                  record_trace: bool = False, strict: bool = False) -> None:
        """Advance the continuous-batching loop (see
        ``ServingEngine.run_until`` — identical control flow)."""
        if self.halted:
            return
        max_steps = self.cfg.max_steps
        pend_arr = self._pend_arr
        n_pend = len(pend_arr)
        total_blocks = self._total_blocks
        while self._iters < max_steps:
            self._iters += 1
            t = self.clock
            if t_end is not None and t >= t_end:
                return
            # idle fast-forward
            if not (self.waiting or self._n_run):
                if self._next >= n_pend:
                    return
                nxt = float(pend_arr[self._next])
                if strict and t_end is not None and nxt >= t_end:
                    self.clock = max(self.clock, min(nxt, t_end))
                    return
                t = max(t, nxt)
            # pull arrivals with arrival <= t
            if self._next < n_pend and pend_arr[self._next] <= t:
                hi = int(pend_arr.searchsorted(t, side="right"))
                wa = self._wait_ads
                ads = self._ads
                append = self.waiting.append
                for i in self._pend_list[self._next:hi]:
                    append(i)
                    a = ads[i]
                    wa[a] = wa.get(a, 0) + 1
                self._next = hi
            r_run, n_wait, pf, a_run, load_lat = self._schedule(t)
            if not r_run:
                # blocked (waiting requests that cannot be admitted yet)
                if self._next < n_pend:
                    nxt = float(pend_arr[self._next])
                    if strict and t_end is not None and nxt >= t_end:
                        self.clock = max(self.clock, min(nxt, t_end))
                        return
                    self.clock = max(t, nxt)
                    continue
                self.clock = t
                return
            total = (self._times.sched(r_run, n_wait) + load_lat) \
                + self._times.model(r_run, pf, a_run)
            # same guarded multiply as ServingEngine.run_until: both
            # engines scale the identical float by the identical factor
            if self.slow_factor != 1.0:
                total *= self.slow_factor
            t += total
            self.busy_time += total
            self.n_exec_steps += 1
            self.n_tokens_out += r_run
            kv_used = (1.0 - self._free_blocks / total_blocks) \
                if total_blocks else 1.0
            if kv_used > self._max_kv:
                self._max_kv = kv_used
            if record_trace:
                self.trace.append(StepTrace(
                    t, r_run, n_wait, kv_used, total))
            self._finish_step(t)
            self.clock = t

    # ------------------------------------------------------------------ #
    def finalize(self) -> ServingMetrics:
        duration = max(self.clock, 1e-9)
        n = self._n_rows
        acc = ~self._drained[:n]
        arr = self._arrival[:n]
        gen = self._generated[:n]
        out = self._out_len[:n]
        fin = self._finished[:n]
        first = self._first_tok[:n]
        arrived = acc & (arr <= duration)
        offered = int(out[arrived].sum())
        out_tokens = int(gen[acc].sum())
        fin_mask = acc & ~np.isnan(fin)
        itl_mask = fin_mask & (gen >= 2)
        itls = ((self._last_tok[:n][itl_mask] - first[itl_mask])
                / (gen[itl_mask] - 1))
        ttft_mask = acc & ~np.isnan(first)
        ttfts = first[ttft_mask] - arr[ttft_mask]
        pct = ttft_percentiles(ttfts)
        starved_rows = np.flatnonzero(arrived & np.isnan(first))
        starved_per_adapter: Dict[int, int] = {}
        for i in starved_rows:
            a = self._ads[i]
            starved_per_adapter[a] = starved_per_adapter.get(a, 0) + 1
        # reliability counters live on the tracked Request objects (the
        # cluster loop mutates them); sum over accounted rows exactly as
        # the object engine's summarize() does over _accepted
        n_timeouts = n_retries = n_failed = 0
        if self._track:
            for i in range(n):
                if self._drained[i]:
                    continue
                r = self._refs[i]
                n_timeouts += r.n_timeouts
                n_retries += r.n_retries
                if r.failed_at is not None:
                    n_failed += 1
        return ServingMetrics(
            throughput=out_tokens / duration,
            itl=float(np.mean(itls)) if len(itls) else 0.0,
            ttft=float(np.mean(ttfts)) if len(ttfts) else 0.0,
            ideal_throughput=offered / duration,
            duration=duration,
            n_finished=int(np.count_nonzero(fin_mask)),
            n_preemptions=int(self._n_pre[:n][acc].sum()),
            max_kv_used=self._max_kv,
            n_loads=self._adapters.load_count,
            ttft_p50=pct["p50"],
            ttft_p99=pct["p99"],
            n_starved_requests=int(len(starved_rows)),
            starved_per_adapter=starved_per_adapter,
            n_timeouts=n_timeouts,
            n_retries=n_retries,
            n_failed_requests=n_failed,
            n_load_faults=self.n_load_faults,
            n_prefix_hits=self.prefix.n_hits if self.prefix else 0,
            n_prefix_misses=self.prefix.n_misses if self.prefix else 0,
            n_prefix_evictions=self.prefix.n_evictions if self.prefix else 0,
            prefix_tokens_saved=self.prefix.tokens_saved
            if self.prefix else 0,
            ttft_samples=[float(t) for t in ttfts],
        )

    # ------------------------------------------------------------------ #
    # fault-tolerance / rebalancing hooks (mirror ServingEngine)
    # ------------------------------------------------------------------ #
    def drain(self) -> List[Request]:
        if not self._track:
            raise RuntimeError(
                "drain() needs track_requests=True (the online loop's "
                "re-routing works on Request objects)")
        orphan_rows = ([int(self._run[s]) for s in range(self._n_run)]
                       + list(self.waiting)
                       + [int(x) for x in self._pend[self._next:]])
        for s in range(self._n_run):
            i = int(self._run[s])
            self._kv_free(i)
            self._adapters.unpin(int(self._adapter[i]))
            if self.prefix is not None:
                self.prefix.release(i)
        self._n_run = 0
        self._rpos.clear()
        self._rem_min = math.inf
        self.waiting.clear()
        self._wait_ads.clear()
        self._pend = np.empty(0, np.int64)
        self._pend_arr = np.empty(0)
        self._pend_list = []
        self._next = 0
        self._drained[orphan_rows] = True
        self._sync_rows(orphan_rows)
        self.halted = True
        return [self._refs[i] for i in orphan_rows]

    def preload_adapter(self, uid: int, cost_s: float = 0.0) -> bool:
        if self._adapters.is_loaded(uid):
            self._adapters.touch(uid, self.clock)
            return True
        if uid in self._adapters.failing:
            self.n_load_faults += 1
            return False
        if not self._adapters.can_load(uid):
            return False
        self._adapters.load(uid, self.clock)
        self.clock += cost_s
        return True

    def evict_adapter(self, uid: int) -> bool:
        return self._adapters.evict(uid)

    def stall_until(self, t: float) -> None:
        """Transient executor fault: clock jump, no service (mirrors
        ``ServingEngine.stall_until``)."""
        self.clock = max(self.clock, t)

    def snapshot(self) -> dict:
        return {"clock": self.clock,
                "adapters": sorted(self._adapters.loaded)}

    def restore(self, snap: dict, now: float, load_cost_fn=None
                ) -> List[int]:
        """Crash recovery (mirrors ``ServingEngine.restore``): un-halt,
        clock to ``now``, reload the snapshot's adapter set at Fig. 4
        cost, skipping (and counting) fault-failing uids."""
        self.halted = False
        self.clock = max(now, self.clock)
        self._adapters.loaded.clear()
        self._adapters.pinned.clear()
        if self.prefix is not None:
            self.prefix.wipe()
        reloaded: List[int] = []
        for uid in snap.get("adapters", []):
            if uid in self._adapters.failing:
                self.n_load_faults += 1
                continue
            self._adapters.load(uid, self.clock)
            if load_cost_fn is not None:
                self.clock += load_cost_fn(uid)
            reloaded.append(uid)
        return reloaded

    def cancel(self, uid: int, forget: bool = False) -> Optional[Request]:
        """Pull one request out (mirrors ``ServingEngine.cancel``).
        Needs request tracking — cancellation hands the object back to
        the cluster/gateway reliability layer."""
        if not self._track:
            raise RuntimeError("cancel() needs track_requests=True")
        row = self._row_of.get(uid)
        if row is None or self._drained[row] \
                or self._finished[row] == self._finished[row]:  # finished
            return None
        if row in self._rpos:
            self._remove_running(row)
            self._kv_free(row)
            self._adapters.unpin(self._ads[row])
            if self.prefix is not None:
                self.prefix.release(row)
            m = self._n_run
            if m:
                run = self._run[:m]
                self._rem_min = int(
                    (self._out_len[run] - self._generated[run]).min())
            else:
                self._rem_min = math.inf
        elif row in self.waiting:
            self.waiting = deque(w for w in self.waiting if w != row)
            a = self._ads[row]
            c = self._wait_ads.get(a, 0) - 1
            if c > 0:
                self._wait_ads[a] = c
            else:
                self._wait_ads.pop(a, None)
        else:
            keep = self._pend[self._next:]
            mask = keep != row
            if mask.all():
                return None                     # already cancelled earlier
            keep = keep[mask]
            self._pend = keep
            self._pend_arr = self._arrival[keep]
            self._pend_list = keep.tolist()
            self._next = 0
        if forget:
            self._drained[row] = True
        self._sync_rows([row])
        return self._refs[row]

    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request], horizon: Optional[float] = None,
            record_trace: bool = False,
            fresh: bool = False) -> ServingMetrics:
        self.reset_stream()
        self.submit(requests, fresh=fresh)
        self.run_until(horizon if horizon is not None else math.inf,
                       record_trace=record_trace)
        return self.finalize()


class FastTwin:
    """Drop-in ``DigitalTwin`` on the struct-of-arrays fast engine.

    Same constructor and ``simulate`` signature; S-LoRA dynamic-slot
    simulations delegate to the legacy object-mode twin.
    """

    def __init__(self, est: FittedEstimators, mode: str = "full",
                 max_running: int = 256, sched_policy: str = "fcfs",
                 measured_step_times=None, prefix_cache: bool = False):
        assert mode in ("full", "mean")
        # same opt-in hook as DigitalTwin: attach the measured kernel
        # step-time surface to the fits (dynamic-slot delegation passes
        # self.est on, so the hook follows automatically)
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
        if dynamic_slots:
            return DigitalTwin(self.est, self.mode, self.max_running,
                               sched_policy=self.sched_policy,
                               prefix_cache=self.prefix_cache) \
                .simulate(spec, slots, requests, horizon,
                          dynamic_slots=True)
        t0 = time.perf_counter()
        ranks = {a.uid: a.rank for a in spec.adapters}
        mean_rank = (sum(ranks.values()) / len(ranks)) if ranks else 8.0
        n = len(spec.adapters)
        if self.mode == "mean" or requests is None:
            requests = resample_requests(spec, spec.length_stats())
        cfg = EngineConfig(
            kv_capacity_tokens=self.est.kv_capacity(slots, mean_rank),
            adapter_slots=slots, max_running=self.max_running,
            sched_policy=self.sched_policy,
            prefix_cache=self.prefix_cache)
        engine = FastEngine(cfg, EstimatorExecutor(self.est, slots, n,
                                                   ranks),
                            track_requests=False)
        metrics = engine.run(requests, horizon=horizon or spec.horizon,
                             fresh=True)
        return DTResult(metrics=metrics,
                        sim_wall_time=time.perf_counter() - t0,
                        mode=self.mode)

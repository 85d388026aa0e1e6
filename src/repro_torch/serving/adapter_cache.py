"""Adapter slot cache: fixed GPU slots, LRU eviction (vLLM semantics).

``slots`` is the paper's tunable server hyper-parameter: set below the
number of served adapters it time-shares GPU slots via CPU<->GPU swaps
(with the Fig. 4 loading cost); set too low under high rates it starves
(Fig. 6).  Adapters pinned by running requests cannot be evicted.
"""
from __future__ import annotations

from typing import Dict, Optional


class AdapterSlotCache:
    """vLLM mode: a fixed number of pre-allocated GPU adapter slots.

    S-LoRA mode (``dynamic=True``, paper §V-B): no fixed slot count —
    adapter weights share the unified paged memory pool with KV blocks.
    The engine passes a ``reserve(uid)/release(uid)`` pair that charges
    the adapter's footprint against the KV pool; idle adapters are
    evicted LRU under memory pressure (see Scheduler.free_adapter_memory).
    """

    def __init__(self, slots: int, dynamic: bool = False,
                 reserve=None, release=None):
        self.slots = slots
        self.dynamic = dynamic
        self._reserve = reserve
        self._release = release
        self.loaded: Dict[int, float] = {}     # adapter uid -> last-use time
        self.pinned: Dict[int, int] = {}       # adapter uid -> #running reqs
        self.load_count = 0
        self.evict_count = 0
        self.failing: set = set()              # uids whose loads fault-fail

    def is_loaded(self, uid: int) -> bool:
        return uid in self.loaded

    def can_load(self, uid: int) -> bool:
        # pinned adapters are always loaded (pin follows load; a pinned
        # adapter is unevictable), so "some loaded adapter is unpinned"
        # reduces to an O(1) size comparison — this predicate runs once
        # per waiting request per step, the engine's hottest path.
        if uid in self.loaded:
            return True
        if uid in self.failing:
            return False
        if self.dynamic:
            return self._reserve is None or self._reserve(uid, dry=True) \
                or len(self.pinned) < len(self.loaded)
        if len(self.loaded) < self.slots:
            return True
        return len(self.pinned) < len(self.loaded)

    def evict(self, uid: int) -> bool:
        """Evict a specific adapter (migration source side).  Refuses when
        the adapter is pinned by running requests or not resident."""
        if uid not in self.loaded or self.pinned.get(uid, 0) > 0:
            return False
        del self.loaded[uid]
        self.evict_count += 1
        if self.dynamic and self._release is not None:
            self._release(uid)
        return True

    def evict_idle_lru(self) -> Optional[int]:
        victims = [a for a in self.loaded if self.pinned.get(a, 0) == 0]
        if not victims:
            return None
        lru = min(victims, key=lambda a: self.loaded[a])
        del self.loaded[lru]
        self.evict_count += 1
        if self.dynamic and self._release is not None:
            self._release(lru)
        return lru

    def load(self, uid: int, now: float) -> bool:
        """Returns True if a (cold) load happened."""
        if uid in self.loaded:
            self.loaded[uid] = now
            return False
        if self.dynamic:
            while self._reserve is not None and not self._reserve(uid):
                if self.evict_idle_lru() is None:
                    raise RuntimeError("no memory for adapter weights")
        elif len(self.loaded) >= self.slots:
            if self.evict_idle_lru() is None:
                raise RuntimeError("no evictable adapter slot")
        self.loaded[uid] = now
        self.load_count += 1
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

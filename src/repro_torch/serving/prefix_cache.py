"""Cross-adapter shared-prefix KV cache (per-tenant system prompts).

Every adapter shares the base model, so the KV blocks of a prompt prefix
computed once are valid for *every* request that starts with the same
tokens — regardless of which LoRA adapter decorates the suffix (the
Activated-LoRA observation; S-LoRA's unified paging supplies the memory
pool).  ``SharedPrefixCache`` layers that reuse on the engine's block
pool:

* cache entries are keyed ``(base_model, prefix_id)`` — a ``prefix_id``
  names one shared system prompt (typically per tenant), carried by
  ``Request.prefix_id`` / ``Request.prefix_len``;
* an entry's blocks are **ref-counted**: every admitted request that
  reuses (or just computed) the prefix holds one reference until it
  finishes, is preempted, cancelled or drained — concurrent requests of
  *different adapters* share the same blocks;
* eviction is LRU over **zero-ref entries only**; blocks with live
  references are never reclaimed;
* on a **hit**, admission charges only the un-cached prompt suffix: the
  request allocates ``context_len + 1 - covered`` tokens of KV and the
  Eq. (1) prefill term drops by ``covered`` tokens (``StepPlan.
  prefill_covered``), so both prefill time and memory shrink;
* on a **miss**, the admitting request computes the full prompt; the
  prefix's blocks are inserted into the cache (owned by the cache, one
  reference held by the inserter) so the *next* request of any adapter
  hits.  When the pool is too tight to cache even after evicting idle
  entries, the request is served uncached (a counted miss, no insert).

The same class instance drives both the object-mode ``ServingEngine``
(over ``PagedKVCache``) and the struct-of-arrays ``FastEngine`` (over a
block-pool shim) — identical decisions by construction, which is what
keeps the legacy<->fast equivalence contract bitwise with the cache on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class PrefixEntry:
    """One cached shared prefix: ``tokens`` of KV in ``blocks`` blocks."""
    tokens: int
    blocks: int
    refs: int
    seq: int                   # LRU clock (monotone; bumped on every use)


class SharedPrefixCache:
    """Paged, ref-counted shared-prefix cache over a block pool.

    ``pool`` needs the ``PagedKVCache`` block-accounting surface:
    ``blocks_needed(n_tokens)``, ``free_blocks``, ``reserve_blocks(n)``,
    ``release_blocks(n)``.  The cache never touches per-request tables —
    its blocks live beside them in the same pool, so cache occupancy
    shows up in ``used_fraction`` / ``max_kv_used`` like any other KV.
    """

    def __init__(self, pool, base_model: str = "base"):
        self.pool = pool
        self.base_model = base_model
        self.entries: Dict[Tuple[str, int], PrefixEntry] = {}
        self.holders: Dict[int, Tuple[str, int]] = {}  # holder id -> key
        self.n_hits = 0
        self.n_misses = 0
        self.n_inserts = 0
        self.n_evictions = 0
        self.tokens_saved = 0      # prefill tokens skipped via hits
        self._seq = 0

    # ------------------------------------------------------------------ #
    # admission planning (pure; no side effects)
    # ------------------------------------------------------------------ #
    def plan(self, prefix_id: int, prefix_len: int,
             prompt_len: int) -> Tuple[int, int]:
        """Plan one admission: returns ``(covered, insert_tokens)``.

        ``covered`` — cached prefix tokens this request can reuse (a hit
        when > 0); ``insert_tokens`` — prefix tokens a miss would insert.
        Exactly one of the two is nonzero (both zero for degenerate
        prefixes)."""
        pl = min(prefix_len, prompt_len)
        if pl <= 0:
            return 0, 0
        e = self.entries.get((self.base_model, prefix_id))
        if e is not None:
            return min(e.tokens, pl), 0
        return 0, pl

    def fit_blocks(self, covered: int, insert_tokens: int,
                   context_len: int) -> int:
        """Pool blocks an admission with this plan must find free.

        A miss-with-insert splits prefix and suffix into separate block
        runs (prefix blocks must be shareable), so it can round up one
        block more than the fused allocation would."""
        bn = self.pool.blocks_needed
        if insert_tokens:
            return bn(insert_tokens) + bn(context_len + 1 - insert_tokens)
        return bn(context_len + 1 - covered)

    # ------------------------------------------------------------------ #
    # admission commit / release
    # ------------------------------------------------------------------ #
    def commit(self, holder: int, prefix_id: int, covered: int,
               insert_tokens: int) -> None:
        """Record the admission the scheduler decided on: take a
        reference on a hit, insert-and-hold on a miss, or just count the
        miss when the pool was too tight to cache."""
        key = (self.base_model, prefix_id)
        if covered > 0:
            e = self.entries[key]
            e.refs += 1
            self._seq += 1
            e.seq = self._seq
            self.holders[holder] = key
            self.n_hits += 1
            self.tokens_saved += covered
            return
        self.n_misses += 1
        if insert_tokens > 0:
            blocks = self.pool.blocks_needed(insert_tokens)
            if not self.pool.reserve_blocks(blocks):
                raise RuntimeError(
                    "prefix insert without room: the admission gate must "
                    "check fit_blocks() before commit()")
            self._seq += 1
            self.entries[key] = PrefixEntry(
                tokens=insert_tokens, blocks=blocks, refs=1, seq=self._seq)
            self.holders[holder] = key
            self.n_inserts += 1

    def release(self, holder: int) -> None:
        """Drop ``holder``'s reference (finish / preempt / cancel /
        drain).  The entry stays cached at zero refs — evictable, warm."""
        key = self.holders.pop(holder, None)
        if key is None:
            return
        e = self.entries.get(key)
        if e is not None and e.refs > 0:
            e.refs -= 1

    # ------------------------------------------------------------------ #
    # eviction / teardown
    # ------------------------------------------------------------------ #
    def evict_idle_lru(self, exclude: Optional[int] = None) -> bool:
        """Free the least-recently-used zero-ref entry's blocks back to
        the pool.  ``exclude`` protects one prefix id (the entry an
        in-flight admission plans to reuse).  Returns True if an entry
        was evicted."""
        lru_key, lru_seq = None, None
        for key, e in self.entries.items():
            if e.refs > 0:
                continue
            if exclude is not None and key[1] == exclude:
                continue
            if lru_seq is None or e.seq < lru_seq:
                lru_key, lru_seq = key, e.seq
        if lru_key is None:
            return False
        e = self.entries.pop(lru_key)
        self.pool.release_blocks(e.blocks)
        self.n_evictions += 1
        return True

    def reset(self) -> None:
        """Drop every entry and counter (fresh stream / crash wipe of
        the GPU pool).  Blocks go back to the pool; held references are
        forgotten — callers tear down requests separately."""
        for e in self.entries.values():
            self.pool.release_blocks(e.blocks)
        self.entries.clear()
        self.holders.clear()
        self.n_hits = 0
        self.n_misses = 0
        self.n_inserts = 0
        self.n_evictions = 0
        self.tokens_saved = 0
        self._seq = 0

    def wipe(self) -> None:
        """Crash recovery: the GPU KV pool is gone — forget entries and
        holders, return blocks, but keep the lifetime counters (they are
        metrics, not state)."""
        for e in self.entries.values():
            self.pool.release_blocks(e.blocks)
        self.entries.clear()
        self.holders.clear()

    # ------------------------------------------------------------------ #
    @property
    def cached_blocks(self) -> int:
        return sum(e.blocks for e in self.entries.values())

    @property
    def cached_tokens(self) -> int:
        return sum(e.tokens for e in self.entries.values())

    @property
    def hit_rate(self) -> float:
        total = self.n_hits + self.n_misses
        return self.n_hits / total if total else 0.0

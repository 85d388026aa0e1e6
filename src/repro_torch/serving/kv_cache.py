"""Block-paged KV cache manager with vLLM-style greedy allocation.

Capacity is expressed in *tokens* (block-granular).  The engine sizes it
from real device memory minus weights minus adapter slots; the Digital Twin
sizes it from the fitted ``Mem_max`` estimator.  Allocation is greedy (one
token at a time during decode, the whole prompt at admission), so running
requests can exhaust memory and force preemption — exactly the vLLM
behaviour the paper analyses (Fig. 5's output-length effect).
"""
from __future__ import annotations

from typing import Dict, Optional


class PagedKVCache:
    def __init__(self, capacity_tokens: int, block_size: int = 16):
        self.block_size = block_size
        self.total_blocks = max(int(capacity_tokens) // block_size, 0)
        self.free_blocks = self.total_blocks
        self.table: Dict[int, int] = {}        # request uid -> #blocks held
        self.tokens: Dict[int, int] = {}       # request uid -> #tokens held

    # ------------------------------------------------------------------ #
    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_tokens: int,
                     uid: Optional[int] = None) -> bool:
        """Whether ``n_tokens`` more tokens fit.  With ``uid``, the check
        mirrors ``allocate``'s delta charging: a requester with slack in
        its partially-filled last block needs fewer (possibly zero) new
        blocks, where the uid-blind form over-conservatively prices the
        tokens from an empty table."""
        if uid is None:
            return self.blocks_needed(n_tokens) <= self.free_blocks
        held_t = self.tokens.get(uid, 0)
        need = self.blocks_needed(held_t + n_tokens) - self.table.get(uid, 0)
        return need <= self.free_blocks

    def allocate(self, uid: int, n_tokens: int) -> bool:
        """Reserve blocks for `n_tokens` more tokens of request `uid`."""
        held_t = self.tokens.get(uid, 0)
        need = self.blocks_needed(held_t + n_tokens) - self.table.get(uid, 0)
        if need > self.free_blocks:
            return False
        self.free_blocks -= need
        self.table[uid] = self.table.get(uid, 0) + need
        self.tokens[uid] = held_t + n_tokens
        return True

    def free(self, uid: int) -> None:
        self.free_blocks += self.table.pop(uid, 0)
        self.tokens.pop(uid, None)

    # ------------------------------------------------------------------ #
    # raw block reservations (the shared-prefix cache's pool surface —
    # cache-owned blocks sit beside request tables in the same pool, so
    # they count toward used_fraction like any other KV)
    # ------------------------------------------------------------------ #
    def reserve_blocks(self, n_blocks: int) -> bool:
        if n_blocks > self.free_blocks:
            return False
        self.free_blocks -= n_blocks
        return True

    def release_blocks(self, n_blocks: int) -> None:
        self.free_blocks += n_blocks

    # ------------------------------------------------------------------ #
    @property
    def used_fraction(self) -> float:
        if self.total_blocks == 0:
            return 1.0
        return 1.0 - self.free_blocks / self.total_blocks

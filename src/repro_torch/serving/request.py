"""Request and adapter descriptors shared by the engine and the Digital Twin."""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Adapter:
    uid: int
    rank: int
    rate: float = 0.0                  # req/s (workload descriptor)
    location: str = "cpu"              # cpu | disk

    def bytes(self, d_model: int, n_layers: int, n_targets: int = 2,
              dtype_bytes: int = 2) -> int:
        # A (d, r) + B (r, o~d) per target per layer; ``dtype_bytes``
        # defaults to bf16 (2) — int8 adapter banks pass 1
        return dtype_bytes * 2 * self.rank * d_model * n_targets * n_layers


@dataclasses.dataclass
class Request:
    uid: int
    adapter: int
    arrival: float
    prompt_len: int
    output_len: int

    # shared-prefix identity: the first min(prefix_len, prompt_len)
    # prompt tokens are the shared system prompt named ``prefix_id``
    # (typically the tenant/adapter uid).  None = no shared prefix —
    # bitwise-identical to the pre-prefix-cache engine everywhere.
    prefix_id: Optional[int] = None
    prefix_len: int = 0

    # progress
    generated: int = 0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    n_preemptions: int = 0

    # reliability lifecycle (all None/0 on the healthy path)
    n_retries: int = 0                       # re-submissions performed
    n_timeouts: int = 0                      # deadline expiries observed
    failed_at: Optional[float] = None        # retries exhausted here
    retry_at: Optional[float] = None         # backoff release time
    disconnected_at: Optional[float] = None  # client went away here

    @property
    def done(self) -> bool:
        return self.generated >= self.output_len

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated

    # latency metrics ---------------------------------------------------- #
    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def itl(self) -> Optional[float]:
        if len(self.token_times) < 2:
            return None
        spans = [b - a for a, b in zip(self.token_times, self.token_times[1:])]
        return sum(spans) / len(spans)

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

"""Synthetic token data pipeline (a copy of ``repro.data.pipeline``).

Deterministic, seekable (resume from any step without replaying), and
shard-aware: each (data-parallel) host materializes only its slice of the
global batch.  Documents are Zipf-distributed token streams packed into
fixed-length sequences — enough structure for the training loss to fall.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    n_image_tokens: int = 0      # VLM: prepend patch embeddings
    d_model: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig,
                 shard: Tuple[int, int] = (0, 1)):
        self.cfg = cfg
        self.shard_idx, self.n_shards = shard
        assert cfg.global_batch % self.n_shards == 0
        self.local_batch = cfg.global_batch // self.n_shards

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, step, self.shard_idx))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Seekable batch: same (seed, step, shard) -> same data."""
        cfg = self.cfg
        rng = self._batch_rng(step)
        # zipf-ish unigram stream with local n-gram structure: tokens are
        # a lagged mixture so next-token prediction is learnable.
        shape = (self.local_batch, cfg.seq_len + 1)
        base = rng.zipf(cfg.zipf_a, size=shape) % cfg.vocab_size
        lag = np.roll(base, 1, axis=1)
        copy_mask = rng.random(shape) < 0.5
        tokens = np.where(copy_mask, (lag * 7 + 11) % cfg.vocab_size, base)
        out = {"tokens": tokens.astype(np.int32)}
        if cfg.n_image_tokens:
            out["img_embeds"] = rng.normal(
                0, 1, (self.local_batch, cfg.n_image_tokens, cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

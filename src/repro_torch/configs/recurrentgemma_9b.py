"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (unverified).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 — RG-LRU + local
attention in a 2:1 (rglru, rglru, local) repeating pattern, window 2048.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048, lru_width=4096, conv_width=4,
    mlp="gelu", norm="rmsnorm", pos_emb="rope", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=5, d_model=64,
        n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=512, head_dim=16,
        local_window=16, lru_width=64)

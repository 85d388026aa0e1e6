"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt (unverified).

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 — 5:1 local:global.
Sliding window 512, tied embeddings, head_dim=256 (attn_dim != d_model).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    local_window=512, rope_theta=1_000_000.0,
    mlp="swiglu", norm="rmsnorm", pos_emb="rope", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-smoke", n_layers=8, d_model=48, n_heads=2,
        n_kv_heads=1, d_ff=96, vocab_size=512, head_dim=16, local_window=16)

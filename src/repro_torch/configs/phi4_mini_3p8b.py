"""phi4-mini-3.8b [dense] — arXiv:2412.08905 (hf).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064, head_dim=128,
    block_pattern=("global",), mlp="swiglu", norm="rmsnorm", pos_emb="rope",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi4-mini-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16)

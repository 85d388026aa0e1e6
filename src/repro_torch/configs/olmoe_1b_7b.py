"""olmoe-1b-7b [moe] — arXiv:2409.02060 (hf).

16L d_model=2048 16H (MHA kv=16) per-expert d_ff=1024 vocab=50304,
MoE 64 experts top-8.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, top_k=8,
    block_pattern=("global",), mlp="swiglu", norm="rmsnorm", pos_emb="rope",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab_size=512, head_dim=16,
        n_experts=8, top_k=2)

"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (hf).

48L d_model=2048 16H (MHA kv=16) per-expert d_ff=1408 vocab=163840,
MoE 64 experts top-6.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    n_experts=64, top_k=6,
    block_pattern=("global",), mlp="swiglu", norm="rmsnorm", pos_emb="rope",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab_size=512, head_dim=16,
        n_experts=8, top_k=2)

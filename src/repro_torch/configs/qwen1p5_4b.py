"""qwen1.5-4b [dense] — hf:Qwen/Qwen1.5 family (hf).

40L d_model=2560 20H (GQA kv=20, i.e. MHA) d_ff=6912 vocab=151936 — QKV bias.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936, head_dim=128, qkv_bias=True,
    block_pattern=("global",), mlp="swiglu", norm="rmsnorm", pos_emb="rope",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512, head_dim=16)

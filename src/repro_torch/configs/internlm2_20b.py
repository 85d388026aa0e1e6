"""internlm2-20b [dense] — arXiv:2403.17297 (hf).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544 — GQA.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128,
    block_pattern=("global",), mlp="swiglu", norm="rmsnorm", pos_emb="rope",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internlm2-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=192, vocab_size=512, head_dim=8)

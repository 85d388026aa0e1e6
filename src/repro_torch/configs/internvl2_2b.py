"""internvl2-2b [vlm] — arXiv:2404.16821 (hf).

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 — InternViT +
InternLM2 backbone.  The InternViT frontend is a STUB: ``input_specs()``
supplies 256 precomputed patch embeddings (B, 256, d_model) that are
prepended to the token embeddings.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    n_image_tokens=256,
    block_pattern=("global",), mlp="swiglu", norm="rmsnorm", pos_emb="rope",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        n_image_tokens=8)

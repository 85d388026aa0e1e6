"""musicgen-medium [audio] — arXiv:2306.05284 (hf).

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 — decoder-only over
EnCodec tokens.  The EnCodec frontend is a STUB: ``input_specs()`` supplies
token ids in the 2048-entry codebook vocabulary directly (the transformer
backbone is what is specified).  LayerNorm + GELU + sinusoidal positions,
matching the MusicGen decoder.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    block_pattern=("global",), mlp="gelu", norm="layernorm",
    pos_emb="sinusoidal",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16)

"""mamba2-2.7b [ssm] — arXiv:2405.21060 (unverified).

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128 — SSD
(state-space duality), expand=2 (d_inner=5120), head_dim=64 (80 heads).
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    block_pattern=("ssd",), norm="rmsnorm", pos_emb="none",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    conv_width=4,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=64,
        vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)

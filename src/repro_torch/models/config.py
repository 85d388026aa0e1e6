"""Model configuration: the port's copy of ``repro.models.config``.

The same frozen dataclass and properties; ``torch_dtype`` replaces
``jnp_dtype``.  ``ShapeConfig``, the four dry-run shapes and
``applicable_shapes`` are the JAX module's too (config.py:146-168).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

MixerKind = str  # 'global' | 'local' | 'rglru' | 'ssd'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                        # dense FFN width (per-expert width for MoE)
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    block_pattern: Tuple[MixerKind, ...] = ("global",)
    local_window: int = 4096
    qkv_bias: bool = False
    mlp: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    pos_emb: str = "rope"            # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: int = 0               # 0 -> d_model

    # VLM stub frontend
    n_image_tokens: int = 0          # prepended precomputed patch embeddings

    # LoRA serving
    lora_targets: Tuple[str, ...] = ("q", "v")
    max_lora_rank: int = 64

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def layer_kinds(self) -> Tuple[MixerKind, ...]:
        """Mixer kind for each of the n_layers blocks (pattern repeats)."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("rglru", "ssd") for k in self.layer_kinds)

    @property
    def has_full_attention(self) -> bool:
        return any(k == "global" for k in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True if per-token decode cost does not grow ~linearly in context
        with a dense per-layer KV cache (SSM/recurrent/local-dominated)."""
        kinds = self.layer_kinds
        n_global = sum(k == "global" for k in kinds)
        return n_global <= max(1, len(kinds) // 5)

    # Parameter count (embedding included once) -- used for roofline 6ND.
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # unembed
        for kind in self.layer_kinds:
            total += 2 * d  # norms
            if kind in ("global", "local"):
                total += d * n_q * h + 2 * d * n_kv * h + n_q * h * d
                if self.qkv_bias:
                    total += (n_q + 2 * n_kv) * h
            elif kind == "ssd":
                di = self.d_inner
                nh = self.ssm_n_heads
                total += d * (2 * di + 2 * self.ssm_state + nh)  # in_proj
                total += di * d                                   # out_proj
                total += self.conv_width * (di + 2 * self.ssm_state)
                total += 2 * nh                                   # A, D
            elif kind == "rglru":
                w = self.lru_width or d
                total += d * w * 2 + w * d      # in (x,gate) + out proj
                total += self.conv_width * w    # temporal conv
                total += 2 * w                  # lru gates (a, input gate)
            if self.n_experts:
                total += d * self.n_experts  # router
                e = self.top_k if active_only else self.n_experts
                total += e * 3 * d * self.d_ff
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                total += mult * d * self.d_ff
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ModelConfig):
    """The assignment: long_500k only for sub-quadratic archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out

"""Architecture registry of the port.

The port serves the dense, MoE and hybrid (RG-LRU) architectures of
``repro.configs``.
Every entry exposes:
  * ``CONFIG``    — the exact published configuration,
  * ``reduced()`` — a structurally identical, CPU-sized variant for tests.
The other architectures of ``repro.configs`` raise and name the ROADMAP item
that brings them.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = (
    "phi4_mini_3p8b",
    "internlm2_20b",
    "gemma3_1b",
    "qwen1p5_4b",
    "musicgen_medium",
    "internvl2_2b",
    "olmoe_1b_7b",
    "moonshot_v1_16b_a3b",
    "recurrentgemma_9b",
)

ALIASES = {
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "internlm2-20b": "internlm2_20b",
    "gemma3-1b": "gemma3_1b",
    "qwen1.5-4b": "qwen1p5_4b",
    "musicgen-medium": "musicgen_medium",
    "internvl2-2b": "internvl2_2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

#: architectures of the JAX package not ported yet -> the ROADMAP item
NOT_PORTED = {
    "mamba2_2p7b": "queue 1 item 8 (SSM mixers)",
}


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))


def _module(arch: str):
    name = canonical(arch)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to PyTorch yet: ROADMAP.md {NOT_PORTED[name]}")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()

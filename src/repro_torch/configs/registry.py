"""Architecture registry of the port.

The port serves every architecture of ``repro.configs``: the dense, MoE,
hybrid (RG-LRU) and SSM (Mamba2) ones.
Every entry exposes:
  * ``CONFIG``    — the exact published configuration,
  * ``reduced()`` — a structurally identical, CPU-sized variant for tests.
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
    "mamba2_2p7b",
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
    "mamba2-2.7b": "mamba2_2p7b",
}


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()

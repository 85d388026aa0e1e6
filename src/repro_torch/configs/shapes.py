"""Input stand-ins for every (arch x shape) dry-run cell (counterpart of
``repro.configs.shapes``).

Nothing here allocates: each stand-in is a tensor on the ``meta`` device
with the shape and dtype of the JAX package's ``ShapeDtypeStruct``
(tokens and adapter ids int32, a VLM's image embeddings in the model's
dtype).  LoRA serving parameters for the decode and prefill cells follow
the paper's setting (adapter slots resident on device, rank-16 adapters
on q/v).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig, ShapeConfig

# paper-facing LoRA serving defaults for the dry-run decode/prefill cells
DRYRUN_ADAPTER_SLOTS = 32
DRYRUN_LORA_RANK = 16


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape: ShapeConfig
                 ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s + 1), torch.int32)}
    if cfg.family == "vlm":
        batch["tokens"] = _sds((b, s - cfg.n_image_tokens + 1), torch.int32)
        batch["img_embeds"] = _sds((b, cfg.n_image_tokens, cfg.d_model),
                                   cfg.torch_dtype)
    return batch


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((b, s), torch.int32),
           "adapter_idx": _sds((b,), torch.int32)}
    if cfg.family == "vlm":
        out["tokens"] = _sds((b, s - cfg.n_image_tokens), torch.int32)
        out["img_embeds"] = _sds((b, cfg.n_image_tokens, cfg.d_model),
                                 cfg.torch_dtype)
    return out


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig
                  ) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    return {"tokens": _sds((b, 1), torch.int32),
            "adapter_idx": _sds((b,), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    if shape.kind == "train":
        return train_inputs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape)
    return decode_inputs(cfg, shape)

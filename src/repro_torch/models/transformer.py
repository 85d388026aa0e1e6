"""Decoder stack of the port (counterpart of ``repro.models.transformer``).

``Model`` is an ``nn.Module`` holding one ``Block`` per layer; the JAX
package stacks each segment's layers on axis 0 and scans them, the port
loops over its layers (``bridge.py`` maps one layout to the other).  So far
the port builds ``global`` attention blocks with a dense SwiGLU MLP, RoPE
and RMSNorm (phi4-mini); other block kinds raise and name their ROADMAP.md
item.

Two entry points, as in the JAX package:
  * ``prefill``     — runs the prompt, emits last-position logits + cache;
  * ``decode_step`` — one token per running request with per-request LoRA
                      adapters (the serving hot path).

The port keeps these JAX behaviours for parity: one scalar ``pos`` for the
whole batch (a 0-d int32 tensor on the model's device, as the JAX
package's traced ``cache["pos"]``); a ``pos`` past the cache skips the
write; LoRA on q and v only; the vocab padded to a multiple of 256 with
the padded logits kept.  Unlike the JAX package, ``decode_step`` updates
the cache in place: its KV tensors and its ``pos``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn

from ..device import resolve_device
from ..kernels import ops
from . import attention, layers
from .config import ModelConfig

#: block kinds and features of ModelConfig not ported yet -> ROADMAP item
_NOT_PORTED = {
    "local": "queue 1 item 6 (local attention, rolling cache)",
    "moe": "queue 1 item 7 (MoE)",
    "ssd": "queue 1 item 8 (SSM mixers)",
    "rglru": "queue 1 item 8 (RG-LRU mixers)",
    "variant": "queue 1 item 6 (other dense variants)",
}


def _check_ported(cfg: ModelConfig) -> None:
    for kind in cfg.layer_kinds:
        if kind != "global":
            raise NotImplementedError(
                f"{kind!r} blocks: ROADMAP.md {_NOT_PORTED.get(kind, kind)}")
    if cfg.n_experts:
        raise NotImplementedError(f"MoE blocks: ROADMAP.md {_NOT_PORTED['moe']}")
    if (cfg.qkv_bias or cfg.tie_embeddings or cfg.n_image_tokens
            or cfg.pos_emb != "rope" or cfg.norm != "rmsnorm"
            or cfg.mlp != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: ROADMAP.md {_NOT_PORTED['variant']}")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One ``global`` attention layer with a dense SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.torch_dtype
        hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads

        def dense(shape, fan_in=None):
            return _param(layers.dense_init(gen, shape, dt, device, fan_in))

        def ones():
            return _param(torch.ones(d, dtype=dt, device=device))

        self.norm1 = nn.ParameterDict({"scale": ones()})
        self.wq = dense((d, nq * hd))
        self.wk = dense((d, nkv * hd))
        self.wv = dense((d, nkv * hd))
        self.wo = dense((nq * hd, d), fan_in=nq * hd)
        self.norm2 = nn.ParameterDict({"scale": ones()})
        self.mlp = nn.ParameterDict({
            "w_gate": dense((d, cfg.d_ff)),
            "w_up": dense((d, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, d), fan_in=cfg.d_ff)})

    def _attn_proj(self, lora_p, h, name, adapter_idx):
        out = h @ {"q": self.wq, "k": self.wk, "v": self.wv}[name]
        if lora_p is not None and f"a_{name}" in lora_p and \
                adapter_idx is not None:
            delta = ops.lora_apply(h, lora_p[f"a_{name}"],
                                   lora_p[f"b_{name}"], adapter_idx)
            out = out + delta.to(out.dtype)
        return out

    def _qkv(self, x, lora_p, adapter_idx, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        h = layers.apply_norm(cfg.norm, self.norm1["scale"], x)
        q = self._attn_proj(lora_p, h, "q", adapter_idx)
        k = self._attn_proj(lora_p, h, "k", adapter_idx)
        v = self._attn_proj(lora_p, h, "v", adapter_idx)
        q = layers.apply_rope(q.reshape(b, s, cfg.n_heads, hd), positions,
                              cfg.rope_theta)
        k = layers.apply_rope(k.reshape(b, s, cfg.n_kv_heads, hd), positions,
                              cfg.rope_theta)
        return q, k, v.reshape(b, s, cfg.n_kv_heads, hd)

    def _residual(self, x, attn_out):
        b, s = x.shape[:2]
        x = x + attn_out.reshape(b, s, -1) @ self.wo
        h = layers.apply_norm(self.cfg.norm, self.norm2["scale"], x)
        return x + layers.apply_mlp(self.cfg.mlp, self.mlp, h)

    def prefill(self, x, lora_p, adapter_idx, positions):
        """x: (B, S, d) -> (x, {"k", "v"}: (B, S, KV, D))."""
        q, k, v = self._qkv(x, lora_p, adapter_idx, positions)
        scale = 1.0 / math.sqrt(self.cfg.resolved_head_dim)
        out = attention.ring_attention(q, k, v, scale=scale)
        return self._residual(x, out), {"k": k, "v": v}

    def decode(self, x, lora_p, adapter_idx, cache, slot):
        """x: (B, 1, d); slot: the step's ``attention.CacheSlot``, its
        position on x's device; cache {"k", "v"} is updated in place."""
        positions = slot.pos.reshape(1, 1).expand(x.shape[0], 1)
        q, k, v = self._qkv(x, lora_p, adapter_idx, positions)
        out = attention.decode_attention(q[:, 0], cache["k"], cache["v"],
                                         k[:, 0], v[:, 0], slot)
        return self._residual(x, out[:, None])


class Model(nn.Module):
    """A decoder with per-request multi-adapter LoRA on q and v.

    ``device`` defaults to CUDA and raises without it; weights are drawn
    from a ``torch.Generator`` seeded with ``seed`` (the JAX package's
    distributions, not its values: ``bridge.load_params`` copies those).
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, cfg.torch_dtype
        gen = torch.Generator(device=dev).manual_seed(seed)
        v, d = layers.pad_vocab(cfg.vocab_size), cfg.d_model
        self.embed = nn.ParameterDict({
            "embed": _param(layers.embed_init(gen, (v, d), dt, dev)),
            "unembed": _param(layers.dense_init(gen, (d, v), dt, dev))})
        self.final_norm = nn.ParameterDict(
            {"scale": _param(torch.ones(d, dtype=dt, device=dev))})
        self.layers = nn.ModuleList(
            Block(cfg, gen, dev) for _ in range(cfg.n_layers))

    def init_lora(self, n_adapters: int, rank: int,
                  seed: int = 0) -> Dict[str, Any]:
        """Per-adapter LoRA banks on the configured targets (q, v):
        {"layers": [{"a_q": (N, d, r), "b_q": (N, r, o), ...}, ...]}."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.torch_dtype
        gen = torch.Generator(device=dev).manual_seed(seed)
        hd = cfg.resolved_head_dim
        out_dims = {"q": cfg.n_heads * hd, "v": cfg.n_kv_heads * hd}
        banks: List[Dict[str, torch.Tensor]] = []
        for _ in self.layers:
            p = {}
            for t in cfg.lora_targets:
                p[f"a_{t}"] = layers.dense_init(
                    gen, (n_adapters, cfg.d_model, rank), dt, dev)
                p[f"b_{t}"] = layers.dense_init(
                    gen, (n_adapters, rank, out_dims[t]), dt, dev,
                    fan_in=rank)
            banks.append(p)
        return {"layers": banks}

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"pos": torch.zeros((), dtype=torch.int32, device=self.device),
                "layers": [{"k": torch.zeros(shape, dtype=cfg.torch_dtype,
                                             device=self.device),
                            "v": torch.zeros(shape, dtype=cfg.torch_dtype,
                                             device=self.device)}
                           for _ in self.layers]}

    def _lora_layers(self, lora):
        return lora["layers"] if lora is not None else [None] * len(self.layers)

    def _logits(self, x):
        x = layers.apply_norm(self.cfg.norm, self.final_norm["scale"], x)
        return layers.unembed(self.embed, x, self.cfg.logit_softcap)

    @torch.no_grad()
    def prefill(self, lora, tokens, adapter_idx=None):
        """tokens: (B, S). Returns (last-token logits (B, V), cache)."""
        x = layers.embed_tokens(self.embed["embed"], tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        caches = []
        for block, lp in zip(self.layers, self._lora_layers(lora)):
            x, kv = block.prefill(x, lp, adapter_idx, positions)
            caches.append(kv)
        logits = self._logits(x[:, -1:])
        pos = torch.full((), s, dtype=torch.int32, device=x.device)
        return logits[:, 0], {"pos": pos, "layers": caches}

    @torch.no_grad()
    def decode_step(self, lora, cache, tokens, adapter_idx=None):
        """tokens: (B, 1). Returns (logits (B, V), cache): the cache itself,
        its KV tensors written and its ``pos`` advanced by one in place.

        ``pos`` is read on the device only, and nothing in the step waits
        for the host or the host for it, so a CUDA graph that captures one
        call replays the step at every position."""
        pos = cache["pos"]
        slot = attention.CacheSlot.at(pos, cache["layers"][0]["k"].shape[1])
        x = layers.embed_tokens(self.embed["embed"], tokens)
        for block, lp, c in zip(self.layers, self._lora_layers(lora),
                                cache["layers"]):
            x = block.decode(x, lp, adapter_idx, c, slot)
        logits = self._logits(x)
        pos.add_(1)
        return logits[:, 0], cache


def pad_cache(cache, extra: int):
    """Grow the KV capacity of a prefill cache by ``extra`` positions."""
    def pad(t):
        return torch.cat([t, t.new_zeros((t.shape[0], extra) + t.shape[2:])],
                         dim=1)
    return {"pos": cache["pos"].clone(),
            "layers": [{k: pad(v) for k, v in c.items()}
                       for c in cache["layers"]]}


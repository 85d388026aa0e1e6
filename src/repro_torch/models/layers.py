"""Primitive layers of the port (counterparts of ``repro.models.layers``).

Functions on tensors; parameters live in the ``nn.Module``s of
``transformer.py``.  Weights keep the JAX package's (in, out) layout, so a
projection is ``x @ w``.  RMSNorm, RoPE and the SwiGLU activation compute
in f32 and cast back, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------- #
# init helpers (the same distributions as the JAX package, torch's draws)
# --------------------------------------------------------------------------- #


def dense_init(gen: torch.Generator, shape, dtype, device,
               fan_in: Optional[int] = None):
    """N(0, 1/fan_in) with fan_in = shape[-2] unless given."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w.mul_(std)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w.mul_(0.02)).to(dtype)


# --------------------------------------------------------------------------- #
# norms, positions, MLP
# --------------------------------------------------------------------------- #

def apply_norm(kind: str, scale, x, eps: float = 1e-6):
    """RMSNorm computed in f32, then cast to x's dtype."""
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm={kind!r}: ROADMAP.md queue 1 item 6 (other dense variants)")
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    The split-halves form of the JAX package (layers.py:67-68), not the
    interleaved one.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs    # (..., S, D/2)
    angles = angles[..., None, :]                     # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(kind: str, p, x):
    """SwiGLU MLP; the activation is computed in f32, then cast."""
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp={kind!r}: ROADMAP.md queue 1 item 6 (other dense variants)")
    gate = (x @ p["w_gate"]).float()
    up = (x @ p["w_up"]).float()
    h = (F.silu(gate) * up).to(x.dtype)
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# embedding / unembedding
# --------------------------------------------------------------------------- #

def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def embed_tokens(embed, tokens):
    return embed[tokens]


def unembed(p, x, softcap: float = 0.0):
    """f32 logits over the padded vocab (the padding is kept, as in the JAX
    package)."""
    if "unembed" in p:
        logits = (x @ p["unembed"]).float()
    else:
        logits = (x @ p["embed"].T).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits

"""Primitive layers of the port (counterparts of ``repro.models.layers``).

Functions on tensors; parameters live in the ``nn.Module``s of
``transformer.py``.  Weights keep the JAX package's (in, out) layout, so a
projection is ``x @ w``.  The norms, RoPE and the MLP's activation compute
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

def apply_norm(kind: str, p, x, eps: float = 1e-6):
    """RMSNorm (``p["scale"]``) or LayerNorm (``p["scale"]``, ``p["bias"]``,
    population variance), computed in f32, then cast to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions, width: int):
    """positions: (..., S) -> f32 (..., S, width): the ``[sin | cos]``
    halves of the JAX package (layers.py:72-77), not interleaved."""
    half = width // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


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
    """SwiGLU or GELU MLP; the activation is computed in f32, then cast.
    GELU is the tanh approximation, ``jax.nn.gelu``'s default."""
    up = (x @ p["w_up"]).float()
    if kind == "swiglu":
        h = F.silu((x @ p["w_gate"]).float()) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h.to(x.dtype) @ p["w_down"]


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


def cross_entropy(logits, labels, mask=None):
    """logits (..., V) f32; labels int (...,).  The mean of logsumexp minus
    the gold logit, or its mean over ``mask``, divided by max(sum(mask), 1)
    (layers.py:146-154)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)

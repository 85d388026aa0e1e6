"""Primitive layers of the port (counterparts of ``repro.models.layers``).

Functions on tensors; parameters live in the ``nn.Module``s of
``transformer.py``.  Weights keep the JAX package's (in, out) layout, so a
projection is ``x @ w``.  The norms, RoPE and the MLP's activation compute
in f32 and cast back, as the JAX package does.  Where the JAX package
keeps a product of bf16 operands in f32 (``preferred_element_type``) and
computes on from it, the port takes ``matmul_f32``/``bmm_f32``.
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
# products kept in f32
# --------------------------------------------------------------------------- #

class _ProductF32(torch.autograd.Function):
    """The f32 product of two CUDA operands of one 16-bit dtype: cuBLAS's
    ``out_dtype`` overload of ``mm``/``bmm``, each product of the operands'
    values accumulated in f32 and never rounded to their dtype; the
    weights are not upcast.  The overloads have no derivative, so backward
    is written here: the cotangent cast to the operands' dtype and its two
    products in that dtype, what autograd of ``(x @ w).float()`` computes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        op = torch.bmm if x.dim() == 3 else torch.mm
        return op(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gw = x.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def _product_f32(x, w):
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.device.type in ("cuda", "meta"):   # meta: the card's route
        return _ProductF32.apply(x, w)
    return x.float() @ w.float()      # the plain version: exact on the CPU


def matmul_f32(x, w):
    """x (..., d) @ w (d, f) -> f32 (..., f): ``jnp.einsum(...,
    preferred_element_type=jnp.float32)`` of bf16 (or f32) operands."""
    lead = x.shape[:-1]
    return _product_f32(x.reshape(-1, x.shape[-1]), w).reshape(
        *lead, w.shape[-1])


def bmm_f32(a, b):
    """a (n, m, k) @ b (n, k, f) -> f32 (n, m, f), as ``matmul_f32``."""
    return _product_f32(a, b)


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
    """SwiGLU or GELU MLP; gate and up are f32 products, the activation is
    computed in f32, then cast.  GELU is the tanh approximation,
    ``jax.nn.gelu``'s default."""
    return mlp_hidden(kind, p, x) @ p["w_down"]


def mlp_hidden(kind: str, p, x):
    """``apply_mlp`` before its down projection: the activation, in x's
    dtype (over the rank's columns of w_up/w_gate when they are
    sharded)."""
    up = matmul_f32(x, p["w_up"])
    if kind == "swiglu":
        h = F.silu(matmul_f32(x, p["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h.to(x.dtype)


# --------------------------------------------------------------------------- #
# embedding / unembedding
# --------------------------------------------------------------------------- #

def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def embed_tokens(embed, tokens):
    """The rows of ``embed`` at ``tokens``.  ``F.embedding``, whose CPU
    backward sums a row's gradients in token order: the indexing
    ``embed[tokens]`` accumulates them across threads in no fixed order,
    and a training run would not repeat to the bit."""
    return F.embedding(tokens, embed)


def unembed(p, x, softcap: float = 0.0):
    """f32 logits over the padded vocab (the padding is kept, as in the JAX
    package)."""
    if "unembed" in p:
        logits = matmul_f32(x, p["unembed"])
    else:
        logits = matmul_f32(x, p["embed"].T)
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

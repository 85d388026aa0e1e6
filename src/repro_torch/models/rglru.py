"""RG-LRU recurrent mixer of the port (counterpart of
``repro.models.rglru``; RecurrentGemma / Griffin, arXiv:2402.19427).

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is per
channel, with block-diagonal recurrence and input gates.  The JAX package
computes it in plain ``jnp`` (no Pallas kernel), and so does the port, in
plain PyTorch: prefill scans the sequence in log depth (``rglru_scan``),
decode is the O(1) update.  Decode writes its conv and lru states into the
tensors it is given, in place (the JAX package returns new ones), so a
CUDA graph that captured a step keeps its buffers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .ssm import causal_conv

C_RGLRU = 8.0
N_GATE_BLOCKS = 16


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg, dtype, device):
    """The mixer's parameters, with the JAX package's shapes, dtypes and
    distributions (``rglru.py:27-42``): ``a_param`` in f32."""
    d, w, nb = cfg.d_model, lru_width(cfg), N_GATE_BLOCKS
    wb = w // nb

    def dense(shape, fan_in=None):
        return layers.dense_init(gen, shape, dtype, device, fan_in)
    conv = torch.randn((cfg.conv_width, w), generator=gen,
                       dtype=torch.float32, device=device) * 0.1
    return {
        "w_x": dense((d, w)),
        "w_gate": dense((d, w)),
        "conv_w": conv.to(dtype),
        "w_a": dense((nb, wb, wb), fan_in=wb),
        "w_i": dense((nb, wb, wb), fan_in=wb),
        "a_param": torch.ones(w, dtype=torch.float32, device=device),
        "w_out": dense((w, d), fan_in=w),
    }


def _block_gate(u, w):
    """Block-diagonal linear in f32: u (B, S, W), w (nb, wb, wb) -> (B, S,
    W) f32."""
    b, s, width = u.shape
    nb, wb, _ = w.shape
    ub = u.reshape(b, s, nb, wb).float()
    out = torch.einsum("bsnw,nwk->bsnk", ub, w.float())
    return out.reshape(b, s, width)


def rglru_scan(a, bx, h0=None):
    """h_t = a_t * h_{t-1} + bx_t over axis 1, from h_{-1} = h0 (or 0).
    a/bx: (B, S, W) f32 -> (B, S, W).  Log depth: at step k each position
    t >= 2^k folds in the pair 2^k before it, (a, b) o (a', b') = (a a',
    a b' + b), the JAX package's associative combine (``rglru.py:58-67``).
    """
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    off = 1
    while off < a.shape[1]:
        bx = torch.cat([bx[:, :off], a[:, off:] * bx[:, :-off] + bx[:, off:]],
                       1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return bx


def apply_rglru(p, x, *, conv_state=None, lru_state=None):
    """x: (B, S, d) -> (y (B, S, d), (conv_state, lru_state)), as the JAX
    ``apply_rglru`` (``rglru.py:70-102``).

    Prefill (no ``lru_state``, or S > 1): a conv from zeros and the scan
    from ``lru_state`` (or 0); the states returned are new tensors.
    Decode (``lru_state`` and S == 1): one conv tap window from
    ``conv_state`` (B, conv_width - 1, W) in x's dtype and one step from
    ``lru_state`` (B, W) f32; both are updated IN PLACE and returned.
    """
    gate_b = F.gelu(layers.matmul_f32(x, p["w_gate"]),
                    approximate="tanh").to(x.dtype)
    u = x @ p["w_x"]
    decode = lru_state is not None and x.shape[1] == 1
    u, new_conv = causal_conv(u, p["conv_w"],
                              state=conv_state if decode else None,
                              activate=False)

    r = torch.sigmoid(_block_gate(u, p["w_a"]))
    i = torch.sigmoid(_block_gate(u, p["w_i"]))
    a_param = p["a_param"]
    softplus = torch.logaddexp(a_param, torch.zeros_like(a_param))
    log_a = -C_RGLRU * softplus[None, None, :] * r
    a = torch.exp(log_a)
    gated_x = u.float() * i
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * gated_x

    if decode:
        h = a[:, 0] * lru_state.float() + b[:, 0]
        conv_state.copy_(new_conv)
        lru_state.copy_(h)
        new_conv, new_state = conv_state, lru_state
        h = h[:, None]
    else:
        h = rglru_scan(a, b, None if lru_state is None
                       else lru_state.float())
        new_conv, new_state = new_conv.contiguous(), h[:, -1].contiguous()

    y = h.to(x.dtype) * gate_b
    out = y @ p["w_out"]
    return out, (new_conv, new_state.float())

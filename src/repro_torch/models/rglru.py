"""RG-LRU recurrent mixer of the port (counterpart of
``repro.models.rglru``; RecurrentGemma / Griffin, arXiv:2402.19427).

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is per
channel, with block-diagonal recurrence and input gates.  The JAX package
computes it in plain ``jnp`` (no Pallas kernel), and so does the port, in
plain PyTorch: prefill scans the sequence in log depth (``rglru_scan``),
decode is the O(1) update.  Decode writes its conv and lru states into the
tensors it is given, in place (the JAX package returns new ones), so a
CUDA graph that captured a step keeps its buffers.

Under width tensor parallelism (``apply_rglru(..., shards=...)``) a rank
holds the pieces its plan gives it (``sharding.py:91-163``, ``:196-208``):
``w_x``, ``w_gate``, ``conv_w`` and ``w_out``'s rows cut over the width W
(and the ``conv`` and ``lru`` states with them) when the axis divides
it, the block-diagonal ``w_a`` and ``w_i`` cut over their blocks when the
axis divides the 16 blocks, and ``a_param`` whole (sliced to the rank's
channels here).  The JAX package lets pjit lay the mixer out from those
specs (its channels are independent, so the mixer's one collective is
``w_out``'s); the port does it by hand: when the axis divides W but not
the blocks, the rank's channels cut a block apart, so the gates' input is
gathered whole, both gates run on every block (``w_a``, ``w_i`` whole)
and the rank keeps its channels of them.
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


def init_rglru(gen: torch.Generator, cfg, dtype, device, place=None):
    """The mixer's parameters, with the JAX package's shapes, dtypes and
    distributions (``rglru.py:27-42``): ``a_param`` in f32.  ``place(name,
    t)``, where given, turns each one into what is kept as soon as it is
    drawn (under a plan, the rank's piece)."""
    d, w, nb = cfg.d_model, lru_width(cfg), N_GATE_BLOCKS
    wb = w // nb
    place = place or (lambda name, t: t)

    def dense(name, shape, fan_in=None):
        return place(name, layers.dense_init(gen, shape, dtype, device,
                                             fan_in))
    # the order of the draws (conv_w first) fixes the weights a seed gives
    conv = place("conv_w", (torch.randn((cfg.conv_width, w), generator=gen,
                                        dtype=torch.float32, device=device)
                            * 0.1).to(dtype))
    return {
        "w_x": dense("w_x", (d, w)),
        "w_gate": dense("w_gate", (d, w)),
        "conv_w": conv,
        "w_a": dense("w_a", (nb, wb, wb), fan_in=wb),
        "w_i": dense("w_i", (nb, wb, wb), fan_in=wb),
        "a_param": place("a_param", torch.ones(w, dtype=torch.float32,
                                               device=device)),
        "w_out": dense("w_out", (w, d), fan_in=w),
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


def apply_rglru(p, x, *, conv_state=None, lru_state=None, shards=None):
    """x: (B, S, d) -> (y (B, S, d), (conv_state, lru_state)), as the JAX
    ``apply_rglru`` (``rglru.py:70-102``).

    Prefill (no ``lru_state``, or S > 1): a conv from zeros and the scan
    from ``lru_state`` (or 0); the states returned are new tensors.
    Decode (``lru_state`` and S == 1): one conv tap window from
    ``conv_state`` (B, conv_width - 1, W) in x's dtype and one step from
    ``lru_state`` (B, W) f32; both are updated IN PLACE and returned.

    ``shards`` (``sharding.WidthShards``; see the module's docstring):
    ``p`` and the states are the rank's pieces, and y is summed over the
    width group.  Under autograd (training under a train plan) x, which
    enters the rank's channels, and the whole leaves cut to them have
    their gradients summed over the group.
    """
    # the rank's channels (of W) and gate blocks, where the plan cuts them
    chans = shards is not None and "w_x" in shards
    blocks = shards is not None and "w_a" in shards
    # x enters the rank's channels: its gradient summed over the group
    xc = shards.enter(x, chans) if shards is not None else x
    gate_b = F.gelu(layers.matmul_f32(xc, p["w_gate"]),
                    approximate="tanh").to(x.dtype)
    u = xc @ p["w_x"]
    decode = lru_state is not None and x.shape[1] == 1
    u, new_conv = causal_conv(u, p["conv_w"],
                              state=conv_state if decode else None,
                              activate=False)

    ub = u if shards is None else shards.relayout(u, chans, blocks)
    r = torch.sigmoid(_block_gate(ub, p["w_a"]))
    i = torch.sigmoid(_block_gate(ub, p["w_i"]))
    a_param = p["a_param"]
    if shards is not None:   # the gates, and a_param, on the rank's channels
        r = shards.relayout(r, blocks, chans)
        i = shards.relayout(i, blocks, chans)
        a_param = shards.piece(a_param) if chans else a_param
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
    if shards is not None:
        out = shards.reduce(out, chans)
    return out, (new_conv, new_state.float())

"""State-space mixers of the port (counterpart of ``repro.models.ssm``).

So far only ``causal_conv``, the depthwise causal convolution that the
RG-LRU mixer (``rglru.py``) shares with the Mamba2 mixer; the SSD mixer
itself is ROADMAP.md queue 1 item 8a.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv(x, w, state=None, activate: bool = True):
    """Depthwise causal conv. x: (B, S, C); w: (W, C); state: (B, W-1, C)
    or None (zeros).  Returns (out, new_state), new_state the last W-1
    inputs (``ssm.py:48-64``): the taps are summed in x's dtype in tap
    order, and with ``activate`` SiLU runs in f32, as in the JAX package.
    """
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(width))
    new_state = xp[:, s:] if width > 1 else None
    if activate:
        out = F.silu(out.float()).to(x.dtype)
    return out, new_state

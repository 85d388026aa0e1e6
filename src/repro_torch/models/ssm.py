"""State-space mixers of the port (counterpart of ``repro.models.ssm``):
the Mamba2 / SSD mixer (arXiv:2405.21060) and ``causal_conv``, the
depthwise causal convolution it shares with the RG-LRU mixer
(``rglru.py``).

Prefill runs the chunked SSD scan: within a chunk a masked quadratic form,
across chunks a linear recurrence on the (heads, head_dim, state) tensor.
Decode is the O(1) recurrent update on the carried state.  The JAX package
computes both in plain ``jnp`` (no Pallas kernel), and so does the port,
in plain PyTorch, with the JAX dtypes and casts.  Decode writes its conv
and ssm states into the tensors it is given, in place (the JAX package
returns new ones), so a CUDA graph that captured a step keeps its buffers.

Under width tensor parallelism (``apply_ssd(..., shards=...)``) a rank
holds the pieces its plan gives it (``sharding.py:91-163``, ``:196-208``):
``w_z``, ``w_x``, ``conv_x`` and ``w_out``'s rows cut over ``d_inner``
(and the ``conv_x`` state with them) when the axis divides it, ``w_dt``
and the ``ssm`` state cut over the heads when the axis divides H, and
``w_bc``, ``conv_bc``, ``a_log``, ``dt_bias`` and ``d_skip`` whole (the
last three sliced to the rank's heads here).  The JAX package lets pjit
lay the mixer out from those specs (its heads are independent, so the
mixer's one collective is ``w_out``'s); the port does it by hand: when
the axis divides ``d_inner`` but not H, the rank's channels cut heads
apart, so x after its conv is gathered whole, the scan runs on every
head (the ``ssm`` state is whole) and the rank keeps its channels after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers


def ssd_dims(cfg):
    """(d_inner, heads, head_dim, state) of the mixer (``ssm.py:21-24``)."""
    d_inner = cfg.d_inner
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
        cfg.ssm_state


def init_ssd(gen: torch.Generator, cfg, dtype, device, place=None):
    """The mixer's parameters, with the JAX package's names, shapes, dtypes
    and distributions (``ssm.py:27-45``): ``a_log``, ``dt_bias`` and
    ``d_skip`` in f32.  ``place(name, t)``, where given, turns each one
    into what is kept as soon as it is drawn (under a plan, the rank's
    piece)."""
    d = cfg.d_model
    d_inner, n_heads, _, state = ssd_dims(cfg)
    place = place or (lambda name, t: t)

    def dense(shape, fan_in=None):
        return layers.dense_init(gen, shape, dtype, device, fan_in)

    def conv(width):
        return (torch.randn((cfg.conv_width, width), generator=gen,
                            dtype=torch.float32, device=device)
                * 0.1).to(dtype)

    def full(value):
        return torch.full((n_heads,), value, dtype=torch.float32,
                          device=device)
    draws = (("w_z", lambda: dense((d, d_inner))),
             ("w_x", lambda: dense((d, d_inner))),
             ("w_bc", lambda: dense((d, 2 * state))),
             ("w_dt", lambda: dense((d, n_heads))),
             ("w_out", lambda: dense((d_inner, d), fan_in=d_inner)),
             ("conv_x", lambda: conv(d_inner)),
             ("conv_bc", lambda: conv(2 * state)),
             ("a_log", lambda: full(0.0)),
             ("dt_bias", lambda: full(-2.0)),
             ("d_skip", lambda: full(1.0)))
    return {name: place(name, draw()) for name, draw in draws}


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


def ssd_chunked(x, b, c, dt, a_log, *, chunk: int, init_state=None):
    """Chunked SSD scan (``ssm.py:67-132``), every product in f32.

    x: (B, S, H, P) values; b, c: (B, S, N); dt: (B, S, H) f32
    (post-softplus); a_log: (H,); init_state: (B, H, P, N) or None (zeros).
    The chunk is the largest divisor of S up to ``chunk`` (a prime S runs
    chunks of 1, as in the JAX package).  Returns (y (B, S, H, P) f32,
    final state (B, H, P, N) f32).
    """
    bs, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    nc, q = s // chunk, chunk

    a = -torch.exp(a_log)                                  # (H,) negative
    xr = x.reshape(bs, nc, q, h, p).float()
    br = b.reshape(bs, nc, q, n).float()
    cr = c.reshape(bs, nc, q, n).float()
    dtr = dt.reshape(bs, nc, q, h)
    cum = torch.cumsum(dtr * a, dim=2)                     # (B, nc, q, H)
    seg_sum = cum[:, :, -1]                                # (B, nc, H)
    decay_to_end = torch.exp(seg_sum[:, :, None] - cum)
    # the incoming state's contribution to token i decays by a_1..a_i
    decay_from_start = torch.exp(cum)

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, weighted by dt_j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B, nc, q, q, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.where(causal[None, None, :, :, None], torch.exp(li), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)
    gates = cb[..., None] * lmat * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", gates, xr)

    # each chunk's contributed state: (B, nc, H, P, N)
    xdt = xr * (dtr * decay_to_end)[..., None]
    chunk_states = torch.einsum("bcqhp,bcqn->bchpn", xdt, br)

    # inter-chunk recurrence: the state BEFORE each chunk
    decay_chunk = torch.exp(seg_sum)                       # (B, nc, H)
    carry = (x.new_zeros((bs, h, p, n), dtype=torch.float32)
             if init_state is None else init_state.float())
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * decay_chunk[:, i, :, None, None] + chunk_states[:, i]
    prev = torch.stack(prev, dim=1)                        # (B, nc, H, P, N)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cr, prev)
    y_inter = y_inter * decay_from_start[..., None]
    return (y_intra + y_inter).reshape(bs, s, h, p), carry


def apply_ssd(p, x, cfg, *, conv_state=None, ssm_state=None, shards=None):
    """The Mamba2 mixer body (the norm is the caller's), as the JAX
    ``apply_ssd`` (``ssm.py:135-182``).  x: (B, S, d) -> (y (B, S, d),
    (conv_x, conv_bc, ssm)).

    Prefill (no ``ssm_state``, or S > 1): the convs from zeros and the
    chunked scan (chunks of up to ``cfg.ssm_chunk``) from ``ssm_state``
    (or 0); the states returned are new
    tensors.  Decode (``ssm_state`` and S == 1): ``conv_state`` is
    (conv_x (B, W-1, d_inner), conv_bc (B, W-1, 2N)) in x's dtype,
    ``ssm_state`` (B, H, P, N) f32; one O(1) step, the ssm state updated
    in place and y read from it, the conv states written in place; all
    three returned.

    ``shards`` (``sharding.WidthShards``; see the module's docstring):
    ``p`` and the states are the rank's pieces, and y is summed over the
    width group; the rank's states are what it updates.  Under autograd
    (training under a train plan) each tensor held alike over the group
    that enters the rank's channels or heads (x, B and C, the per-head
    leaves) has its gradient summed over the group there.
    """
    _, _, hd, state = ssd_dims(cfg)
    bs, s, _ = x.shape
    # the rank's channels (of d_inner) and heads, where the plan cuts them
    chans = shards is not None and "w_x" in shards
    heads = shards is not None and "w_dt" in shards

    def mine(t):   # a whole per-head leaf, as the rank's heads
        return shards.piece(t) if heads else t
    # x enters the rank's channels (and heads); w_bc's product stays whole
    xc = shards.enter(x, chans) if shards is not None else x
    z = xc @ p["w_z"]
    xi = xc @ p["w_x"]
    bc = x @ p["w_bc"]
    # dt stays f32 from its projection on: bf16 inputs, f32 products
    dt = layers.matmul_f32(xc if heads else x, p["w_dt"]) + \
        mine(p["dt_bias"])
    dt = torch.logaddexp(dt, torch.zeros_like(dt))        # softplus

    decode = ssm_state is not None and s == 1
    cx_state, cbc_state = conv_state if decode else (None, None)
    xi, new_cx = causal_conv(xi, p["conv_x"], state=cx_state)
    bc, new_cbc = causal_conv(bc, p["conv_bc"], state=cbc_state)
    if shards is not None:   # the scan's channels: its heads'
        xi = shards.relayout(xi, chans, heads)
    xi = xi.reshape(bs, s, -1, hd)
    if heads:   # the whole B and C enter the rank's heads
        bc = shards.enter(bc, True)
    b, c = bc[..., :state], bc[..., state:]

    if decode:
        a = -torch.exp(mine(p["a_log"]))
        da = torch.exp(dt[:, 0] * a)                       # (B, H)
        xdt = xi[:, 0] * dt[:, 0, :, None]                 # (B, H, P) f32
        upd = xdt[..., None] * b[:, 0, None, None, :].float()
        ssm_state.mul_(da[:, :, None, None]).add_(upd)     # f32, in place
        # y from the updated state: (B, H, P, N) @ (B, 1, N, 1)
        y = (ssm_state @ c[:, 0, None, :, None].float())[..., 0][:, None]
        cx_state.copy_(new_cx)
        cbc_state.copy_(new_cbc)
        new_cx, new_cbc, new_state = cx_state, cbc_state, ssm_state
    else:
        y, new_state = ssd_chunked(xi, b, c, dt, mine(p["a_log"]),
                                   chunk=cfg.ssm_chunk,
                                   init_state=ssm_state)
        new_cx, new_cbc = new_cx.contiguous(), new_cbc.contiguous()

    y = y + xi.float() * mine(p["d_skip"])[:, None]
    y = y.reshape(bs, s, -1).to(x.dtype)
    if shards is not None:   # back to the rank's channels, z's and w_out's
        y = shards.relayout(y, heads, chans)
    y = y * F.silu(z.float()).to(x.dtype)                  # the gate
    out = y @ p["w_out"]
    if shards is not None:
        out = shards.reduce(out, chans)
    return out, (new_cx, new_cbc, new_state.float())

"""Public kernel entry points, dispatched by the tensor's device.

The counterparts of ``repro.kernels.ops``.  A CUDA tensor launches the
hand-written kernel (BGMV, SGMV, flash-decode, fused flash-decode+LoRA) or
raises; a CPU tensor takes the kernel's plain version.  Nothing here
probes for a backend or falls back from a failed launch.

Shared conventions with the JAX package:

* adapter ids < 0 mean "base model, no adapter" -> zero LoRA delta;
* ``ranks`` (shape (N,), ranks[i] <= r_max) makes the adapter bank ragged:
  adapter i uses only its first ranks[i] LoRA lanes.
"""
from __future__ import annotations

import torch

from . import bgmv as bgmv_mod, flash_decode as fd_mod, ref, sgmv as sgmv_mod

#: the wrappers that count their launches (``<wrapper>.launches``)
KERNELS = {"bgmv": bgmv_mod.bgmv, "sgmv": sgmv_mod.sgmv,
           "flash_decode": fd_mod.flash_decode,
           "flash_decode_lse": fd_mod.flash_decode_lse,
           "flash_decode_lora": fd_mod.flash_decode_lora}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (wrapper name -> launches) to the counts.

    A CUDA graph's replay launches what its capture counted without calling
    a wrapper, so whoever replays it counts it here; a capture, which
    counted but launched nothing, takes its counts back with ``times=-1``.
    """
    for name, n in counts.items():
        KERNELS[name].launches += n * times


def lora_apply(x, a, b, idx, scale: float = 1.0, ranks=None, arrival=None,
               tokens=None):
    """Multi-adapter LoRA delta: y[t] = scale * x[t] @ A[idx[t]] @ B[idx[t]].

    x: (..., d); idx: per-token adapter ids broadcastable to x's leading
    dims, or per-REQUEST ids of shape (B,) for x of shape (B, S, d).
    a: (N, d, r); b: (N, r, o).  Returns (..., o).  ids < 0 -> zero delta;
    ``ranks`` (N,) enables ragged per-adapter ranks.

    ``tokens`` and ``arrival``, where given: x is one rank's piece of a
    prompt of ``tokens`` tokens cut over ranks, and ``arrival`` (x's
    tokens, flattened) their arrival ranks in it (``sgmv.arrival_ranks``).
    The kernel is then picked by the whole prompt's size and SGMV keeps its
    capacity rule (``sgmv_capacity(tokens, N)``), so that the pieces
    compute what the whole prompt computes.  The CPU's per-request path
    has no capacity (as the JAX package's plain path) and reads neither.
    """
    idx = torch.as_tensor(idx, device=x.device)
    lead = x.shape[:-1]
    d = x.shape[-1]
    if x.device.type == "cpu" and x.ndim == 3 and idx.shape == (x.shape[0],):
        # per-request adapters (the serving engine's layout), as the JAX
        # package's plain path (ops.py:48-62): gather A/B per request and
        # round h and y to x's dtype
        if ranks is not None:
            a, b = ref.mask_ragged(a, b, ranks)
        idx0 = idx.clamp(min=0).long()
        h = torch.einsum("bsd,bdr->bsr", x.float(),
                         a[idx0].float()).to(x.dtype)
        y = torch.einsum("bsr,bro->bso", h.float(),
                         b[idx0].float()).to(x.dtype)
        y = torch.where((idx >= 0)[:, None, None], y, torch.zeros_like(y))
        return y * torch.tensor(scale, dtype=x.dtype)

    # token-level ids: broadcast per-request ids over the trailing dims
    if idx.shape != lead:
        idx = idx.reshape(*idx.shape, *([1] * (len(lead) - idx.ndim)))
    it = idx.broadcast_to(lead).reshape(-1).to(torch.int32).contiguous()
    xt = x.reshape(-1, d).contiguous()
    if ranks is not None:
        ranks = torch.as_tensor(ranks, dtype=torch.int32,
                                device=x.device).contiguous()
    t = xt.shape[0] if tokens is None else tokens
    if t <= 4 * a.shape[0]:
        # decode-sized -> BGMV; ragged banks are pre-masked (ops.py:77-84)
        if ranks is not None:
            a, b = ref.mask_ragged(a, b, ranks)
        out = bgmv_mod.bgmv(xt, a.contiguous(), b.contiguous(), it, scale)
    else:
        # prefill-sized -> SGMV, which masks ragged lanes itself
        out = sgmv_mod.sgmv(
            xt, a.contiguous(), b.contiguous(), it, scale, ranks=ranks,
            arrival=arrival,
            cap=None if tokens is None else ref.sgmv_capacity(t, a.shape[0]))
    return out.reshape(*lead, -1)


def flash_decode(q, k, v, length, k_scale=None, v_scale=None):
    """Single-token attention against a contiguous KV cache.

    q: (B, H, D); k/v: (B, S, KV, D); length: valid prefix length, scalar
    or (B,).  With ``k_scale``/``v_scale`` (B, S, KV) f16, k and v are an
    int8 cache (``models.attention.quantize_kv``).
    """
    return fd_mod.flash_decode(q, k, v, length, k_scale, v_scale)


def flash_decode_lse(q, k, v, length, k_scale=None, v_scale=None):
    """``flash_decode`` that also returns the (B, H) f32 log-sum-exp of the
    scaled scores: (out in f32, lse)."""
    return fd_mod.flash_decode_lse(q, k, v, length, k_scale, v_scale)


def fused_decode(q, k, v, length, x, a, b, idx, scale: float = 1.0,
                 ranks=None):
    """Fused decode step: ``attn(q,K,V) + scale * x @ A[idx] @ B[idx]``.

    One kernel launch per decode step instead of base-then-adapter.
    q: (B, H, D); k/v: (B, S, KV, D); x: (B, dx); a: (N, dx, r);
    b: (N, r, H*D); idx: (B,) adapter ids (< 0 -> base model);
    ``ranks`` (N,) enables ragged per-adapter ranks (the bank is masked
    first, as ``repro.kernels.ops.fused_decode`` masks it).  Returns
    (B, H, D).
    """
    if ranks is not None:
        a, b = ref.mask_ragged(a, b, ranks)
    idx = torch.as_tensor(idx, dtype=torch.int32, device=q.device)
    return fd_mod.flash_decode_lora(q, k, v, length, x, a.contiguous(),
                                    b.contiguous(), idx, scale)

"""Plain PyTorch oracles for the LoRA and decode-attention kernels.

Function for function the counterparts of ``repro.kernels.ref``, with the
same rounding points (products accumulate in f32, then cast to the input's
dtype where the JAX oracle casts), plus ``sgmv_ref``: the plain version of
the SGMV kernel, with the TPU kernel's capacity rule, and
``flash_decode_int8_ref``: attention over an int8 cache dequantized to f32.
"""
from __future__ import annotations

import torch


def mask_ragged(a, b, ranks):
    """Zero the padded LoRA lanes of a ragged-rank adapter bank.

    a: (N, d, r_max); b: (N, r_max, o); ranks: (N,) with ranks[i] <= r_max.
    Adapter i keeps only its first ranks[i] lanes; any dense kernel run on
    the result is exactly the ragged computation.
    """
    r = a.shape[-1]
    ranks = torch.as_tensor(ranks, device=a.device)
    valid = torch.arange(r, device=a.device)[None, :] < ranks[:, None]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return (torch.where(valid[:, None, :], a, zero),
            torch.where(valid[:, :, None], b, zero.to(b.dtype)))


def lora_shrink_ref(x, a, idx):
    """x: (T, d); a: (N, d, r); idx: (T,) -> (T, r)."""
    return torch.einsum("td,tdr->tr", x.float(), a[idx].float()).to(x.dtype)


def lora_expand_ref(h, b, idx):
    """h: (T, r); b: (N, r, o); idx: (T,) -> (T, o)."""
    return torch.einsum("tr,tro->to", h.float(), b[idx].float()).to(h.dtype)


def lora_ref(x, a, b, idx, scale: float = 1.0):
    """y = scale * (x @ A[idx]) @ B[idx]; tokens with idx < 0 get 0.

    x: (T, d); a: (N, d, r); b: (N, r, o); idx: (T,) -> (T, o).
    """
    idx = torch.as_tensor(idx, device=x.device)
    idx0 = idx.clamp(min=0)
    h = lora_shrink_ref(x, a, idx0)
    y = lora_expand_ref(h, b, idx0) * torch.tensor(scale, dtype=x.dtype)
    return torch.where((idx >= 0)[:, None], y, torch.zeros_like(y))


def lora_ref_ragged(x, a, b, idx, ranks, scale: float = 1.0):
    """Ragged-rank oracle: the dense oracle over ``mask_ragged`` weights."""
    am, bm = mask_ragged(a, b, ranks)
    return lora_ref(x, am, bm, idx, scale)


def _bucket_positions(idx, n: int):
    """Each token's rank among earlier tokens of its adapter (arrival order);
    tokens with an id outside [0, N) get rank 0 and are masked by the
    caller."""
    # a comparison, not one_hot: one_hot checks its ids on the host, which
    # would stall the card (and break CUDA-graph capture) in sgmv_ref
    onehot = (idx[:, None] == torch.arange(n, device=idx.device)[None, :])
    onehot = onehot.to(torch.int64)
    pos = torch.cumsum(onehot, dim=0) - onehot
    return (pos * onehot).sum(dim=1)


def lora_ref_bucketed(x, a, b, idx, scale: float = 1.0,
                      overprovision: float = 2.0):
    """Capacity-bucketed formulation, as ``repro.kernels.ref``: tokens over
    capacity min(T, overprovision*ceil(T/N) + 8) get a zero delta."""
    t, d = x.shape
    n = a.shape[0]
    idx = torch.as_tensor(idx, device=x.device)
    cap = min(t, int(overprovision * -(-t // n)) + 8)
    pos = _bucket_positions(idx, n)
    keep = (pos < cap) & (idx >= 0)
    posc = torch.where(keep, pos, torch.full_like(pos, cap))
    idx0 = idx.clamp(min=0).long()
    buf = torch.zeros((n, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[idx0, posc] = torch.where(keep[:, None], x, torch.zeros_like(x))
    h = torch.einsum("ncd,ndr->ncr", buf[:, :cap].float(),
                     a.float()).to(x.dtype)
    y = torch.einsum("ncr,nro->nco", h.float(), b.float()).to(x.dtype)
    out = y[idx0, posc.clamp(0, cap - 1)]
    out = torch.where(keep[:, None], out, torch.zeros_like(out))
    return out * torch.tensor(scale, dtype=x.dtype)


def sgmv_capacity(t: int, n: int) -> int:
    """Per-adapter token capacity of the TPU SGMV kernel (sgmv.py:121-122):
    min(T, 2*ceil(T/N) + 128), rounded up to a multiple of 128."""
    cap = min(t, 2 * -(-t // n) + 128)
    return -(-cap // 128) * 128


def sgmv_ref(x, a, b, idx, scale: float = 1.0, ranks=None, cap=None):
    """Plain version of the SGMV kernel.

    y[t] = scale * x[t] @ A[idx[t]] @ B[idx[t]] with h kept in f32 between
    the two products, as the kernel keeps it.  A token with idx < 0, or
    whose rank among its adapter's tokens (arrival order) is >= the
    capacity ``cap`` (default ``sgmv_capacity(T, N)``), gets exactly 0.
    ``ranks`` (N,) masks lanes >= ranks[i] of A's columns and B's rows.
    """
    n = a.shape[0]
    idx = torch.as_tensor(idx, device=x.device)
    if ranks is not None:
        a, b = mask_ragged(a, b, ranks)
    cap = sgmv_capacity(x.shape[0], n) if cap is None else cap
    return lora_f32(x, a, b, idx, scale, _bucket_positions(idx, n) < cap)


def lora_f32(x, a, b, idx, scale: float = 1.0, keep=None):
    """The LoRA kernels' arithmetic: y[t] = scale * x[t] @ A[idx[t]] @
    B[idx[t]] with h = x @ A kept in f32 between the two products (as in
    the Pallas kernels, bgmv.py:29-32), output in x's dtype.  Tokens with
    an id outside [0, N), or with ``keep`` False, get exactly 0."""
    n = a.shape[0]
    valid = (idx >= 0) & (idx < n)
    if keep is not None:
        valid &= keep
    idx0 = idx.clamp(0, n - 1).long()
    h = torch.einsum("td,tdr->tr", x.float(), a[idx0].float())
    y = torch.einsum("tr,tro->to", h, b[idx0].float()) * scale
    return torch.where(valid[:, None], y, torch.zeros_like(y)).to(x.dtype)


def flash_decode_ref(q, k, v, length):
    """Single-token attention against a contiguous cache, as
    ``repro.kernels.ref.flash_decode_ref`` (a length of 0 gives the mean of
    V there, through a softmax over all-masked logits).

    q: (B, H, D); k/v: (B, S, KV, D); length: scalar or (B,) valid length.
    """
    bsz, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qs = q.reshape(bsz, kv, h // kv, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qs.float(), k.float()) \
        / torch.sqrt(torch.tensor(float(d)))
    ln = torch.as_tensor(length, device=q.device)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] < (ln[:, None] if ln.ndim else ln[None, None])
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(bsz, h, d).to(q.dtype)


def flash_decode_int8_ref(q, k, v, length, k_scale, v_scale):
    """Oracle of the int8 cache's attention: K and V dequantized to f32
    (int8 times its f16 scale) and ``flash_decode_ref``'s f32 softmax, P
    kept in f32 (the kernel and the JAX package round P times v_scale to
    bf16).

    q: (B, H, D); k/v: (B, S, KV, D) int8; k_scale/v_scale: (B, S, KV)
    f16; length: scalar or (B,) valid length.
    """
    kf = k.float() * k_scale.float()[..., None]
    vf = v.float() * v_scale.float()[..., None]
    return flash_decode_ref(q.float(), kf, vf, length).to(q.dtype)


def fused_decode_ref(q, k, v, length, x, a, b, idx, scale: float = 1.0):
    """Composed oracle for the fused decode kernel:

        attn(q, K, V)  +  scale * x @ A[idx] @ B[idx]   (reshaped (H, D))

    q: (B, H, D); k/v: (B, S, KV, D); x: (B, dx); a: (N, dx, r);
    b: (N, r, H*D); idx: (B,) per-request adapter ids, -1 = base model
    (zero delta).  This is literally ``flash_decode_ref`` + ``lora_ref``
    — the fused kernel is tested against this composition.
    """
    bsz, h, d = q.shape
    attn = flash_decode_ref(q, k, v, length)
    delta = lora_ref(x, a, b, idx, scale).reshape(bsz, h, d)
    return (attn.float() + delta.float()).to(q.dtype)

"""Attention of the port (counterparts of ``repro.models.attention``).

Prefill runs causal attention in plain PyTorch, chunked over the queries
with an f32 online-softmax state, as the JAX package's ``ring_attention``
at one shard (``_attend_chunked`` + ``_finalize``); the JAX package
computes it outside any Pallas kernel too.  Decode writes the new K/V into
the cache in place and attends with the port's flash-decode kernel; the
step's position stays on the device (``CacheSlot``).
Sequence sharding (``n_shards > 1``) is ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops

NEG_INF = -1.0e30


def _flash_block(q, k, v, mask, scale, m, lse, acc):
    """One online-softmax update.

    q: (B, C, KV, G, D)   k/v: (B, S, KV, D)   mask: (C, S)
    m, lse: (B, C, KV, G)   acc: (B, C, KV, G, D)  (all f32)
    """
    s = torch.einsum("bckgd,bskd->bckgs", q.float(), k.float()) * scale
    mask_b = mask[None, :, None, None, :]
    s = s.masked_fill(~mask_b, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = (s - m_new[..., None]).exp().masked_fill(~mask_b, 0.0)
    corr = (m - m_new).exp()
    l_new = lse * corr + p.sum(-1)
    pv = torch.einsum("bckgs,bskd->bckgd", p, v.float())
    return m_new, l_new, acc * corr[..., None] + pv


def _chunk_count(seq: int, chunk: int) -> int:
    chunk = min(chunk, seq) if chunk else seq
    while seq % chunk:
        chunk -= 1
    return seq // chunk


def _attend_chunked(q, k, v, q_pos, kv_pos, scale, q_chunk: int):
    """Chunked (over Q) causal attention of q against a kv buffer.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D); q_pos: (Sq,); kv_pos: (Skv,)
    Returns f32 (m, lse, acc) of shapes (B,Sq,KV,G), (B,Sq,KV,G),
    (B,Sq,KV,G,D).
    """
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qs = q.reshape(b, sq, kvh, g, d)
    nc = _chunk_count(sq, q_chunk)
    c = sq // nc
    outs = []
    for i in range(nc):
        qp = q_pos[i * c:(i + 1) * c]
        mask = (qp[:, None] >= kv_pos[None, :]) & (kv_pos[None, :] >= 0)
        m0 = qs.new_full((b, c, kvh, g), NEG_INF, dtype=torch.float32)
        l0 = qs.new_zeros((b, c, kvh, g), dtype=torch.float32)
        a0 = qs.new_zeros((b, c, kvh, g, d), dtype=torch.float32)
        outs.append(_flash_block(qs[:, i * c:(i + 1) * c], k, v, mask, scale,
                                 m0, l0, a0))
    return tuple(torch.cat([o[j] for o in outs], dim=1) for j in range(3))


def _finalize(m, lse, acc, dtype):
    out = acc / lse.clamp(min=1e-20)[..., None]
    b, s, kv, g, d = out.shape
    return out.reshape(b, s, kv * g, d).to(dtype)


def ring_attention(q, k, v, *, scale: float, q_chunk: int = 256):
    """Causal self-attention at one sequence shard.

    q: (B, S, H, D); k/v: (B, S, KV, D) -> (B, S, H, D) in q's dtype.
    """
    sq, skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device)
    m, lse, acc = _attend_chunked(q, k, v, q_pos,
                                  torch.arange(skv, device=q.device),
                                  scale, q_chunk)
    return _finalize(m, lse, acc, q.dtype)


class CacheSlot(NamedTuple):
    """Where one decode step writes into a cache of S positions and how far
    it attends, as device tensors made once a step from the batch's one
    ``pos`` (a 0-d int32 tensor): no host value, so a CUDA graph that
    captured the step replays it at every position."""
    pos: torch.Tensor     # () int32: the batch's position, for RoPE
    index: torch.Tensor   # (1,) int64: clamp(pos, 0, S - 1), the row written
    live: torch.Tensor    # () bool: 0 <= pos < S; else the write is skipped
    length: torch.Tensor  # () int32: min(pos + 1, S), the positions attended

    @classmethod
    def at(cls, pos: torch.Tensor, s: int) -> "CacheSlot":
        index = pos.clamp(0, s - 1).reshape(1).long()
        return cls(pos, index, index[0] == pos, (pos + 1).clamp(max=s))


def decode_update_cache(cache, new, slot: CacheSlot) -> None:
    """Write ``new`` (B, KV, D) at ``slot.index`` of ``cache`` (B, S, KV, D),
    IN PLACE (the JAX package returns an updated copy).  A ``pos`` outside
    [0, S) writes the row back unchanged, as the JAX package's clipped
    write and ``where`` keep it (attention.py:244-253), in O(B*KV*D)."""
    old = cache.index_select(1, slot.index)
    cache.index_copy_(1, slot.index,
                      torch.where(slot.live, new[:, None].to(cache.dtype), old))


def decode_attention(q, k_cache, v_cache, new_k, new_v, slot: CacheSlot):
    """One new token against the cache, which it first extends in place.

    q: (B, H, D); caches: (B, S, KV, D); new_k/new_v: (B, KV, D); slot: the
    step's ``CacheSlot``.  Attends positions <= pos, i.e. length pos + 1
    (all of S once pos passes the end).  Returns (B, H, D).
    """
    decode_update_cache(k_cache, new_k, slot)
    decode_update_cache(v_cache, new_v, slot)
    return ops.flash_decode(q.contiguous(), k_cache, v_cache, slot.length)

"""Attention of the port (counterparts of ``repro.models.attention``).

Prefill and the training step run causal attention in plain PyTorch,
chunked over the queries with an f32 online-softmax state, as the JAX
package's ``ring_attention`` and ``local_attention`` at one shard
(``_attend_chunked`` + ``_finalize``); the JAX package computes it outside
any Pallas kernel too, and under autograd each chunk's block is recomputed
in backward (``_flash_block_ckpt``).  Decode writes
the new K/V into the cache in place and attends with the port's
flash-decode kernel, on global layers' caches and on local layers' rolling
buffers alike; the step's position stays on the device (``CacheSlot``).
A global layer's cache may be int8 with one f16 scale per (token, head)
(``quantize_kv``; the JAX package's ``ShardingPlan.kv_quant``): the new K/V
are quantized on the device and flash-decode reads the int8 cache and its
scales as they are.  Under a decode plan a global layer's cache is
sequence-sharded (``decode_attention_sharded``): each rank writes the new
row only if it owns ``pos``, runs flash-decode over its slice and gets back
the log-sum-exp with the output, and the ranks combine by it
(``combine_shards``).  Under a prefill plan the sequence is cut over the
plan's sequence axis and the prefill attention is the JAX package's
per-rank bodies (attention.py:146-219): ``ring_attention`` passes each
rank's K/V around the ring (``sharding.shift``) and merges the partial
states in the JAX order, ``local_attention`` gathers only the previous
chunks its window reaches.  Under a train plan the same bodies run under
autograd: ``shift``'s adjoint, the reverse shift, carries each K/V
slice's gradient back to its rank, and every rank issues its shifts in
the same order in the forward and in the block's recompute.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

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


def _flash_block_ckpt(*args):
    """``_flash_block``, recomputed in backward when autograd records (the
    JAX package's ``_flash_block_ckpt``, attention.py:76): without it
    autograd keeps each chunk's (B, C, KV, G, S) f32 scores for every
    layer.  Under ``no_grad`` (prefill, decode) it is ``_flash_block``."""
    if torch.is_grad_enabled():
        return checkpoint(_flash_block, *args, use_reentrant=False)
    return _flash_block(*args)


def _chunk_count(seq: int, chunk: int) -> int:
    chunk = min(chunk, seq) if chunk else seq
    while seq % chunk:
        chunk -= 1
    return seq // chunk


def _attend_chunked(q, k, v, q_pos, kv_pos, scale, window: int,
                    q_chunk: int):
    """Chunked (over Q) causal attention of q against a kv buffer; with
    ``window`` > 0 a query attends only the ``window`` positions ending at
    its own; a negative ``kv_pos`` is masked.

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
        if window:
            mask &= (qp[:, None] - kv_pos[None, :]) < window
        m0 = qs.new_full((b, c, kvh, g), NEG_INF, dtype=torch.float32)
        l0 = qs.new_zeros((b, c, kvh, g), dtype=torch.float32)
        a0 = qs.new_zeros((b, c, kvh, g, d), dtype=torch.float32)
        outs.append(_flash_block_ckpt(qs[:, i * c:(i + 1) * c], k, v, mask,
                                      scale, m0, l0, a0))
    return tuple(torch.cat([o[j] for o in outs], dim=1) for j in range(3))


def _finalize(m, lse, acc, dtype):
    out = acc / lse.clamp(min=1e-20)[..., None]
    b, s, kv, g, d = out.shape
    return out.reshape(b, s, kv * g, d).to(dtype)


def _merge_state(state_a, state_b):
    """Two online-softmax partial states (m, lse, acc) as one (the JAX
    package's ``_merge_state``, attention.py:128-134, op for op)."""
    m_a, l_a, a_a = state_a
    m_b, l_b, a_b = state_b
    m = torch.maximum(m_a, m_b)
    ca, cb = (m_a - m).exp(), (m_b - m).exp()
    return m, l_a * ca + l_b * cb, a_a * ca[..., None] + a_b * cb[..., None]


def ring_attention(q, k, v, *, scale: float, q_chunk: int = 256,
                   group=None, index: int = 0, n_shards: int = 1):
    """Causal self-attention of a sequence cut into ``n_shards`` slices
    (the JAX package's per-rank body, attention.py:146-188).

    q: (B, S_loc, H, D); k/v: (B, S_loc, KV, D), this rank's slice
    (``index`` on ``group``, positions [index * S_loc, (index + 1) *
    S_loc)) -> (B, S_loc, H, D) in q's dtype.  At step j the rank holds the
    K/V of rank (index - j) mod n, attends them and passes them on
    (``sharding.shift``, K and V in one message); the partial states are
    merged in the order j = 0 .. n - 1 from an empty state, as the JAX
    loop merges them, and finalized once.  At one shard: causal attention
    over the slice, no collective.
    """
    if n_shards == 1:
        return local_attention(q, k, v, scale=scale, window=0,
                               q_chunk=q_chunk)
    from .sharding import shift
    b, sq, h, _ = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    q_pos = index * sq + torch.arange(sq, device=q.device)
    state = (q.new_full((b, sq, kvh, h // kvh), NEG_INF, dtype=torch.float32),
             q.new_zeros((b, sq, kvh, h // kvh), dtype=torch.float32),
             q.new_zeros((b, sq, kvh, h // kvh, q.shape[-1]),
                         dtype=torch.float32))
    kv = torch.stack([k, v])
    for j in range(n_shards):
        src = (index - j) % n_shards
        kv_pos = src * skv + torch.arange(skv, device=q.device)
        state = _merge_state(state, _attend_chunked(
            q, kv[0], kv[1], q_pos, kv_pos, scale, 0, q_chunk))
        if j != n_shards - 1:
            kv = shift(kv, group)
    return _finalize(*state, q.dtype)


def local_attention(q, k, v, *, scale: float, window: int,
                    q_chunk: int = 256, group=None, index: int = 0,
                    n_shards: int = 1):
    """Sliding-window causal self-attention of a sequence cut into
    ``n_shards`` slices (the JAX package's per-rank body,
    attention.py:195-219); shapes as ``ring_attention``; window 0: no
    window.  The rank gathers the min(ceil(window / S_loc), n - 1) slices
    before its own from its ring predecessors (``sharding.shift``, K and V
    in one message); the first ranks' wrapped-around slices sit at
    negative positions, which are masked.  At one shard: no neighbour
    slice, no collective."""
    if n_shards == 1:
        q_pos = torch.arange(q.shape[1], device=q.device)
        kv_pos = torch.arange(k.shape[1], device=q.device)
        m, lse, acc = _attend_chunked(q, k, v, q_pos, kv_pos, scale, window,
                                      q_chunk)
        return _finalize(m, lse, acc, q.dtype)
    from .sharding import shift
    skv = k.shape[1]
    parts = [torch.stack([k, v])]
    for _ in range(min(-(-window // skv), n_shards - 1)):
        parts.insert(0, shift(parts[0], group))
    kv = torch.cat(parts, dim=2)
    q_pos = index * q.shape[1] + torch.arange(q.shape[1], device=q.device)
    start = (index - len(parts) + 1) * skv
    kv_pos = start + torch.arange(kv.shape[2], device=q.device)
    m, lse, acc = _attend_chunked(q, kv[0], kv[1], q_pos, kv_pos, scale,
                                  window, q_chunk)
    return _finalize(m, lse, acc, q.dtype)


class CacheSlot(NamedTuple):
    """Where one decode step writes into a cache of S positions and how far
    it attends, as device tensors made once a step from the batch's one
    ``pos`` (a 0-d int32 tensor): no host value, so a CUDA graph that
    captured the step replays it at every position."""
    pos: torch.Tensor     # () int32: the batch's position, for RoPE
    index: torch.Tensor   # (1,) int64: the row written
    live: Optional[torch.Tensor]  # () bool: whether it is written; None: always
    length: torch.Tensor  # () int32: the positions attended, a prefix of S

    @classmethod
    def at(cls, pos: torch.Tensor, s: int) -> "CacheSlot":
        """A global layer's cache: row clamp(pos, 0, S - 1), written while
        0 <= pos < S, attending min(pos + 1, S) rows."""
        index = pos.clamp(0, s - 1).reshape(1).long()
        return cls(pos, index, index[0] == pos, (pos + 1).clamp(max=s))

    @classmethod
    def shard(cls, pos: torch.Tensor, s_loc: int, my: int) -> "CacheSlot":
        """Slice ``my`` of a cache sequence-sharded into slices of ``s_loc``
        rows (positions [my * s_loc, (my + 1) * s_loc)): row pos - my *
        s_loc, clamped into the slice, written only where pos lies in it
        (``decode_update_cache`` of the JAX package, attention.py:244-253),
        attending clamp(pos + 1 - my * s_loc, 0, s_loc) rows: none on a
        slice past pos."""
        local = pos - my * s_loc
        index = local.clamp(0, s_loc - 1).reshape(1).long()
        return cls(pos, index, index[0] == local,
                   (local + 1).clamp(0, s_loc))

    @classmethod
    def rolling(cls, pos: torch.Tensor, w: int) -> "CacheSlot":
        """A local layer's rolling buffer of w rows (the JAX package's
        ``decode_attention_rolling``, attention.py:317-351): row pos % w,
        always written, attending min(pos + 1, w) rows.  Slot i holds
        position i until the first wrap and the latest position p with
        p % w == i after it, so the positions in (pos - w, pos] fill the
        prefix [0, min(pos + 1, w)) of the buffer, and attention, which is
        order-free over keys, is flash-decode's over that prefix."""
        index = pos.remainder(w).reshape(1).long()
        return cls(pos, index, None, (pos + 1).clamp(max=w))


def quantize_kv(x):
    """Per-(token, head) symmetric int8 quantization over the last axis, bit
    for bit the JAX package's ``quantize_kv`` (attention.py:226-241).

    x: (..., KV, D) -> (int8 (..., KV, D), f16 scale (..., KV)).  The scale
    is max|x| / 127 + 1e-8 in f32, rounded to f16; x is divided by the f16
    scale in f32, rounded half to even and clipped to +-127.  A row whose
    scale rounds to 0 in f16 (max|x| below ~3e-8) divides 0 by 0, which
    gives 0, as XLA's float-to-int conversion makes NaN 0.
    """
    xf = x.float()
    scale = (xf.abs().amax(-1) / 127.0 + 1e-8).to(torch.float16)
    q = torch.round(xf / scale[..., None].float()).clamp(-127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def decode_update_cache(cache, new, slot: CacheSlot) -> None:
    """Write ``new`` (B, KV, ...) at ``slot.index`` of ``cache`` (B, S, KV,
    ...), IN PLACE (the JAX package returns an updated copy): K/V rows of
    (B, S, KV, D) and an int8 cache's f16 scales of (B, S, KV) alike.  A
    global slot whose ``pos`` lies outside [0, S) writes the row back
    unchanged, as the JAX package's clipped write and ``where`` keep it
    (attention.py:244-253), in O(B*KV*D)."""
    new = new[:, None].to(cache.dtype)
    if slot.live is not None:
        new = torch.where(slot.live, new, cache.index_select(1, slot.index))
    cache.index_copy_(1, slot.index, new)


def decode_attention(q, k_cache, v_cache, new_k, new_v, slot: CacheSlot,
                     k_scale=None, v_scale=None):
    """One new token against the cache, which it first extends in place.

    q: (B, H, D); caches: (B, S, KV, D); new_k/new_v: (B, KV, D); slot: the
    step's ``CacheSlot`` for this cache (``at`` for a global layer's,
    ``rolling`` for a local layer's buffer).  With ``k_scale``/``v_scale``
    (B, S, KV) f16 the caches are int8: the new K/V are quantized
    (``quantize_kv``) and written with their scales, as the JAX package's
    quantized branch does (attention.py:277-283).  Attends the slot's
    ``length`` rows.  Returns (B, H, D).
    """
    if k_scale is not None:
        # K and V quantized in one call (row by row, as two would)
        (new_k, new_v), (nks, nvs) = quantize_kv(torch.stack([new_k, new_v]))
        decode_update_cache(k_scale, nks, slot)
        decode_update_cache(v_scale, nvs, slot)
    decode_update_cache(k_cache, new_k, slot)
    decode_update_cache(v_cache, new_v, slot)
    return ops.flash_decode(q.contiguous(), k_cache, v_cache, slot.length,
                            k_scale, v_scale)


def combine_shards(out, lse, reduce):
    """The attention over a whole cache from its slices' (``out``, ``lse``),
    in f32: out (..., H, D) and lse (..., H), both f32, as
    ``ops.flash_decode_lse`` gives them for one slice;
    ``reduce(t, op)`` reduces t over the slices, op "max" or "sum" (an
    all-reduce over the cache's ranks, or a reduction over a stacked
    leading axis).  Each slice weighs exp(lse - max lse): 0 for a slice
    with no live row (lse -inf).  The JAX package's one ``pmax`` and two
    ``psum``s of (m, l, acc) (attention.py:305-309) are here one max of
    lse and one sum of [out * w | w]; the caller casts the quotient to
    q's dtype once.  At one slice the weight is 1 and the result is
    ``out`` bit for bit."""
    m = reduce(lse.clone(), "max")
    w = torch.exp(lse - m)[..., None]
    part = reduce(torch.cat([out * w, w], dim=-1), "sum")
    return part[..., :-1] / part[..., -1:]


def decode_attention_sharded(q, k_cache, v_cache, new_k, new_v,
                             slot: CacheSlot, k_scale=None, v_scale=None, *,
                             group=None):
    """The per-rank body of the JAX package's ``decode_attention_sharded``
    (attention.py:256-314) on a sequence-sharded cache.

    q: (B, H, D) and new_k/new_v: (B, KV, D), replicated over the cache's
    ranks; caches: this rank's slice (B, S_loc, KV, D), and with
    ``k_scale``/``v_scale`` (B, S_loc, KV) f16 the int8 cache's scales,
    sharded with the rows; slot: ``CacheSlot.shard`` of this slice.  The
    new row is written in place on the rank that owns ``pos`` (quantized
    first for an int8 cache, as ``decode_attention`` does); flash-decode
    attends the slice's live rows and returns its output in f32 and its
    log-sum-exp; the ranks of ``group`` combine (``combine_shards``: one
    all-reduce max and one all-reduce sum) and the result is cast once.
    An int8 slice rounds P * v_scale against its own max, as the JAX body
    rounds it against each shard's.  Returns (B, H, D) in q's dtype.
    """
    from .sharding import all_reduce
    if k_scale is not None:
        (new_k, new_v), (nks, nvs) = quantize_kv(torch.stack([new_k, new_v]))
        decode_update_cache(k_scale, nks, slot)
        decode_update_cache(v_scale, nvs, slot)
    decode_update_cache(k_cache, new_k, slot)
    decode_update_cache(v_cache, new_v, slot)
    out, lse = ops.flash_decode_lse(q.contiguous(), k_cache, v_cache,
                                    slot.length, k_scale, v_scale)
    return combine_shards(out, lse, lambda t, op: all_reduce(t, op, group)
                          ).to(q.dtype)

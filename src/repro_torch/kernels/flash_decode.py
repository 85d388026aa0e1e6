"""Flash-decode: single-token GQA attention over a contiguous KV cache, and
the fused decode step that adds a multi-adapter LoRA delta to it.

The ports of ``repro.kernels.flash_decode.flash_decode`` (Pallas,
flash_decode.py:95) and ``flash_decode_lora`` (flash_decode.py:205).  On a
CUDA tensor each launches the split-KV kernels in ``csrc/flash_decode.cu``
(a split pass and a log-sum-exp combine; the fused step adds a LoRA shrink
between them and the expand to the combine); on a CPU tensor each runs its
plain version; on ``meta`` each checks its inputs, returns empty outputs
of the kernel's shapes and dtypes and adds the call's cost to the open
counter (``cost``), launching nothing.  With f16 scales beside an int8
cache, ``flash_decode``
takes the kernel's int8 K/V mode (the JAX package's quantized decode,
``repro.models.attention.decode_attention_sharded``, computes it in plain
``jnp``).  Every mode takes any head dim 1..MAX_HEAD_DIM, as the Pallas
kernel takes any: up to 256 on instantiated head dims, past it on the
wide path.  ``flash_decode_lse`` is ``flash_decode`` that also returns
each (row, head)'s log-sum-exp: the slices of a sequence-sharded cache
combine by it (``models.attention.combine_shards``).
"""
from __future__ import annotations

import math

import torch

from . import build, cost
from .bgmv import MAX_RANK

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # csrc/flash_decode.cu instantiations
INT8_HEAD_DIMS = HEAD_DIMS[1:]         # the int8 mode's (a row >= 16 bytes)
MAX_INSTANCE_DIM = HEAD_DIMS[-1]  # any head dim 1..256 runs on an instance:
                                  # one without on the next larger's
MAX_HEAD_DIM = 1024   # past MAX_INSTANCE_DIM the wide path runs d unpadded
WIDE_TILE = 32        # positions in one of the wide path's tiles (kWideP)
MAX_GROUP = 8   # query heads a block (kMaxG): a KV head's G heads are cut
                # into head_groups(G) groups, each a block of the split pass
MMA256_GROUP = 16   # query heads a block of the bf16 pass at D 256
                    # (kMaxG256, split_mma_d256): an m16n8k16 A fragment's
                    # 16 rows, so that up to 16 heads read K and V once
TILE_BYTES = 16384                  # of K in one tile of the split pass
TILE_MIN, TILE_MAX = 16, 128        # positions in a tile, at least / most


def _lengths(length, bsz: int, device):
    if isinstance(length, int):
        # filled on the device: a copy from the host would synchronise the
        # stream, once per layer on the decode path
        return torch.full((bsz,), length, dtype=torch.int32, device=device)
    return torch.as_tensor(length, dtype=torch.int32,
                           device=device).broadcast_to((bsz,)).contiguous()


def flash_decode_plain(q, k, v, length, return_lse: bool = False):
    """The kernel's function in plain PyTorch: scale 1/sqrt(D), f32 softmax
    over the first min(length, S) positions of each row; a length of 0
    gives 0, as the kernel (and the Pallas kernel) gives.  With
    ``return_lse`` it returns the output before its cast (f32) and each
    (row, head)'s log-sum-exp of its scaled f32 scores over those
    positions, (B, H) in f32: m + log l of the softmax's max m and sum l,
    -inf at a length of 0 (``_lse``).

    q: (B, H, D); k/v: (B, S, KV, D); length: scalar or (B,).
    """
    if return_lse:
        return _attention_f32(q, k, v, length, with_lse=True)
    return _attention_f32(q, k, v, length).to(q.dtype)


def _lse(m, l, bsz: int, h: int):
    """m + log l as (B, H): a row whose length is 0 has m = -1e30 and
    l = 0, whose log is -inf, so that its weight in a log-sum-exp combine
    (``attention.combine_shards``) is exp(-inf) = 0."""
    return (m + l.log()).reshape(bsz, h)


def _attention_f32(q, k, v, length, with_lse: bool = False):
    """``flash_decode_plain`` before its cast: (B, H, D) in f32 (and the
    log-sum-exp, with ``with_lse``)."""
    bsz, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qs = q.reshape(bsz, kv, h // kv, d).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qs, k.float()) / math.sqrt(d)
    mask = (torch.arange(s, device=q.device)[None, :]
            < _lengths(length, bsz, q.device)[:, None])[:, None, None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    m = sc.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros_like(sc))
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    lsum = p.sum(-1, keepdim=True)
    out = (out / lsum.clamp(min=1e-20)).reshape(bsz, h, d)
    return (out, _lse(m, lsum, bsz, h)) if with_lse else out


def flash_decode_int8_plain(q, k, v, length, k_scale, v_scale,
                            exact_dot: bool = False,
                            return_lse: bool = False):
    """The int8 mode's function in plain PyTorch, step by step the JAX
    package's quantized decode (``decode_attention_sharded`` at one shard,
    attention.py:285-310): s = (q . k) in f32 / sqrt(D), times k_scale;
    an f32 softmax over the first min(length, S) positions with one global
    max; P times v_scale rounded to bf16 against V; the sum of the f32 P
    divides.  A length of 0 gives 0, as ``flash_decode_plain``.

    With ``exact_dot`` q . k is rounded to f32 once, from an f64 sum in
    which each product of q's f32 value and an int8 value is exact: the
    one f32 dot no order of summation changes, which the kernel computes
    with q in f32 (so a term P * v_scale rounds to the same bf16 value on
    both sides).  Without it the f32 sum's order is the einsum's, as in
    the JAX package, where the order is XLA's.

    With ``return_lse`` it returns the output before its cast (f32) and
    the log-sum-exp of the scaled scores, (B, H) in f32, as
    ``flash_decode_plain`` gives them.

    q: (B, H, D) in bf16 or f32; k/v: (B, S, KV, D) int8; k_scale/v_scale:
    (B, S, KV) f16; length: scalar or (B,) -> (B, H, D) in q's dtype.
    """
    bsz, h, d = q.shape
    p, m = _int8_softmax(q, k, length, k_scale, exact_dot, with_max=True)
    pv = (p * _per_head(v_scale)).to(torch.bfloat16)
    out = torch.einsum("bkgs,bskd->bkgd", pv.float(), v.float())
    lsum = p.sum(-1, keepdim=True)
    out = (out / lsum.clamp(min=1e-20)).reshape(bsz, h, d)
    return (out, _lse(m, lsum, bsz, h)) if return_lse else out.to(q.dtype)


def _per_head(scale):
    """(B, S, KV) scales as (B, KV, 1, S), beside (B, KV, G, S) scores."""
    return scale.float().permute(0, 2, 1)[:, :, None]


def _int8_softmax(q, k, length, k_scale, exact_dot=False, with_max=False):
    """The int8 mode's unnormalised f32 softmax (B, KV, G, S): s = (q . k)
    / sqrt(D) times k_scale over the first min(length, S) positions (q . k
    summed as ``flash_decode_int8_plain`` says), P = exp(s - max s), the
    max over the row (the amax is the kernel's pre-pass for q in f32), 0
    past the length; with ``with_max`` also that max, (B, KV, G, 1)."""
    bsz, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    wide = torch.float64 if exact_dot else torch.float32
    qs = q.reshape(bsz, kv, h // kv, d).to(wide)
    sc = torch.einsum("bkgd,bskd->bkgs", qs, k.to(wide)).float() \
        * (1.0 / math.sqrt(d))
    sc = sc * _per_head(k_scale)
    mask = (torch.arange(s, device=q.device)[None, :]
            < _lengths(length, bsz, q.device)[:, None])[:, None, None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    m = sc.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros_like(sc))
    return (p, m) if with_max else p


def _check_expand(q, b):
    h, d = q.shape[1:]
    if b.shape[-1] != h * d:
        raise ValueError(f"expand dim {b.shape[-1]} != H*D = {h * d}")


def flash_decode_lora_plain(q, k, v, length, x, a, b, idx,
                            scale: float = 1.0):
    """The fused kernel's function in plain PyTorch: the attention of
    ``flash_decode_plain`` in f32, plus scale * x @ A[idx] @ B[idx] with
    h = x @ A kept in f32, then one cast to q's dtype (as the Pallas
    epilogue, flash_decode.py:160-175).  A row whose id is outside [0, N)
    gets the attention alone (no add).

    q: (B, H, D); k/v: (B, S, KV, D); x: (B, dx); a: (N, dx, r);
    b: (N, r, H*D); idx: (B,) -> (B, H, D).
    """
    _check_expand(q, b)
    attn = _attention_f32(q, k, v, length)
    n = a.shape[0]
    idx = torch.as_tensor(idx, device=q.device)
    live = (idx >= 0) & (idx < n)
    ida = idx.clamp(0, n - 1).long()
    h = torch.einsum("bd,bdr->br", x.float(), a[ida].float())
    delta = torch.einsum("br,bro->bo", h, b[ida].float()) * scale
    out = torch.where(live[:, None, None], attn + delta.reshape(attn.shape),
                      attn)
    return out.to(q.dtype)


def is_wide(d: int) -> bool:
    """Whether head dim ``d`` runs on the wide path (``fd_split_wide_kernel``
    of ``csrc/flash_decode.cu``): MAX_INSTANCE_DIM < d <= MAX_HEAD_DIM."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    return d > MAX_INSTANCE_DIM


def instance_dim(d: int, itemsize: int) -> int:
    """The head dim whose kernels run head dim ``d`` with K's element size
    ``itemsize`` (1: the int8 mode): up to MAX_INSTANCE_DIM an
    instantiated one, ``d`` itself, else the next larger, padded
    (``instance_dim`` of ``csrc/flash_decode.cu``); past it ``d`` itself,
    on the wide path (``is_wide``), which runs any d unpadded."""
    if is_wide(d):
        return d
    return next(x for x in (INT8_HEAD_DIMS if itemsize == 1 else HEAD_DIMS)
                if x >= d)


def tile_positions(d: int, itemsize: int) -> int:
    """Positions in one tile of the split pass (``Tile::kP`` of
    ``csrc/flash_decode.cu``, at ``instance_dim``): TILE_BYTES of K,
    within [TILE_MIN, TILE_MAX]; WIDE_TILE on the wide path.  At the 256
    instance in bf16 a tile is 32 positions (16 KB of K, as many of V):
    the tensor-core pass there (``split_mma_d256``) gives each of its
    four warps the scores of 8 positions and the P V product of 64 of
    the 256 columns over all 32, in a ring of up to three 32 KB stages,
    two blocks an SM."""
    if is_wide(d):
        return WIDE_TILE
    di = instance_dim(d, itemsize)
    return min(TILE_MAX, max(TILE_MIN, TILE_BYTES // (di * itemsize)))


def mma256_pass(d: int, dtype, itemsize: int) -> bool:
    """Whether flash-decode at head dim ``d``, q's ``dtype`` and K's element
    size ``itemsize`` runs the bf16 tensor-core pass at D 256
    (``split_mma_d256`` of ``csrc/flash_decode.cu``): bf16 q and K/V at
    the 256 instance, d 129..256."""
    return (dtype == torch.bfloat16 and itemsize == 2 and not is_wide(d)
            and instance_dim(d, itemsize) == MAX_INSTANCE_DIM)


def head_groups(g: int, limit: int = MAX_GROUP) -> int:
    """Blocks a split gives the G query heads of one KV head: groups of
    at most ``limit`` (``head_groups`` of ``csrc/flash_decode.cu``), so
    that each group reads the KV head's K and V once: at G <= ``limit``
    one block reads them for all G.  ``limit`` is MMA256_GROUP on the
    bf16 tensor-core pass at D 256 (``mma256_pass``; the ``max_g`` of
    ``launch_fd``), whose heads are the 16 rows of its products, and
    MAX_GROUP on every other pass, whose per-head arrays hold 8."""
    return -(-g // limit)


def split_plan(bsz: int, groups: int, s: int, n_sm: int, tile: int):
    """(n_splits, chunk): enough (split, group, row) blocks to give each
    of the card's SMs about two, ``groups`` blocks a split and row (KV
    heads times ``head_groups``), with chunks of whole tiles of ``tile``
    positions; split i covers [i*chunk, min((i+1)*chunk, s))."""
    n_tiles = max(-(-s // tile), 1)
    want = -(-2 * n_sm // max(bsz * groups, 1))
    n_splits = max(1, min(want, n_tiles))
    chunk = -(-n_tiles // n_splits) * tile
    return max(-(-s // chunk), 1), chunk


def split_plan_d256(bsz: int, groups: int, s: int, n_sm: int, tile: int):
    """(n_splits, chunk) for the bf16 tensor-core pass at D 256, chosen from
    a sweep of its shapes' plans on the card (``PERF.md`` §6,
    ``bench/flash_decode_ab.py --sweep``).  A block there streams about
    20 GB/s, a 32-position tile in about 1.5 us, and the unchanged
    combine walks a (row, head)'s splits in turn, about 0.2 us each:

    - blocks fill the card in whole waves (the floor of the SMs' slots
      over the blocks a split, where ``split_plan`` takes the ceiling and
      leaves a part wave: at B 128 its three splits ran 1.45 waves);
    - two blocks an SM where a split's blocks (B times the groups) are
      more than half the SMs; one an SM where they are fewer, since a row
      then has many splits, whose walk in the combine costs more than
      the second block an SM gains (6 % of the stream at B 1);
    - at most ceil(2 sqrt(tiles)) splits: the split's time falls as
      tiles / n_splits and the combine's rises as n_splits.
    """
    n_tiles = max(-(-s // tile), 1)
    rows = max(bsz * groups, 1)
    per_sm = 2 if 2 * rows > n_sm else 1
    want = min(max(1, per_sm * n_sm // rows),
               math.ceil(2 * math.sqrt(n_tiles)))
    n_splits = max(1, min(want, n_tiles))
    chunk = -(-n_tiles // n_splits) * tile
    return max(-(-s // chunk), 1), chunk


def _check(q, k, v, lengths, k_scale=None, v_scale=None):
    quant = k_scale is not None or v_scale is not None
    scales = (k_scale, v_scale) if quant else ()
    if not (q.device.type in ("cuda", "meta")
            and all(t is not None and t.device == q.device
                    for t in (k, v, lengths) + scales)):
        raise ValueError("flash_decode: inputs must lie on one CUDA device")
    bsz, h, d = q.shape
    if k.shape != v.shape or k.ndim != 4 or k.shape[0] != bsz \
            or k.shape[3] != d:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    kv = k.shape[2]
    if h % kv or not 1 <= d <= MAX_HEAD_DIM:
        # the wide path stages q of 8 heads in shared memory and keeps d /
        # 128 elements of each in a thread's registers: 1024 at most
        raise ValueError(f"flash_decode: H={h}, KV={kv}, D={d} unsupported "
                         f"(H a multiple of KV, D in 1..{MAX_HEAD_DIM})")
    if quant:
        if not (k.dtype == v.dtype == torch.int8
                and k_scale.dtype == v_scale.dtype == torch.float16
                and q.dtype in (torch.bfloat16, torch.float32)):
            raise TypeError("flash_decode: the int8 mode takes int8 k and "
                            "v, f16 scales and q in bf16 or f32")
        if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
            raise ValueError(f"flash_decode: scales {tuple(k_scale.shape)},"
                             f" {tuple(v_scale.shape)} for k "
                             f"{tuple(k.shape)}: want (B, S, KV)")
    elif not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_decode: q, k and v must share one dtype")
    if not all(t.is_contiguous() for t in (q, k, v) + scales):
        raise ValueError("flash_decode: inputs must be contiguous")
    if (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned")


def _check_lora(q, x, a, b, idx):
    bsz = q.shape[0]
    if not all(t.device == q.device for t in (x, a, b, idx)):
        raise ValueError("flash_decode_lora: inputs must lie on one CUDA "
                         "device")
    _check_expand(q, b)
    n, dx, r = a.shape
    if x.shape != (bsz, dx) or b.shape[:2] != (n, r) or idx.shape != (bsz,):
        raise ValueError(f"flash_decode_lora: shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if x.dtype != q.dtype or a.dtype != b.dtype:
        raise TypeError("flash_decode_lora: x must share q's dtype and b "
                        "a's")
    if idx.dtype != torch.int32:
        raise TypeError(f"flash_decode_lora: idx must be int32, not "
                        f"{idx.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"flash_decode_lora: rank {r} outside "
                         f"[1, {MAX_RANK}]")
    if not all(t.is_contiguous() for t in (x, a, b, idx)):
        raise ValueError("flash_decode_lora: inputs must be contiguous")


def _launch_args(q, k, v, length, k_scale=None, v_scale=None,
                 out_dtype=None):
    """The arguments both kernels share: the checked lengths, the split
    plan (tiles of K's element size at its instance's head dim;
    ``split_plan_d256`` on the bf16 pass at D 256) and its f32 partials,
    and the output (in q's dtype unless ``out_dtype``)."""
    bsz, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    lengths = _lengths(length, bsz, q.device)
    _check(q, k, v, lengths, k_scale, v_scale)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    itemsize = k.element_size()
    d256 = mma256_pass(d, q.dtype, itemsize)
    plan = split_plan_d256 if d256 else split_plan
    groups = kv * head_groups(h // kv, MMA256_GROUP if d256 else MAX_GROUP)
    n_splits, chunk = plan(bsz, groups, s, n_sm, tile_positions(d, itemsize))
    m_part = torch.empty((bsz, h, n_splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((bsz, h, n_splits, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q, dtype=out_dtype or q.dtype)
    return (lengths, m_part, l_part, acc_part, out,
            (bsz, s, h, kv, d, n_splits, chunk))


def flash_decode(q, k, v, length, k_scale=None, v_scale=None):
    """q: (B, H, D); k/v: (B, S, KV, D); length: scalar or (B,) -> (B, H, D).

    Query head h attends KV head h // (H/KV) over positions < length;
    D is any of 1..MAX_HEAD_DIM (1024; past 256 on the wide path, a
    CUDA-core split pass of its own in every mode).  With
    ``k_scale``/``v_scale`` (B, S, KV) f16, k and v are int8
    (``attention.quantize_kv``) and the kernel's int8 mode reads
    them as they are (plain version: ``flash_decode_int8_plain``; with q
    in f32 a pre-pass finds the row's largest score first, so that P is
    rounded as the JAX package rounds it, and q . k is the exact dot's f32
    value, the plain version's with ``exact_dot``); both launches count
    here.
    """
    if q.device.type == "cpu":
        return _plain(q, k, v, length, k_scale, v_scale)
    if q.is_meta:
        return _meta("flash_decode", q, k, v, length, k_scale, v_scale)
    out = _launch(q, k, v, length, k_scale, v_scale)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_lse(q, k, v, length, k_scale=None, v_scale=None):
    """``flash_decode`` that also returns each (row, head)'s log-sum-exp:
    (out, lse).  out is in f32, the merge before its cast (rounded to q's
    dtype, bit for bit ``flash_decode``'s output), and lse (B, H) f32, the
    log-sum-exp of each (row, head)'s scaled scores, m + log l of the
    combine's merged max and sum (-inf at a length of 0).  The same split
    pass in every mode, and a combine of its own
    (``fd_combine_lse_kernel``), which writes both.  A sequence-sharded
    cache's slices combine by them (``models.attention.combine_shards``)
    before one rounding to q's dtype.
    """
    if q.device.type == "cpu":
        return _plain(q, k, v, length, k_scale, v_scale, return_lse=True)
    if q.is_meta:
        return _meta("flash_decode_lse", q, k, v, length, k_scale, v_scale,
                     lse=True)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    out = _launch(q, k, v, length, k_scale, v_scale, lse)
    flash_decode_lse.launches += 1
    return out, lse


flash_decode_lse.launches = 0


def _check_scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode: give both scales or neither")


def _plain(q, k, v, length, k_scale, v_scale, return_lse: bool = False):
    """The plain version of ``flash_decode`` (``flash_decode_lse``)."""
    _check_scales(k_scale, v_scale)
    if k_scale is not None:
        return flash_decode_int8_plain(q, k, v, length, k_scale, v_scale,
                                       return_lse=return_lse)
    return flash_decode_plain(q, k, v, length, return_lse=return_lse)


def _meta(name, q, k, v, length, k_scale, v_scale, lse=False):
    """``flash_decode`` (``flash_decode_lse`` with ``lse``) on ``meta``:
    the checks, the outputs' shapes and dtypes, and the call's cost over
    every position of the cache (``cost.flash_decode_cost``)."""
    _check_scales(k_scale, v_scale)
    bsz, h, d = q.shape
    _check(q, k, v, _lengths(length, bsz, q.device), k_scale, v_scale)
    out = torch.empty_like(q, dtype=torch.float32 if lse else q.dtype)
    cost.add(name, cost.flash_decode_cost(
        bsz, k.shape[1], h, k.shape[2], d, q.element_size(),
        k.element_size(), out.element_size(),
        0 if k_scale is None else k_scale.element_size(), lse))
    if lse:
        return out, torch.empty(q.shape[:2], dtype=torch.float32,
                                device=q.device)
    return out


def _launch(q, k, v, length, k_scale, v_scale, lse=None):
    """Launch flash-decode (its int8 mode with scales); with ``lse`` (B, H)
    f32 the combine writes the log-sum-exp there and the output in f32."""
    _check_scales(k_scale, v_scale)
    lengths, m_part, l_part, acc_part, out, dims = _launch_args(
        q, k, v, length, k_scale, v_scale,
        q.dtype if lse is None else torch.float32)
    stream = build.stream_handle(q.device)
    lse_ptr = 0 if lse is None else lse.data_ptr()
    if k_scale is not None:
        # q in f32: the pre-pass's largest score of each split, against
        # whose maximum P * v_scale is rounded (the JAX arithmetic)
        max_part = torch.empty_like(m_part) if q.dtype == torch.float32 \
            else None
        build.kernels().flash_decode_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), acc_part.data_ptr(),
            0 if max_part is None else max_part.data_ptr(), out.data_ptr(),
            lse_ptr, *dims, build.dtype_code(q.dtype), stream)
    else:
        build.kernels().flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            out.data_ptr(), lse_ptr, *dims, build.dtype_code(q.dtype),
            stream)
    return out


def flash_decode_lora(q, k, v, length, x, a, b, idx, scale: float = 1.0):
    """Fused decode step: ``attn(q, K, V) + scale * x @ A[idx] @ B[idx]``.

    q: (B, H, D); k/v: (B, S, KV, D); length: scalar or (B,); x: (B, dx)
    in q's dtype; a: (N, dx, r); b: (N, r, H*D); idx: (B,) int32 adapter
    ids (outside [0, N) -> the attention alone).  The bank may be f32
    under bf16 attention.  One call per decode step, one split plan with
    ``flash_decode``: an all-base batch gives its output bit for bit.
    """
    if q.device.type == "cpu":
        return flash_decode_lora_plain(q, k, v, length, x, a, b, idx, scale)
    _check_lora(q, x, a, b, idx)
    if q.is_meta:
        bsz, h, d = q.shape
        _check(q, k, v, _lengths(length, bsz, q.device))
        n, dx, r = a.shape
        cost.add("flash_decode_lora", cost.flash_decode_lora_cost(
            bsz, k.shape[1], h, k.shape[2], d, dx, r, min(bsz, n),
            q.element_size(), a.element_size()))
        return torch.empty_like(q)
    lengths, m_part, l_part, acc_part, out, dims = _launch_args(q, k, v,
                                                                length)
    n, dx, r = a.shape
    h_part = torch.empty((q.shape[0], r), dtype=torch.float32,
                         device=q.device)  # the shrink's h, row by row
    build.kernels().flash_decode_lora(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        x.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        h_part.data_ptr(), out.data_ptr(), *dims, dx, r, n, float(scale),
        build.dtype_code(q.dtype), build.dtype_code(a.dtype),
        build.stream_handle(q.device))
    flash_decode_lora.launches += 1
    return out


flash_decode_lora.launches = 0

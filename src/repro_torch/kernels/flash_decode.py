"""Flash-decode: single-token GQA attention over a contiguous KV cache.

The port of ``repro.kernels.flash_decode.flash_decode`` (Pallas,
flash_decode.py:95).  On a CUDA tensor ``flash_decode`` launches the
split-KV kernel in ``csrc/flash_decode.cu`` (a split pass and a log-sum-exp
combine); on a CPU tensor it runs ``flash_decode_plain``.
"""
from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128, 256)  # csrc/flash_decode.cu instantiations
MAX_GROUP = 8                       # query heads per KV head (kMaxG)
MIN_CHUNK = 64                      # positions per split, at least


def _lengths(length, bsz: int, device):
    if isinstance(length, int):
        # filled on the device: a copy from the host would synchronise the
        # stream, once per layer on the decode path
        return torch.full((bsz,), length, dtype=torch.int32, device=device)
    return torch.as_tensor(length, dtype=torch.int32,
                           device=device).broadcast_to((bsz,)).contiguous()


def flash_decode_plain(q, k, v, length):
    """The kernel's function in plain PyTorch: scale 1/sqrt(D), f32 softmax
    over the first min(length, S) positions of each row; a length of 0
    gives 0, as the kernel (and the Pallas kernel) gives.

    q: (B, H, D); k/v: (B, S, KV, D); length: scalar or (B,).
    """
    bsz, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    qs = q.reshape(bsz, kv, h // kv, d).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qs, k.float()) / math.sqrt(d)
    mask = (torch.arange(s, device=q.device)[None, :]
            < _lengths(length, bsz, q.device)[:, None])[:, None, None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)),
                    torch.zeros_like(sc))
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = out / p.sum(-1, keepdim=True).clamp(min=1e-20)
    return out.reshape(bsz, h, d).to(q.dtype)


def split_plan(bsz: int, kv: int, s: int, n_sm: int):
    """(n_splits, chunk): enough (split, kv-head, row) blocks to cover about
    two waves of the card's SMs, with chunks of at least MIN_CHUNK."""
    want = -(-2 * n_sm // max(bsz * kv, 1))
    n_splits = max(1, min(want, -(-s // MIN_CHUNK)))
    chunk = max(-(-s // n_splits), 1)
    return -(-s // chunk), chunk


def _check(q, k, v, lengths):
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, lengths))):
        raise ValueError("flash_decode: inputs must lie on one CUDA device")
    bsz, h, d = q.shape
    if k.shape != v.shape or k.ndim != 4 or k.shape[0] != bsz \
            or k.shape[3] != d:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    kv = k.shape[2]
    if h % kv or h // kv > MAX_GROUP or d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: H={h}, KV={kv}, D={d} unsupported")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_decode: q, k and v must share one dtype")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_decode: inputs must be contiguous")


def flash_decode(q, k, v, length):
    """q: (B, H, D); k/v: (B, S, KV, D); length: scalar or (B,) -> (B, H, D).

    Query head h attends KV head h // (H/KV) over positions < length.
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, length)
    bsz, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    lengths = _lengths(length, bsz, q.device)
    _check(q, k, v, lengths)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_splits, chunk = split_plan(bsz, kv, s, n_sm)
    m_part = torch.empty((bsz, h, n_splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((bsz, h, n_splits, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    build.kernels().flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), bsz, s, h, kv, d, n_splits, chunk,
        build.dtype_code(q.dtype), build.stream_handle(q.device))
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

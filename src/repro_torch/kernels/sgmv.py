"""SGMV: segmented LoRA matmul for prefill-sized batches, dense or ragged.

The port of ``repro.kernels.sgmv.sgmv`` and both of its Pallas kernels
(``_grouped_matmul``, sgmv.py:77 dense and :89 ragged).  On a CUDA tensor
``sgmv`` launches the two kernels of ``csrc/sgmv.cu``: a counting sort of
the tokens by adapter (whose plain version is ``segments_plain``) and the
segmented product; on a CPU tensor it runs the plain version,
``ref.sgmv_ref``.  Both keep the TPU kernel's capacity rule
(``ref.sgmv_capacity``): a token past its adapter's capacity gets 0.
"""
from __future__ import annotations

import torch

from . import build
from .bgmv import check_lora_args
from .ref import sgmv_capacity, sgmv_ref


def segments_plain(idx, n: int):
    """Stable sort of the tokens by adapter, in plain PyTorch.

    Returns (perm, seg): perm[p] is the token at sorted position p, and
    seg (N+2,) int32 holds the segment starts, segment N gathering the
    tokens whose id is outside [0, N).  Inside a segment the tokens keep
    their arrival order, so position p - seg[i] is a token's rank among its
    adapter's tokens, the rank the capacity rule reads.
    """
    keys = torch.where((idx >= 0) & (idx < n), idx,
                       torch.full_like(idx, n))
    sorted_keys, perm = torch.sort(keys, stable=True)
    seg = torch.searchsorted(
        sorted_keys, torch.arange(n + 2, dtype=keys.dtype, device=idx.device))
    return perm.to(torch.int32), seg.to(torch.int32)


def segments(idx, n: int):
    """``segments_plain`` through SGMV's sort kernel on a CUDA tensor (the
    kernel ``sgmv`` launches before its product); idx (T,) int32."""
    if idx.device.type == "cpu":
        return segments_plain(idx, n)
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError("segments: idx must be a contiguous (T,) int32")
    perm = torch.empty_like(idx)
    seg = torch.empty(n + 2, dtype=torch.int32, device=idx.device)
    build.kernels().sgmv_segments(idx.data_ptr(), perm.data_ptr(),
                                  seg.data_ptr(), idx.numel(), n,
                                  build.stream_handle(idx.device))
    return perm, seg


def sgmv(x, a, b, idx, scale: float = 1.0, ranks=None):
    """x: (T, d); a: (N, d, r); b: (N, r, o); idx: (T,) int32 -> (T, o).

    Tokens with idx < 0 get a zero delta.  ``ranks`` (N,) int32 makes the
    bank ragged: adapter i uses only its first ranks[i] lanes.
    """
    if x.device.type == "cpu":
        return sgmv_ref(x, a, b, idx, scale, ranks=ranks)
    check_lora_args("sgmv", x, a, b, idx, ranks)
    t, d = x.shape
    n, _, r = a.shape
    o = b.shape[-1]
    perm = torch.empty_like(idx)  # the sort's scratch
    seg = torch.empty(n + 2, dtype=torch.int32, device=x.device)
    y = torch.empty((t, o), dtype=x.dtype, device=x.device)
    build.kernels().sgmv(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(),
        perm.data_ptr(), seg.data_ptr(),
        0 if ranks is None else ranks.data_ptr(), y.data_ptr(), t, d, r, o, n,
        sgmv_capacity(t, n), float(scale), build.dtype_code(x.dtype),
        build.dtype_code(a.dtype), build.stream_handle(x.device))
    sgmv.launches += 1
    return y


sgmv.launches = 0

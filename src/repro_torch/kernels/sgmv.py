"""SGMV: segmented LoRA matmul for prefill-sized batches, dense or ragged.

The port of ``repro.kernels.sgmv.sgmv`` and both of its Pallas kernels
(``_grouped_matmul``, sgmv.py:77 dense and :89 ragged).  On a CUDA tensor
``sgmv`` launches the two kernels of ``csrc/sgmv.cu``: a counting sort of
the tokens by adapter (whose plain version is ``segments_plain``) and the
segmented product; on a CPU tensor it runs the plain version,
``ref.sgmv_ref``.  Both keep the TPU kernel's capacity rule
(``ref.sgmv_capacity``): a token past its adapter's capacity gets 0.  A
prompt cut over sequence ranks keeps the whole prompt's rule: each rank
passes its tokens' whole-prompt arrival ranks (``arrival_ranks``) and the
whole prompt's capacity; a token at or past it takes id -1, which the
kernel already maps to 0, so the same kernel runs.
"""
from __future__ import annotations

import torch

from . import build, cost
from .bgmv import check_lora_args, meta_cost
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


def arrival_ranks(ids, first: int, rows: int, seq: int, lo: int,
                  s_loc: int):
    """Whole-prompt arrival ranks of one rank's piece of a prompt of
    per-request adapter ids ``ids`` (B,) over ``seq`` positions, flattened
    row-major as ``ops.lora_apply`` flattens the piece: rows [first, first
    + rows) of the batch, positions [lo, lo + s_loc).  Token (b, s) of the
    whole prompt is token b * seq + s, so its rank among its adapter's
    tokens is seq * #{b' < b : ids[b'] == ids[b]} + s.  Plain tensor
    operations on ids' device, no host sync.  Returns (rows * s_loc,)
    int32."""
    dev = ids.device
    mine = first + torch.arange(rows, device=dev)
    earlier = (torch.arange(ids.shape[0], device=dev)[None, :]
               < mine[:, None]) & (ids[None, :] == ids[mine][:, None])
    out = seq * earlier.sum(1)[:, None] + lo + \
        torch.arange(s_loc, device=dev)[None, :]
    return out.reshape(-1).to(torch.int32)


def sgmv(x, a, b, idx, scale: float = 1.0, ranks=None, arrival=None,
         cap=None):
    """x: (T, d); a: (N, d, r); b: (N, r, o); idx: (T,) int32 -> (T, o).

    Tokens with idx < 0 get a zero delta.  ``ranks`` (N,) int32 makes the
    bank ragged: adapter i uses only its first ranks[i] lanes.  ``cap`` is
    the capacity (``sgmv_capacity`` of x's token count by default).
    ``arrival`` (T,) int, where given, holds each token's arrival rank in
    a whole prompt of which x is a piece (``arrival_ranks``), and ``cap``
    that prompt's capacity: a token whose arrival rank is at or past it
    takes id -1.  A kept token's rank in x is at most its arrival rank, so
    the capacity rule on x then drops nothing more.
    """
    t = x.shape[0]
    cap = sgmv_capacity(t, a.shape[0]) if cap is None else cap
    if arrival is not None:
        if arrival.shape != idx.shape:
            raise ValueError(f"sgmv: arrival {tuple(arrival.shape)} must "
                             f"match idx {tuple(idx.shape)}")
        idx = torch.where(arrival < cap, idx, -1)
    if x.device.type == "cpu":
        return sgmv_ref(x, a, b, idx, scale, ranks=ranks, cap=cap)
    check_lora_args("sgmv", x, a, b, idx, ranks)
    d = x.shape[1]
    n, _, r = a.shape
    o = b.shape[-1]
    if x.is_meta:
        cost.add("sgmv", meta_cost(x, a, b))
        return torch.empty((t, o), dtype=x.dtype, device=x.device)
    perm = torch.empty_like(idx)  # the sort's scratch
    seg = torch.empty(n + 2, dtype=torch.int32, device=x.device)
    y = torch.empty((t, o), dtype=x.dtype, device=x.device)
    build.kernels().sgmv(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(),
        perm.data_ptr(), seg.data_ptr(),
        0 if ranks is None else ranks.data_ptr(), y.data_ptr(), t, d, r, o, n,
        cap, float(scale), build.dtype_code(x.dtype),
        build.dtype_code(a.dtype), build.stream_handle(x.device))
    sgmv.launches += 1
    return y


sgmv.launches = 0

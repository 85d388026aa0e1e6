"""BGMV: batched-gather LoRA matmul for decode-sized batches.

The port of ``repro.kernels.bgmv.bgmv`` (Pallas, bgmv.py:54).  On a CUDA
tensor ``bgmv`` launches the hand-written kernel in ``csrc/bgmv.cu``; on a
CPU tensor it runs ``bgmv_plain``, the same arithmetic in plain PyTorch;
on ``meta`` it checks its inputs, returns an empty output and adds the
call's cost to the open counter (``cost``), launching nothing.
"""
from __future__ import annotations

import torch

from . import build, cost
from .ref import lora_f32

MAX_RANK = 64  # kMaxRank of csrc/bgmv.cu and csrc/sgmv.cu


def bgmv_plain(x, a, b, idx, scale: float = 1.0):
    """y[t] = scale * x[t] @ A[idx[t]] @ B[idx[t]], ids outside [0, N) -> 0,
    with the kernel's arithmetic (``ref.lora_f32``: h stays f32)."""
    return lora_f32(x, a, b, idx, scale)


def check_lora_args(name, x, a, b, idx, ranks=None):
    """The checks of the LoRA kernels' wrappers (BGMV and SGMV); raises on
    anything the kernels do not take (``meta`` tensors are checked as CUDA
    ones)."""
    tensors = (x, a, b, idx) + (() if ranks is None else (ranks,))
    if not (x.device.type in ("cuda", "meta")
            and all(v.device == x.device for v in tensors)):
        raise ValueError(f"{name}: inputs must lie on one CUDA device")
    t, d = x.shape
    n, da, r = a.shape
    if da != d or b.shape[:2] != (n, r) or idx.shape != (t,):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if ranks is not None and (ranks.shape != (n,)
                              or ranks.dtype != torch.int32):
        raise ValueError(f"{name}: ranks must be int32 of shape (N,)")
    if a.dtype != b.dtype:
        raise TypeError(f"{name}: a is {a.dtype} but b is {b.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, not {idx.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: rank {r} outside [1, {MAX_RANK}]")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def bgmv(x, a, b, idx, scale: float = 1.0):
    """x: (T, d); a: (N, d, r); b: (N, r, o); idx: (T,) int32 -> (T, o).

    Tokens with idx < 0 (base model) get a zero delta.
    """
    if x.device.type == "cpu":
        return bgmv_plain(x, a, b, idx, scale)
    check_lora_args("bgmv", x, a, b, idx)
    t, d = x.shape
    n, _, r = a.shape
    o = b.shape[-1]
    y = torch.empty((t, o), dtype=x.dtype, device=x.device)
    if x.is_meta:
        cost.add("bgmv", meta_cost(x, a, b))
        return y
    build.kernels().bgmv(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(), y.data_ptr(),
        t, d, r, o, n, float(scale), build.dtype_code(x.dtype),
        build.dtype_code(a.dtype), build.stream_handle(x.device))
    bgmv.launches += 1
    return y


bgmv.launches = 0


def meta_cost(x, a, b):
    """The cost of a LoRA kernel's call on ``meta`` inputs (BGMV's and
    SGMV's): every token adapted, min(T, N) adapters read."""
    t, d = x.shape
    n, _, r = a.shape
    return cost.lora_cost(t, d, r, b.shape[-1], min(t, n),
                          x_bytes=x.element_size(), w_bytes=a.element_size())

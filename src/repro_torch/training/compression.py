"""Gradient compression for cross-pod data parallelism (counterpart of
``repro.training.compression``).

``quantized_psum``: an int8 ring all-reduce with one f32 scale per tensor
and local f32 accumulation.  The wire format is int8 plus one f32 scale a
shard, ~3.9x less than an f32 all-reduce, at the cost of a quantization
rounding for each of the other shards.  ``compressed_grad_sync`` applies
it to every gradient with error feedback: the residual that the wire
format lost locally is carried into the next call.

A process group takes the place of the JAX axis name (None: no group, one
shard); the ring is ``sharding.shift``, the port's ``ppermute`` over
``[(i, (i + 1) % n)]``.  Gradients carry no autograd here: both functions
run under ``no_grad``.  Nothing in the training step calls them, as in the
JAX package, whose ``train_lib`` calls the sync optional.

The arithmetic is the JAX source's as written (compression.py:20-59):
the scale is ``max|x| / 127 + 1e-12`` in f32, q is ``x / scale`` rounded
half to even and clipped to [-127, 127], and the sum is divided by the
shard count.  Each divisor is a tensor on x's device, so every division
is an f32 division on the CPU and on the card alike (CUDA multiplies by
the reciprocal of a Python scalar divisor), and ``acc + q * s`` is two
roundings, a product and a sum.  That equals the JAX package run eagerly,
bit for bit.  Under ``jax.jit`` XLA on the CPU departs from it: it turns
the source's ``/ 127.0`` into a product with 1/127 and fuses the ring's
multiply-add (ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models import sharding
from .optimizer import Tensors


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-d f32) of an f32 ``x``: an all-zero x gives scale
    1e-12 and q 0."""
    scale = x.abs().amax() / x.new_full((), 127.0) + x.new_full((), 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def quantized_psum(x: torch.Tensor, group, n_shards: int) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (``n_shards`` ranks, its size) by a
    ring with an int8 wire format: n - 1 steps, each shifting the received
    q and scale on to the next rank (2 (n - 1) ``shift``s in
    ``sharding.COLLECTIVES``) and adding ``q * scale`` to an f32
    accumulator that starts at x.  One shard returns x."""
    import torch.distributed as dist
    size = 1 if group is None else dist.get_world_size(group)
    if n_shards != size:
        raise ValueError(f"n_shards {n_shards} is not the group's size "
                         f"{size}")
    if n_shards == 1:
        return x
    acc = x.float()
    q, s = _quantize(acc)
    for _ in range(n_shards - 1):
        q = sharding.shift(q, group)
        s = sharding.shift(s, group)
        acc = acc + q.float() * s
    return acc


@torch.no_grad()
def compressed_grad_sync(grads: Tensors, group, n_shards: int,
                         residual: Optional[Tensors] = None
                         ) -> Tuple[Tensors, Tensors]:
    """(synced, new residual) of ``grads`` (a dict by name): g32, each
    gradient plus its residual (zeros when ``residual`` is None) in f32,
    summed by ``quantized_psum`` over ``group``, divided by ``n_shards``
    and cast to the gradient's dtype; the new residual is ``g32 - q *
    scale`` of ``_quantize(g32)``, what the wire format lost of it."""
    if residual is None:
        residual = {k: torch.zeros_like(g) for k, g in grads.items()}
    synced, new_residual = {}, {}
    for k, g in grads.items():
        g32 = g.float() + residual[k]
        summed = quantized_psum(g32, group, n_shards) / \
            g32.new_full((), float(n_shards))
        q, s = _quantize(g32)
        synced[k] = summed.to(g.dtype)
        new_residual[k] = g32 - q.float() * s
    return synced, new_residual

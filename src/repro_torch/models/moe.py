"""Top-k mixture-of-experts FFN of the port (counterpart of
``repro.models.moe``).

Functions on tensors, as in the JAX package: ``init_moe`` draws the
parameters, ``apply_moe`` routes each token to its top-k experts through a
fixed-capacity (E, C, d) buffer, runs the SwiGLU experts as batched matrix
products and combines the weighted results; ``apply_moe_ref`` is the
dropless oracle, the plain version the tests and the card check hold
``apply_moe`` against.  Experts may be weight-only int8
(``quantize_experts``), dequantised to the activations' dtype before the
products (``_dequant``).

Expert parallelism follows the JAX ``apply_moe``'s (``axis_name``,
``n_shards``, ``gather``; moe.py:62-147), its axis a process group and
this rank's index on it (``group``, ``index``; ``sharding.RankGroups``):
the rank holds ``e_local`` experts, those from ``index * e_local`` on,
routes every token, dispatches the pairs of its own experts and leaves
the others to their ranks, and the ranks' outputs are summed.  With
``gather`` the tokens are the rank's sequence piece, all-gathered first
(capacity then counts the global tokens) and the sum reduce-scattered
back (the prefill under a prefill plan, and training under a train plan,
where the gather's adjoint sums each rank's gradients of the tokens and
each rank backpropagates 1 / n of the aux loss they all compute alike);
without it they are replicated and the sum is one all-reduce (decode).  Experts
that do not divide over the axis stay whole on every rank (``_fits``):
then rank 0 owns every pair and the others none, as in the JAX package.

Every shape in ``apply_moe`` follows from x's and the parameters' shapes,
and nothing waits for the host (no ``.item()``, ``nonzero``, boolean
masks or data-dependent sizes), so a CUDA graph that captures a decode
step replays its MoE layers.  Kept pairs own distinct (expert, slot)
cells, so the dispatch is a plain indexed write, and the combine sums
each token's k results in a fixed order: no float atomics, and a replay
is bitwise the eager step.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import layers, sharding

def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, device, quant: bool = False,
             place=None) -> Dict[str, torch.Tensor]:
    """The JAX package's distributions (moe.py:22-37): the router (d, E)
    in f32 whatever ``dtype``, the experts' gate and up (E, d, f) and down
    (E, f, d), N(0, 1/fan_in) with fan_in d, d and f; with ``quant`` each
    expert weight is made int8 as it is drawn (``quantize_experts``).
    ``place(name, t)``, where given, turns each tensor into what is kept
    as soon as it is made (under a plan, the rank's piece)."""
    place = place or (lambda name, t: t)
    p = {"router": place("router", layers.dense_init(
        gen, (d_model, n_experts), torch.float32, device))}
    for name, shape, fan_in in (("w_gate", (n_experts, d_model, d_ff), None),
                                ("w_up", (n_experts, d_model, d_ff), None),
                                ("w_down", (n_experts, d_ff, d_model), d_ff)):
        w = layers.dense_init(gen, shape, dtype, device, fan_in)
        if not quant:
            p[name] = place(name, w)
            continue
        w, scale = _quantize(w)
        p[name] = place(name, w)
        p[f"{name}_scale"] = place(f"{name}_scale", scale)
    return p


def _quantize(w: torch.Tensor):
    """One expert weight -> (int8 weight, f16 scale per (expert, output
    column)); see ``quantize_experts``."""
    w = w.float()
    scale = w.abs().amax(-2, keepdim=True) / 127.0 + 1e-8
    return (torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8),
            scale.to(torch.float16))


def quantize_experts(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weight-only int8 experts with one scale per (expert, output column):
    scale = max |w| over the input axis / 127 + 1e-8 in f32, kept as f16;
    w = clip(round(w / scale), -127, 127) as int8 (``torch.round`` rounds
    half to even, as ``jnp.round`` does)."""
    out = {"router": p["router"]}
    for name in ("w_gate", "w_up", "w_down"):
        out[name], out[f"{name}_scale"] = _quantize(p[name])
    return out


def _dequant(p, name: str, like_dtype) -> torch.Tensor:
    """An int8 expert weight times its scale, the product taken in bf16
    (moe.py:54-59), cast to ``like_dtype``; any other weight as it is."""
    w = p[name]
    if w.dtype == torch.int8:
        scale = p[f"{name}_scale"].to(torch.bfloat16)
        return (w.to(torch.bfloat16) * scale).to(like_dtype)
    return w


def _route(p, x, top_k: int):
    """Router probabilities (T, E) in f32, and each token's top-k experts
    (T, k) in descending order with their weights renormalised to 1."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1, sorted=True)
    return probs, weights / weights.sum(-1, keepdim=True), experts


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert (moe.py:99-103): every pair when T*k <= 4096
    (decode steps run dropless), else the capacity-factor bound."""
    if t * top_k <= 4096:
        return t * top_k
    return int(max(-(-t * top_k * capacity_factor // n_experts), 1))


def apply_moe(p, x, *, top_k: int, n_experts: int, capacity_factor: float,
              group=None, index: int = 0, gather: bool = True):
    """x: (T, d) -> (out (T, d) in x's dtype, Switch-style aux loss).

    Pairs are ordered t*k + j; a pair's slot is the number of earlier
    pairs routed to its expert, and a pair whose slot is past the capacity
    is dropped (adds nothing), so the same pairs drop as in the JAX
    package.  Gate and up are f32 products, the SwiGLU is computed in f32,
    the down product takes x's dtype.

    With a ``group`` (expert parallelism; see the module's docstring) ``p``
    holds this rank's experts, ``index`` is the rank's index on the group,
    ``gather`` says whether x is the rank's piece of the tokens (True) or
    all of them (False).  Every rank routes the same tokens (x, or x
    gathered) through the whole router, so the aux loss is the same on
    each rank of the group and the JAX package's ``pmean`` of it over the
    axis is the identity: no collective here.  Where the rank holds every
    expert (no group, a group of one, or rank 0 of experts that do not
    divide) the pairs are not masked.
    """
    e_local = p["w_gate"].shape[0]
    gathered = group is not None and gather
    # each rank sends the gathered tokens through its own experts: their
    # gradients are summed back to the tokens' rank
    x_all = sharding.all_gather(x, group, dim=0, adjoint="sum") \
        if gathered else x
    t, d = x_all.shape
    probs, weights, experts = _route(p, x_all, top_k)
    arange_e = torch.arange(n_experts, device=x.device)
    density = (experts[:, :1] == arange_e).float().mean(0)
    aux = n_experts * (density * probs.mean(0)).sum()
    if gathered:   # the same on each rank, which all backpropagate it
        import torch.distributed as dist
        aux = sharding.scale_grad(aux, 1.0 / dist.get_world_size(group))

    cap = capacity(t, top_k, n_experts, capacity_factor)
    local_e = experts.reshape(-1)                             # (T*k,)
    is_local = None
    if e_local < n_experts or index:    # some pairs are other ranks'
        local_e = local_e - index * e_local
        is_local = (local_e >= 0) & (local_e < e_local)
        local_e = local_e.clamp(0, e_local - 1)
    onehot = local_e[:, None] == arange_e[:e_local]
    if is_local is not None:
        onehot = onehot & is_local[:, None]
    onehot = onehot.to(torch.int32)                           # (T*k, E_loc)
    # exclusive count of earlier pairs on the same local expert
    pos = (onehot.cumsum(0) - onehot).gather(1, local_e[:, None])[:, 0]
    keep = pos < cap
    if is_local is not None:
        keep = keep & is_local
    pos = torch.where(keep, pos, cap)                         # overflow slot
    buf = x.new_zeros((e_local, cap + 1, d))
    xs = x_all[:, None].expand(t, top_k, d).reshape(t * top_k, d)
    buf.index_put_((local_e, pos), xs)  # kept pairs: distinct cells
    buf = buf[:, :cap]

    gate = layers.bmm_f32(buf, _dequant(p, "w_gate", x.dtype))
    up = layers.bmm_f32(buf, _dequant(p, "w_up", x.dtype))
    h = (F.silu(gate) * up).to(x.dtype)
    y = torch.bmm(h, _dequant(p, "w_down", x.dtype))          # (E, C, d)

    y_tok = y[local_e, pos.clamp(max=cap - 1)]
    y_tok = torch.where(keep[:, None], y_tok, 0) * \
        weights.reshape(-1, 1).to(x.dtype)
    out = y_tok.view(t, top_k, d).sum(1)
    if group is None:
        return out, aux
    if gather:
        return sharding.reduce_scatter(out, group, dim=0), aux
    return sharding.all_reduce(out, "sum", group), aux


def apply_moe_ref(p, x, *, top_k: int, n_experts: int):
    """The dropless oracle (moe.py:150-167): each token through each of its
    top-k experts' weights, gathered per token; its products in f32 up to
    the weighted f32 sum."""
    _, weights, experts = _route(p, x, top_k)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(top_k):
        e = experts[:, j]
        gate = layers.bmm_f32(x[:, None], p["w_gate"][e])[:, 0]
        up = layers.bmm_f32(x[:, None], p["w_up"][e])[:, 0]
        h = (F.silu(gate) * up).to(x.dtype)
        y = layers.bmm_f32(h[:, None], p["w_down"][e])[:, 0]
        out = out + y * weights[:, j:j + 1]
    return out.to(x.dtype)

"""Decoder stack of the port (counterpart of ``repro.models.transformer``).

``Model`` is an ``nn.Module`` holding one ``Block`` per layer; the JAX
package stacks each segment's layers on axis 0 and scans them, the port
loops over its layers (``bridge.py`` maps one layout to the other).  The
port builds attention blocks, ``global`` (a cache of ``cache_len`` rows)
and ``local`` (a sliding window over a rolling buffer), with a dense
SwiGLU or GELU MLP or a top-k MoE FFN (``moe.apply_moe``, its experts
optionally int8), RoPE or sinusoidal positions, RMSNorm or
LayerNorm, optional q/k/v biases, tied embeddings and an image-embedding
prefix: the dense and MoE architectures, the global layers' KV caches in
the model's dtype or in int8 with f16 scales (``kv_quant``).  It also
builds the state blocks: ``rglru`` (``RGLRUBlock``: the RG-LRU mixer of
``rglru.py`` and a dense MLP, on conv and lru state caches), the hybrid
recurrentgemma, and ``ssd`` (``SSDBlock``: the Mamba2 mixer of ``ssm.py``,
no MLP, on conv and ssm state caches), the attention-free mamba2.  An
unknown block kind raises ``ValueError``, as in the JAX package.

Three entry points, as in the JAX package:
  * ``train_loss``  — the causal LM loss (chunked CE over the vocab, plus
                      the MoE aux loss), differentiable;
  * ``prefill``     — runs the prompt, emits last-position logits + cache;
  * ``decode_step`` — one token per running request with per-request LoRA
                      adapters (the serving hot path).

Under a decode plan (``Model(cfg, plan=make_plan(cfg, mesh, "decode",
global_batch=B))``, one ``Model`` a rank of a ``DeviceMesh``) each weight
is cut to the rank's piece by ``plan.param_spec`` as it is drawn, so that
a rank holds its pieces and one whole tensor at most, and the step runs
tensor-parallel over the plan's ``model`` axis with explicit collectives,
where the JAX package lets pjit place the ops (``_attend_decode``,
transformer.py:317-360, is its one ``shard_map``): wq/wk/wv are
column-sharded and their heads all-gathered (q and the new K/V are
replicated over the cache axis there too); wo and w_down are row-sharded
and all-reduced; w_gate/w_up column-sharded; the untied unembedding
column-sharded and its logits all-gathered (a tied one reads the
replicated embedding); LoRA is replicated.  The MoE FFN is expert
parallel over the width axis (``moe.apply_moe`` with the width group: the
rank's experts, the tokens replicated, one all-reduce; ``_ffn``,
transformer.py:362-402).  The ``ssd`` and ``rglru`` mixers are
width-tensor-parallel (``ssm.apply_ssd``, ``rglru.apply_rglru`` with
``sharding.WidthShards``: the rank's heads or channels, one all-reduce
after ``w_out``) and so are their states; the rglru block's MLP is cut as
an attention block's.  A global layer's cache is
sequence-sharded over the plan's cache axes and decodes through
``attention.decode_attention_sharded``; a local layer's rolling buffer is
replicated over ``model`` and decodes as without a plan.  Each piece
follows its spec: a width that does not divide stays whole.  The caller
gives ``decode_step`` the rank's rows of the batch and of the adapter ids
(``sharding.shard_tensor``) and the rank's cache (``pad_cache`` of the
prefill under the prefill plan, or ``sharding.shard_cache`` of a whole
cache), and gets the rank's rows of the logits over the whole vocab.

Under a prefill plan (``make_plan(cfg, mesh, "prefill", global_batch=B)``)
the caller gives ``prefill`` the rank's rows of the batch, the whole
prompt, and ``prefill`` cuts the sequence over the plan's sequence axis
(``model``) for the attention families: each rank runs its slice of the
positions, RoPE at their global positions, global layers through
``attention.ring_attention`` and local layers through
``attention.local_attention`` over the sequence group, the MoE FFN with
its tokens gathered over the expert group (``gather``).  The one axis cuts
both the sequence and the weights' width there, so a rank's weight piece
cannot meet another rank's tokens: each weight cut over the axis is
gathered whole at its use (``sharding.gather_whole``; the JAX package's
layout, sharding.py:5-8), and the per-token arithmetic is that of the
model without a plan.  The SSM and hybrid families keep the whole
sequence (no sequence axis) and run width-tensor-parallel as in decode.
SGMV keeps the whole prompt's capacity rule: each rank passes its tokens'
whole-prompt arrival ranks (``sgmv.arrival_ranks``, the adapter ids
gathered over the batch axes).  The prefill returns the last position's
logits on every rank and the rank's cache in the prefill plan's layout;
``pad_cache`` turns it into the rank's piece of the padded cache in the
decode plan's layout.

Under a train plan (``make_plan(cfg, mesh, "train", global_batch=B)``)
``train_loss`` takes the rank's rows of the batch (``batch_rows``) and
returns the whole batch's loss on every rank.  Each weight is cut FSDP
style as it is drawn (``param_spec``: the attention families over
``(data, model)``, the SSM and hybrid families over ``data`` beside
their width cut over ``model``) and gathered at its use: whole for the
attention families, which cut the sequence over ``model`` as the prefill
does (ring and local attention, the MoE's experts over ``model`` with
their tokens gathered), over ``data`` alone for the SSM and hybrid
families, whose mixers, MLPs and attention run width-tensor-parallel as
in decode.  Every collective has its adjoint under autograd
(``sharding``: a gathered weight's is a reduce-scatter, so the rank's
piece gets its whole gradient), each layer is recomputed in backward
where the plan sets ``remat`` (``train_trunk``), and ``sync_grads`` sums
the gradients of the leaves held alike over the ranks that hold
different tokens.  A prefill
or train plan with ``attn_batch_shard`` raises ``NotImplementedError``
(ROADMAP.md item 11e).

The port keeps these JAX behaviours for parity: one scalar ``pos`` for the
whole batch (a 0-d int32 tensor on the model's device, as the JAX
package's traced ``cache["pos"]``); a ``pos`` past a global cache skips
the write; LoRA on q and v only; the vocab padded to a multiple of 256
with the padded logits kept.  Unlike the JAX package, ``decode_step``
updates the cache in place: its KV tensors, its recurrent states and its
``pos``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from . import attention, layers, moe, rglru, ssm
from .config import ModelConfig
from .sharding import (RankGroups, WidthShards, all_gather, all_reduce, copy,
                       gather_whole, local_shape, make_plan, shard_tensor)

#: the block kinds with attention (and a KV cache and LoRA on q and v)
ATTENTION_KINDS = ("global", "local")


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    """The generator weights are drawn from on ``dev``: the device's own,
    a CPU one on ``meta`` (which has none; a draw there allocates
    nothing and gives only a shape)."""
    return torch.Generator(device="cpu" if dev.type == "meta"
                           else dev).manual_seed(seed)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _norm(cfg: ModelConfig, dev) -> nn.ParameterDict:
    """``init_stack_norm`` (transformer.py:626-630): a scale of ones, and
    for LayerNorm a bias of zeros."""
    p = {"scale": _param(torch.ones(cfg.d_model, dtype=cfg.torch_dtype,
                                    device=dev))}
    if cfg.norm != "rmsnorm":
        p["bias"] = _param(torch.zeros(cfg.d_model, dtype=cfg.torch_dtype,
                                       device=dev))
    return nn.ParameterDict(p)


def _dense_mlp(cfg: ModelConfig, dense) -> nn.ParameterDict:
    """``init_mlp`` (layers.py:84-95): w_up and w_down, and w_gate for
    SwiGLU; ``dense(name, shape, fan_in)`` draws weight ``mlp.<name>``."""
    mlp = {"w_up": dense("mlp.w_up", (cfg.d_model, cfg.d_ff)),
           "w_down": dense("mlp.w_down", (cfg.d_ff, cfg.d_model),
                           fan_in=cfg.d_ff)}
    if cfg.mlp == "swiglu":
        mlp["w_gate"] = dense("mlp.w_gate", (cfg.d_model, cfg.d_ff))
    return nn.ParameterDict(mlp)


class _Planned(nn.Module):
    """What a block does under a plan: its parameters' specs, the rank's
    groups, and the row/column products of a dense MLP or output
    projection."""

    #: under a plan, the rank's groups (``sharding.RankGroups``) and the
    #: specs of this layer's parameters by local name; None and {} without
    tp = None
    specs: Dict[str, tuple] = {}

    def shard(self, tp: RankGroups, specs: Dict[str, tuple]) -> None:
        """Take the rank's groups and this layer's parameter specs (by
        local name), as ``Model`` hands them over once it has cut the
        layer's weights."""
        self.tp, self.specs = tp, specs

    def _sharded(self, name: str) -> bool:
        """Whether parameter ``name`` is cut over the plan's mesh."""
        return any(e is not None for e in self.specs.get(name, ()))

    def _width_cut(self, name: str) -> bool:
        """Whether parameter ``name`` is cut over the plan's width axis (a
        product the rank runs on its piece, width-tensor-parallel)."""
        return self.tp is not None and \
            self.tp.plan.cuts_width(self.specs.get(name, ()))

    @property
    def seq_cut(self) -> bool:
        """Whether the plan cuts the activations' sequence (a prefill or
        train plan of an attention family), and so each weight is gathered
        whole at its use (``_w``)."""
        return self.tp is not None and bool(self.tp.plan.seq_axis)

    def _w(self, name: str):
        """Parameter ``name`` as the rank uses it: under a sequence cut the
        whole weight (the rank's piece gathered over the mesh,
        ``gather_whole``); under a train plan without one the rank's width
        piece (its FSDP cut gathered); else the parameter itself."""
        w = self.get_parameter(name)
        if not self._sharded(name):
            return w
        plan = self.tp.plan
        if self.seq_cut:
            return gather_whole(w, self.specs[name], plan)
        if plan.fsdp_axes:
            return gather_whole(w, self.specs[name], plan,
                                axes=plan.fsdp_axes)
        return w

    def _enter(self, h, name: str):
        """h, held alike over the width group, as the input of parameter
        ``name``'s product: its gradient summed over the group where the
        weight is width-cut (``sharding.copy``)."""
        return copy(h, self.tp.width) if self._width_cut(name) else h

    def _down(self, x, name: str, local: bool):
        """x @ parameter ``name`` (wo, mlp.w_down) under a plan: a
        row-sharded weight takes the rank's columns of x (``local``: x
        holds only those, the product of column-sharded weights) and its
        partial products are all-reduced over the width axis; a whole
        weight takes the whole x (gathered if ``local``)."""
        w = self._w(name)
        sharded = self._width_cut(name)
        if local and not sharded:
            x = all_gather(x, self.tp.width, adjoint="slice")
        elif sharded and not local:
            n = w.shape[0]
            x = copy(x, self.tp.width)[..., self.tp.width_index * n:
                                        (self.tp.width_index + 1) * n]
        out = x @ w
        return all_reduce(out, "sum", self.tp.width) if sharded else out

    def _mlp(self, h):
        """The dense MLP, its products cut by their specs under a plan (its
        weights gathered whole under a sequence cut)."""
        if self.tp is None:
            return layers.apply_mlp(self.cfg.mlp, self.mlp, h)
        if self.seq_cut:
            return layers.apply_mlp(self.cfg.mlp, {
                k: self._w(f"mlp.{k}") for k in self.mlp}, h)
        hidden = {k: self._w(f"mlp.{k}") for k in self.mlp if k != "w_down"}
        return self._down(layers.mlp_hidden(self.cfg.mlp, hidden,
                                            self._enter(h, "mlp.w_up")),
                          "mlp.w_down", local=self._width_cut("mlp.w_up"))


class Block(_Planned):
    """One attention layer, ``global`` or ``local`` (``kind``), with a
    dense MLP (``mlp``) or, when ``cfg.n_experts``, an MoE FFN (``moe``:
    router, expert weights and, with ``expert_quant``, int8 experts and
    their f16 scales; ``transformer.py:95-101``).  With ``kv_quant`` a
    global layer keeps its cache in int8 beside f16 scales
    (``_cache_block``, transformer.py:170-178); a local layer's rolling
    buffer stays in the model's dtype, as in the JAX package.
    ``place(name, t)``, where given, turns each weight drawn, by its
    name in the layer, into what the layer keeps (under a plan, the
    rank's piece)."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator,
                 device: torch.device, expert_quant: bool = False,
                 kv_quant: bool = False, place=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.kv_quant = kv_quant and kind == "global"
        #: this layer's cache tensors, under the JAX package's names; K
        #: comes first (``Model.decode_step`` reads its rows there)
        self.cache_keys = (("k", "v", "k_scale", "v_scale") if self.kv_quant
                           else ("k", "v") if kind == "global"
                           else ("k_loc", "v_loc"))
        d, dt = cfg.d_model, cfg.torch_dtype
        hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads

        place = place or (lambda name, t: t)

        def dense(name, shape, fan_in=None):
            return _param(place(name, layers.dense_init(gen, shape, dt,
                                                        device, fan_in)))

        self.norm1 = _norm(cfg, device)
        self.wq = dense("wq", (d, nq * hd))
        self.wk = dense("wk", (d, nkv * hd))
        self.wv = dense("wv", (d, nkv * hd))
        self.wo = dense("wo", (nq * hd, d), fan_in=nq * hd)
        self.norm2 = _norm(cfg, device)
        if cfg.qkv_bias:
            for name, width in (("bq", nq), ("bk", nkv), ("bv", nkv)):
                setattr(self, name, _param(place(name, torch.zeros(
                    width * hd, dtype=dt, device=device))))
        if cfg.n_experts:
            self.moe = nn.ParameterDict({
                k: _param(v) for k, v in moe.init_moe(
                    gen, d, cfg.d_ff, cfg.n_experts, dt, device,
                    quant=expert_quant,
                    place=lambda name, t: place(f"moe.{name}", t)).items()})
        else:
            self.mlp = _dense_mlp(cfg, dense)

    def cache_rows(self, cache_len: int) -> int:
        """Rows of this layer's cache for ``cache_len`` positions: all of
        them for a global layer, at most the window for a local one."""
        if self.kind == "global":
            return cache_len
        return min(self.cfg.local_window, cache_len)

    def cache_kv(self, cache):
        """This layer's cache tensors: (K, V), and with ``kv_quant`` their
        scales after them."""
        return tuple(cache[name] for name in self.cache_keys)

    def init_cache(self, batch: int, cache_len: int, device):
        """This layer's zero cache for ``cache_len`` positions: K/V of
        (B, rows, KV, D) in the model's dtype, or int8 beside (B, rows, KV)
        f16 scales."""
        cfg = self.cfg
        shape = (batch, self.cache_rows(cache_len), cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        kv_dtype = torch.int8 if self.kv_quant else cfg.torch_dtype
        out = {name: torch.zeros(shape, dtype=kv_dtype, device=device)
               for name in self.cache_keys[:2]}
        for name in self.cache_keys[2:]:
            out[name] = torch.zeros(shape[:3], dtype=torch.float16,
                                    device=device)
        return out

    def slot_key(self, cache):
        """(kind, rows): the layers of one kind and cache length share one
        ``CacheSlot`` a step."""
        return self.kind, self.cache_kv(cache)[0].shape[1]

    def slot(self, pos: torch.Tensor, rows: int) -> attention.CacheSlot:
        """The step's ``CacheSlot`` in this layer's cache of ``rows`` rows
        (under a plan a global layer's is the rank's slice of the
        sequence-sharded cache)."""
        if self.kind == "global":
            if self.tp is not None:
                return attention.CacheSlot.shard(pos, rows,
                                                 self.tp.cache_index)
            return attention.CacheSlot.at(pos, rows)
        return attention.CacheSlot.rolling(pos, rows)

    def pad_cache(self, cache, extra: int, decode=None):
        """This layer's prefill cache with room for ``extra`` more
        positions (``Model.pad_cache``): a global layer's tensors get
        ``extra`` rows of zeros, a rolling buffer grows up to the window.
        Under a prefill plan (``decode``: the decode plan whose layout the
        result takes) a global layer's slices are gathered whole over the
        prefill plan's cache axes, padded, and cut to the rank's slice
        under the decode plan's cache axes; the replicated rolling buffer
        is padded as without a plan."""
        if decode is not None and self.kind == "global":
            n = decode.n_cache
            index = decode.coordinate(decode.cache_seq_axes)
            out = {}
            for name in self.cache_keys:
                t = all_gather(cache[name], self.tp.cache, dim=1)
                rows = t.shape[1] + extra
                if rows % n:
                    raise ValueError(
                        f"{rows} cache rows do not divide over the decode "
                        f"plan's {decode.cache_seq_axes} ({n})")
                t = torch.cat([t, t.new_zeros((t.shape[0], extra)
                                              + t.shape[2:])], dim=1)
                out[name] = t[:, index * (rows // n):
                              (index + 1) * (rows // n)].contiguous()
            return out
        rows = self.cache_kv(cache)[0].shape[1]
        grow = self.cache_rows(rows + extra) - rows
        return {name: torch.cat([cache[name], cache[name].new_zeros(
            (cache[name].shape[0], grow) + cache[name].shape[2:])], dim=1)
            for name in self.cache_keys}

    def _attn_proj(self, lora_p, h, name, adapter_idx, cut=None):
        """h's q, k or v (``name``), with its LoRA delta; ``cut`` ({"arrival",
        "tokens"} or None): h is a piece of a prompt cut over ranks
        (``ops.lora_apply``)."""
        if self.tp is None:
            out = h @ getattr(self, f"w{name}")
        elif self.seq_cut:
            out = h @ self._w(f"w{name}")
        else:
            out = self._enter(h, f"w{name}") @ self._w(f"w{name}")
            if self._width_cut(f"w{name}"):   # the rank's heads -> all
                out = all_gather(out, self.tp.width, adjoint="slice")
        if self.cfg.qkv_bias:
            out = out + getattr(self, f"b{name}")
        if lora_p is not None and f"a_{name}" in lora_p and \
                adapter_idx is not None:
            delta = ops.lora_apply(h, lora_p[f"a_{name}"],
                                   lora_p[f"b_{name}"], adapter_idx,
                                   **(cut or {}))
            out = out + delta.to(out.dtype)
        return out

    def _qkv(self, x, lora_p, adapter_idx, positions, cut=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        h = layers.apply_norm(cfg.norm, self.norm1, x)
        q = self._attn_proj(lora_p, h, "q", adapter_idx, cut)
        k = self._attn_proj(lora_p, h, "k", adapter_idx, cut)
        v = self._attn_proj(lora_p, h, "v", adapter_idx, cut)
        q = q.reshape(b, s, cfg.n_heads, hd)
        k = k.reshape(b, s, cfg.n_kv_heads, hd)
        if cfg.pos_emb == "rope":
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v.reshape(b, s, cfg.n_kv_heads, hd)

    def _ffn(self, h, aux: bool = True):
        """The MLP, or the MoE FFN over the b*s tokens (``_ffn``,
        transformer.py:362-402), and its aux loss (0.0 for the MLP;
        ``prefill`` and ``decode`` drop it, as the JAX ones do).  Under a
        plan the experts are parallel over the plan's width axis (its
        sequence axis without one), the tokens gathered over it first if
        they are sequence-sharded (a train plan's FSDP cut of the experts
        gathered, their expert cut kept).  The aux loss is then the same on each
        rank of the expert group (``apply_moe``) and is averaged over the
        batch axes; with ``aux`` False (the decode drops it) that
        all-reduce is skipped and the aux loss is the rank's."""
        cfg = self.cfg
        if not cfg.n_experts:
            return self._mlp(h), 0.0
        b, s, d = h.shape
        ep, experts = {}, self.moe
        if self.tp is not None:
            plan = self.tp.plan
            ep = {"group": self.tp.ep, "index": self.tp.ep_index,
                  "gather": bool(plan.seq_axis)}
            # a train plan's FSDP cut gathered; the expert cut kept
            keep = plan.width_axis or plan.seq_axis
            fsdp = tuple(a for a in plan.fsdp_axes if a != keep)
            if fsdp:
                experts = {k: gather_whole(v, self.specs[f"moe.{k}"], plan,
                                           axes=fsdp)
                           for k, v in self.moe.items()}
        out, a = moe.apply_moe(experts, h.reshape(b * s, d),
                               top_k=cfg.top_k, n_experts=cfg.n_experts,
                               capacity_factor=cfg.capacity_factor, **ep)
        if ep and aux and self.tp.batch is not None:
            a = all_reduce(a, "sum", self.tp.batch) / self.tp.n_batch
        return out.reshape(b, s, d), a

    def _residual(self, x, attn_out, aux: bool = True):
        """(x after the output projection and the FFN, the FFN's aux
        loss; ``aux`` False: the decode's, which drops it)."""
        b, s = x.shape[:2]
        if self.seq_cut:
            x = x + attn_out.reshape(b, s, -1) @ self._w("wo")
        elif self.tp is not None:
            x = x + self._down(attn_out.reshape(b, s, -1), "wo", local=False)
        else:
            x = x + attn_out.reshape(b, s, -1) @ self.wo
        h = layers.apply_norm(self.cfg.norm, self.norm2, x)
        f, a = self._ffn(h, aux)
        return x + f, a

    def _attend(self, q, k, v):
        """Causal self-attention over the whole sequence: a global layer's,
        or a local layer's within its window; under a sequence cut over
        the plan's sequence group (the rank's slice of the queries)."""
        scale = 1.0 / math.sqrt(self.cfg.resolved_head_dim)
        ring = {}
        if self.seq_cut:
            ring = {"group": self.tp.seq, "index": self.tp.seq_index,
                    "n_shards": self.tp.n_seq}
        if self.kind == "global":
            return attention.ring_attention(q, k, v, scale=scale, **ring)
        return attention.local_attention(q, k, v, scale=scale,
                                         window=self.cfg.local_window, **ring)

    def train_forward(self, x, positions):
        """x: (B, S, d) -> (x, the MoE aux loss): the layer with no cache, as
        the JAX package's train mode runs it (``_apply_block``,
        transformer.py:398-405)."""
        q, k, v = self._qkv(x, None, None, positions)
        return self._residual(x, self._attend(q, k, v))

    def prefill(self, x, lora_p, adapter_idx, positions, cut=None):
        """x: (B, S, d) -> (x, cache): a global layer's {"k", "v"} of
        (B, S, KV, D) (with ``kv_quant`` int8, beside their (B, S, KV) f16
        "k_scale", "v_scale": quantized over D per (token, head), after the
        attention, which reads the unquantized K/V), a local layer's
        rolling {"k_loc", "v_loc"} of (B, min(window, S), KV, D)
        (``_prefill_cache``, transformer.py:297-315).  ``cut``: see
        ``_attn_proj``.

        Under a plan the cache is the rank's piece in the plan's layout
        (``cache_specs``): a global layer's rows are the rank's slice of the
        sequence (its own under a sequence cut); a local layer's rolling
        buffer is replicated, so under a sequence cut every rank gathers
        the sequence's last rows from the ranks that hold them."""
        q, k, v = self._qkv(x, lora_p, adapter_idx, positions, cut)
        x, _ = self._residual(x, self._attend(q, k, v), aux=False)
        n = self.tp.n_seq if self.seq_cut else 1
        if self.kind == "global":
            if self.tp is not None and not self.seq_cut:
                k, v = self._cache_slice(k), self._cache_slice(v)
            if self.kv_quant:
                (k, ks), (v, vs) = (attention.quantize_kv(k),
                                    attention.quantize_kv(v))
                return x, dict(zip(self.cache_keys, (k, v, ks, vs)))
            return x, dict(zip(self.cache_keys, (k, v)))
        s = k.shape[1] * n
        w = self.cache_rows(s)
        shift = (s - w) % w   # position p lands in row p % w
        if n > 1:   # each rank's last min(w, S_loc) rows, in rank order
            m = min(w, k.shape[1])
            kv = all_gather(torch.stack([k[:, -m:], v[:, -m:]]), self.tp.seq,
                            dim=2)
            k, v = kv[0], kv[1]

        def to_rolling(t):
            return torch.roll(t[:, t.shape[1] - w:], shifts=shift, dims=1)
        return x, dict(zip(self.cache_keys, (to_rolling(k), to_rolling(v))))

    def _cache_slice(self, t):
        """The rank's rows of a whole (B, S, ...) global-layer tensor under
        the plan's cache axes."""
        n = self.tp.plan.n_cache
        if t.shape[1] % n:
            raise ValueError(f"{t.shape[1]} cache rows do not divide over "
                             f"{self.tp.plan.cache_seq_axes} ({n})")
        rows = t.shape[1] // n
        return t[:, self.tp.cache_index * rows:
                 (self.tp.cache_index + 1) * rows].contiguous()

    def decode(self, x, lora_p, adapter_idx, cache, slot):
        """x: (B, 1, d); slot: the step's ``attention.CacheSlot`` for this
        layer's cache, its position on x's device; the cache is updated in
        place."""
        positions = slot.pos.reshape(1, 1).expand(x.shape[0], 1)
        q, k, v = self._qkv(x, lora_p, adapter_idx, positions)
        kc, vc, *scales = self.cache_kv(cache)
        if self.tp is not None and self.kind == "global":
            out = attention.decode_attention_sharded(
                q[:, 0], kc, vc, k[:, 0], v[:, 0], slot, *scales,
                group=self.tp.cache)
        else:
            out = attention.decode_attention(q[:, 0], kc, vc, k[:, 0],
                                             v[:, 0], slot, *scales)
        return self._residual(x, out[:, None], aux=False)[0]


class _StateBlock(_Planned):
    """A layer whose cache is a recurrent state (``RGLRUBlock``,
    ``SSDBlock``): no KV cache, no positions, no LoRA (``init_lora`` gives
    it no bank).  Prefill returns the states after the prompt; decode
    writes them in place.  A subclass names its ``cache_keys`` and gives
    ``init_cache`` and ``_forward(x, *states)`` -> (x, states).

    Under a plan the mixer is width-tensor-parallel: ``shards`` names the
    mixer's leaves the plan cuts (``sharding.WidthShards``).  The mixer's
    code reads one leaf of each of its ``WIDTH_GROUPS`` for the cut of
    all: the leaves of a group have one cut dimension, so ``_fits`` cuts
    them all or none."""

    kv_quant = False   # no KV cache
    shards = None
    #: the mixer's ParameterDict, and its leaves (parameters, and states
    #: as ``cache.<name>``) that share a cut dimension
    MIXER = ""
    WIDTH_GROUPS: tuple = ()

    def shard(self, tp: RankGroups, specs: Dict[str, tuple]) -> None:
        super().shard(tp, specs)
        plan = tp.plan
        prefix = self.MIXER + "."
        names = {n[len(prefix):] for n, sp in specs.items()
                 if n.startswith(prefix) and plan.cuts_width(sp)}
        whole = self.init_cache(1, 1, "meta")
        names |= {f"cache.{n}" for n, t in whole.items()
                  if plan.cuts_width(plan.cache_spec((n,), tuple(t.shape)))}
        for group in self.WIDTH_GROUPS:
            if len({n in names for n in group}) > 1:
                raise AssertionError(f"{self.kind}: the plan cuts some of "
                                     f"{group} and not the others")
        self.shards = WidthShards(tp.width, tp.width_index, plan.n_width,
                                  frozenset(names))

    def slot_key(self, cache):
        return None   # no CacheSlot: the states have no positions

    def _mixer(self):
        """The mixer's parameters as the rank uses them: under a train
        plan each one's FSDP cut gathered (``_w``), its width cut kept."""
        p = getattr(self, self.MIXER)
        if self.tp is None or not self.tp.plan.fsdp_axes:
            return p
        return {k: self._w(f"{self.MIXER}.{k}") for k in p}

    def pad_cache(self, cache, extra: int, decode=None):
        """The states, copied: they do not grow (JAX's ``pad_cache``
        passes them through, transformer.py:606-623), and a prefill plan
        and a decode plan cut them alike."""
        return {name: cache[name].clone() for name in self.cache_keys}

    def prefill(self, x, lora_p, adapter_idx, positions, cut=None):
        """x: (B, S, d) -> (x, the states after the prompt); ``lora_p``,
        ``adapter_idx``, ``positions`` and ``cut`` unused.  Under a plan
        the whole sequence, the mixer width-tensor-parallel as in
        decode."""
        x, states = self._forward(x)
        return x, dict(zip(self.cache_keys, states))

    def train_forward(self, x, positions):
        """x: (B, S, d) -> (x, 0.0): the prefill form, whose states are new
        tensors (nothing is written in place); ``positions`` unused."""
        return self._forward(x)[0], 0.0

    def decode(self, x, lora_p, adapter_idx, cache, slot):
        """x: (B, 1, d); the states are updated in place; ``slot`` is
        None."""
        return self._forward(x, *(cache[k] for k in self.cache_keys))[0]


class RGLRUBlock(_StateBlock):
    """One RG-LRU layer (kind ``rglru``; ``_apply_block``,
    transformer.py:429-446): x + mixer(norm1(x)), then x + MLP(norm2(x)).
    Its cache is the mixer's state, ``conv`` (B, conv_width - 1, W) in the
    model's dtype and ``lru`` (B, W) f32 (``_cache_block``, :192-196)."""

    cache_keys = ("conv", "lru")
    MIXER = "rglru"
    WIDTH_GROUPS = (("w_x", "w_gate", "conv_w", "w_out", "cache.conv",
                     "cache.lru"), ("w_a", "w_i"))

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 device: torch.device, place=None):
        super().__init__()
        self.cfg, self.kind = cfg, "rglru"
        dt = cfg.torch_dtype
        place = place or (lambda name, t: t)

        def dense(name, shape, fan_in=None):
            return _param(place(name, layers.dense_init(gen, shape, dt,
                                                        device, fan_in)))

        self.norm1 = _norm(cfg, device)
        self.rglru = nn.ParameterDict({
            k: _param(v) for k, v in rglru.init_rglru(
                gen, cfg, dt, device,
                place=lambda name, t: place(f"rglru.{name}", t)).items()})
        self.norm2 = _norm(cfg, device)
        self.mlp = _dense_mlp(cfg, dense)

    def init_cache(self, batch: int, cache_len: int, device):
        """Zero states, whatever ``cache_len``."""
        w = rglru.lru_width(self.cfg)
        return {"conv": torch.zeros((batch, self.cfg.conv_width - 1, w),
                                    dtype=self.cfg.torch_dtype,
                                    device=device),
                "lru": torch.zeros((batch, w), dtype=torch.float32,
                                   device=device)}

    def _forward(self, x, conv_state=None, lru_state=None):
        h = layers.apply_norm(self.cfg.norm, self.norm1, x)
        out, states = rglru.apply_rglru(self._mixer(), h,
                                        conv_state=conv_state,
                                        lru_state=lru_state,
                                        shards=self.shards)
        x = x + out
        h = layers.apply_norm(self.cfg.norm, self.norm2, x)
        return x + self._mlp(h), states


class SSDBlock(_StateBlock):
    """One Mamba2 layer (kind ``ssd``; ``_apply_block``,
    transformer.py:415-428): x + mixer(norm1(x)), no MLP.  Its cache is
    the mixer's state, ``conv_x`` (B, conv_width - 1, d_inner) and
    ``conv_bc`` (B, conv_width - 1, 2 * state) in the model's dtype and
    ``ssm`` (B, H, P, state) f32 (``_cache_block``, :186-191).  Prefill
    starts from zero states, as in the JAX package."""

    cache_keys = ("conv_x", "conv_bc", "ssm")
    MIXER = "ssd"
    WIDTH_GROUPS = (("w_x", "w_z", "conv_x", "w_out", "cache.conv_x"),
                    ("w_dt", "cache.ssm"))

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 device: torch.device, place=None):
        super().__init__()
        self.cfg, self.kind = cfg, "ssd"
        place = place or (lambda name, t: t)
        self.norm1 = _norm(cfg, device)
        self.ssd = nn.ParameterDict({
            k: _param(v) for k, v in ssm.init_ssd(
                gen, cfg, cfg.torch_dtype, device,
                place=lambda name, t: place(f"ssd.{name}", t)).items()})

    def init_cache(self, batch: int, cache_len: int, device):
        """Zero states, whatever ``cache_len``."""
        d_inner, n_heads, hd, state = ssm.ssd_dims(self.cfg)
        rows, dt = self.cfg.conv_width - 1, self.cfg.torch_dtype
        return {"conv_x": torch.zeros((batch, rows, d_inner), dtype=dt,
                                      device=device),
                "conv_bc": torch.zeros((batch, rows, 2 * state), dtype=dt,
                                       device=device),
                "ssm": torch.zeros((batch, n_heads, hd, state),
                                   dtype=torch.float32, device=device)}

    def _forward(self, x, conv_x=None, conv_bc=None, ssm_state=None):
        h = layers.apply_norm(self.cfg.norm, self.norm1, x)
        out, states = ssm.apply_ssd(self._mixer(), h, self.cfg,
                                    conv_state=(conv_x, conv_bc),
                                    ssm_state=ssm_state, shards=self.shards)
        return x + out, states


def _block(cfg: ModelConfig, kind: str, gen, dev, expert_quant: bool,
           kv_quant: bool, place=None) -> nn.Module:
    """Layer ``kind``'s block (``_init_block``, transformer.py:89-116).
    Each block hands its weights (attention, MLP, experts, mixer) to
    ``place`` as it draws them; the norms are cut after
    (``Model._shard``)."""
    if kind in ATTENTION_KINDS:
        return Block(cfg, kind, gen, dev, expert_quant, kv_quant, place)
    if kind == "rglru":
        return RGLRUBlock(cfg, gen, dev, place)
    if kind == "ssd":
        return SSDBlock(cfg, gen, dev, place)
    raise ValueError(kind)


class Model(nn.Module):
    """A decoder with per-request multi-adapter LoRA on q and v.

    ``device`` defaults to CUDA and raises without it; weights are drawn
    from a ``torch.Generator`` seeded with ``seed`` (the JAX package's
    distributions, not its values: ``bridge.load_params`` copies those).
    Layer i's kind is ``cfg.layer_kinds[i]``: the block pattern repeated,
    the JAX package's segment order (``build_segments``).
    ``expert_quant`` keeps an MoE model's experts in int8, the counterpart
    of ``ShardingPlan.expert_quant`` (sharding.py:38); ``kv_quant`` keeps
    the global layers' KV caches in int8 with f16 scales, the counterpart
    of ``ShardingPlan.kv_quant`` (sharding.py:37); a ``plan`` sets either
    too.  A ``plan`` with a mesh (a train, prefill or decode plan,
    ``sharding.make_plan``) makes this the model of one rank: each weight
    drawn whole from the same generator as without a plan and cut at once
    to the rank's piece (``param_specs``), its training, prefill or decode
    sharded (see the module's docstring); every rank of the mesh builds its
    ``Model`` together (the plan's groups are made then).  ``plan=None``,
    or a plan without a mesh, is the one-device model.  ``remat`` is the
    plan's (a plan without a mesh's too; False without a plan): whether
    ``train_trunk`` recomputes each layer in backward.
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0,
                 expert_quant: bool = False, kv_quant: bool = False,
                 plan=None):
        super().__init__()
        if plan is not None:
            kv_quant = kv_quant or plan.kv_quant
            expert_quant = expert_quant or plan.expert_quant
        self.cfg = cfg
        self.kv_quant = kv_quant
        self.remat = bool(plan is not None and plan.remat)
        self.device = resolve_device(device)
        self.plan = self.tp = None
        self.param_specs: Dict[str, tuple] = {}
        if plan is not None and plan.mesh is not None:
            _check_plan(cfg, plan)
            self.plan = plan
        dev, dt = self.device, cfg.torch_dtype
        gen = _generator(dev, seed)
        v, d = layers.pad_vocab(cfg.vocab_size), cfg.d_model
        embed = {"embed": _param(self._place(
            "embed.embed", layers.embed_init(gen, (v, d), dt, dev)))}
        if not cfg.tie_embeddings:   # tied: the unembedding reads embed.T
            embed["unembed"] = _param(self._place(
                "embed.unembed", layers.dense_init(gen, (d, v), dt, dev)))
        self.embed = nn.ParameterDict(embed)
        self.final_norm = _norm(cfg, dev)
        self.layers = nn.ModuleList(
            _block(cfg, kind, gen, dev, expert_quant, kv_quant,
                   lambda name, t, i=i: self._place(f"layers.{i}.{name}", t))
            for i, kind in enumerate(cfg.layer_kinds))
        if self.plan is not None:
            self._shard()

    def _place(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``name`` as drawn whole (``t``) -> the rank's piece
        by its spec, taken on the whole shape; ``t`` without a plan."""
        if self.plan is None:
            return t
        spec = self.plan.param_spec(tuple(name.split(".")), tuple(t.shape))
        self.param_specs[name] = spec
        return shard_tensor(t, spec, self.plan)

    def _shard(self) -> None:
        """Cut the parameters not cut as they were drawn (the norms'
        scales) and hand the blocks the rank's groups."""
        for name, p in self.named_parameters():
            if name not in self.param_specs:
                p.data = self._place(name, p.data)
        self.param_specs = {name: self.param_specs[name]
                            for name, _ in self.named_parameters()}
        self.tp = RankGroups(self.plan)
        for i, blk in enumerate(self.layers):
            prefix = f"layers.{i}."
            blk.shard(self.tp, {n[len(prefix):]: sp for n, sp in
                                self.param_specs.items()
                                if n.startswith(prefix)})

    def _w(self, name: str):
        """Model-level parameter ``name`` (``embed.embed``,
        ``embed.unembed``) as the rank uses it: under a train plan its
        FSDP cut gathered, all of it under a sequence cut, its width cut
        kept otherwise (``_Planned._w``); else the parameter."""
        w = self.get_parameter(name)
        spec = self.param_specs.get(name, ())
        if self.plan is None or not self.plan.fsdp_axes or \
                all(e is None for e in spec):
            return w
        axes = None if self.plan.seq_axis else self.plan.fsdp_axes
        return gather_whole(w, spec, self.plan, axes=axes)

    def batch_rows(self, batch):
        """This rank's rows of a whole batch ({"tokens", "img_embeds"?}),
        cut over the plan's batch axes (``shard_tensor``); the batch itself
        without a plan."""
        if self.plan is None:
            return batch
        return {k: shard_tensor(v, (self.plan.dp(),) + (None,) * (v.ndim - 1),
                                self.plan)
                for k, v in batch.items() if v is not None}

    @torch.no_grad()
    def sync_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Under a train plan, finish a backward's gradients of the rank's
        parameters ({name: gradient}, such as each one's ``.grad``) in
        place: each is summed over the token axes its spec does not cut
        (``ShardingPlan.grad_sum_axes``: a replicated leaf over the batch
        axes, and over the sequence axis where the plan cuts one; never
        over the width axis, whose ranks hold the same tokens), so that
        every rank holds the gradient of its piece of the whole loss.  The
        FSDP pieces come out of their gathers' reduce-scatters whole.
        Nothing without a plan."""
        if self.plan is None:
            return
        for name, g in grads.items():
            axes = self.plan.grad_sum_axes(self.param_specs[name])
            if axes:
                all_reduce(g, "sum", self.plan.group(axes))

    def _planned(self, what: str, mode: str) -> None:
        """Raise unless the model has no plan or a ``mode`` plan."""
        if self.plan is not None and self.plan.mode != mode:
            raise ValueError(
                f"{what} under a {self.plan.mode} plan: build the model under "
                f"make_plan(cfg, mesh, {mode!r}, ...)")

    def init_lora(self, n_adapters: int, rank: int,
                  seed: int = 0) -> Dict[str, Any]:
        """Per-adapter LoRA banks on the configured targets (q, v):
        {"layers": [{"a_q": (N, d, r), "b_q": (N, r, o), ...}, ...]}; a
        layer without attention (rglru, ssd) gets none, {} (the JAX
        package's placeholder ``{"_": ...}``, transformer.py:144-156)."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.torch_dtype
        gen = _generator(dev, seed)
        hd = cfg.resolved_head_dim
        out_dims = {"q": cfg.n_heads * hd, "v": cfg.n_kv_heads * hd}
        banks: List[Dict[str, torch.Tensor]] = []
        for blk in self.layers:
            p = {}
            banks.append(p)
            if blk.kind not in ATTENTION_KINDS:
                continue
            for t in cfg.lora_targets:
                p[f"a_{t}"] = layers.dense_init(
                    gen, (n_adapters, cfg.d_model, rank), dt, dev)
                p[f"b_{t}"] = layers.dense_init(
                    gen, (n_adapters, rank, out_dims[t]), dt, dev,
                    fan_in=rank)
        return {"layers": banks}

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, Any]:
        """A global layer's {"k", "v"} of ``cache_len`` rows (with
        ``kv_quant`` int8, and "k_scale", "v_scale" in f16), a local
        layer's rolling {"k_loc", "v_loc"} of min(window, cache_len) rows,
        an rglru layer's {"conv", "lru"} states, an ssd layer's
        {"conv_x", "conv_bc", "ssm"} states (``_cache_block``,
        transformer.py:163-197).  Under a plan ``batch`` and ``cache_len``
        are the whole batch and cache, and the tensors are the rank's
        pieces of them (``cache_specs``)."""
        pos = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.plan is None:
            return {"pos": pos,
                    "layers": [blk.init_cache(batch, cache_len, self.device)
                               for blk in self.layers]}
        whole = {"pos": pos, "layers": [blk.init_cache(batch, cache_len,
                                                       "meta")
                                        for blk in self.layers]}
        specs = self.plan.cache_specs(whole)["layers"]
        return {"pos": pos, "layers": [
            {name: torch.zeros(local_shape(t.shape, sp[name], self.plan),
                               dtype=t.dtype, device=self.device)
             for name, t in layer.items()}
            for layer, sp in zip(whole["layers"], specs)]}

    def _lora_layers(self, lora):
        return lora["layers"] if lora is not None else [None] * len(self.layers)

    def _logits(self, x):
        x = layers.apply_norm(self.cfg.norm, self.final_norm, x)
        logits = layers.unembed(self.embed, x, self.cfg.logit_softcap)
        if any(e is not None for e in self.param_specs.get("embed.unembed",
                                                            ())):
            logits = all_gather(logits, self.tp.width)   # the vocab's pieces
        return logits

    def _seq_slice(self, s: int):
        """(the ranks the plan cuts a sequence of ``s`` positions over, the
        first position of this rank's slice): (1, 0) without a sequence
        cut; a length the axis does not divide raises ``ValueError``, as
        the JAX package's ``shard_map`` does."""
        n = self.tp.n_seq if self.tp is not None else 1
        if s % n:
            raise ValueError(
                f"{s} positions under a plan that cuts the sequence over "
                f"{self.plan.seq_axis!r} ({n} ranks): the length must "
                "divide over the axis")
        return n, (self.tp.seq_index * (s // n) if n > 1 else 0)

    def _embed_slice(self, tokens, img_embeds=None, embed=None):
        """(x, positions, n, lo): token embeddings after the image
        embeddings, if any, plus the sinusoidal positions (``_embed_in``,
        transformer.py:504-513), of this rank's slice of the I + T
        positions only, [lo, lo + S_loc) of ``n`` slices (``_seq_slice``;
        all of them without a sequence cut), the tokens and image
        embeddings cut before the lookup in ``embed`` (the parameter by
        default); and the slice's global positions (B, S_loc)."""
        n_img = 0 if img_embeds is None else img_embeds.shape[1]
        n, lo = self._seq_slice(n_img + tokens.shape[1])
        hi = lo + (n_img + tokens.shape[1]) // n
        x = layers.embed_tokens(self.embed["embed"] if embed is None
                                else embed,
                                tokens[:, max(lo - n_img, 0):
                                       max(hi - n_img, 0)])
        if img_embeds is not None and lo < n_img:
            x = torch.cat([img_embeds[:, lo:hi].to(x.dtype), x], dim=1)
        positions = torch.arange(lo, hi, device=x.device)[None]
        if self.cfg.pos_emb == "sinusoidal":
            x = x + layers.sinusoidal_pos_emb(
                positions, self.cfg.d_model).to(x.dtype)
        return x, positions.expand(x.shape[0], hi - lo), n, lo

    def train_trunk(self, tokens, img_embeds=None):
        """tokens: (B, T) -> (the final norm's output (B, I + T, d), the
        MoE aux loss summed over the layers, f32): every layer in its
        no-cache form (``_run_segments`` in train mode, transformer.py:
        449-497).

        Under a train plan: the rank's rows of the batch over the whole
        sequence; an attention family's rank runs its slice of the I + T
        positions (the sequence cut over the plan's sequence axis, as the
        prefill cuts it) and gets that slice of the output.

        With ``remat`` (the plan's, ``jax.checkpoint`` of the segment body
        where ``plan.remat`` is set, transformer.py:481-482) and grad
        enabled, each layer is recomputed in backward
        (``torch.utils.checkpoint``): autograd keeps only its input, and
        under a train plan its weights are gathered again in backward,
        every rank issuing its collectives in the same order in the forward
        and in the recompute.  Without it autograd keeps each layer's
        activations for backward and, under a train plan, each gathered
        FSDP weight too, gathered once."""
        self._planned("train_trunk", "train")
        x, positions, _, _ = self._embed_slice(tokens, img_embeds,
                                               self._w("embed.embed"))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.layers:
            if self.remat and torch.is_grad_enabled():
                x, a = checkpoint(block.train_forward, x, positions,
                                  use_reentrant=False)
            else:
                x, a = block.train_forward(x, positions)
            aux = aux + a
        return layers.apply_norm(self.cfg.norm, self.final_norm, x), aux

    def train_loss(self, batch):
        """batch: {"tokens": (B, T+1) int, "img_embeds": (B, I, d)?} on the
        model's device (numpy is taken too).  The mean next-token cross
        entropy of ``tokens[:, :-1]`` against ``tokens[:, 1:]`` (the image
        positions dropped), plus, for an MoE model, 0.01 * aux / n_layers:
        the JAX ``train_loss`` (transformer.py:515-529), which hard-codes
        0.01 and never reads ``TrainConfig.aux_weight``.  Differentiable;
        raises ``ValueError`` on a model with int8 parameters
        (``expert_quant``), which autograd cannot differentiate.

        Under a train plan ``batch`` holds the rank's rows
        (``batch_rows``) and the loss is the whole batch's, the same on
        every rank: the rank's chunked cross entropy over its rows and
        positions (chunks sized on them, as JAX sizes them on a shard's),
        averaged over the ranks that hold different tokens (the batch
        axes, and the sequence axis of an attention family) by one
        all-reduce whose gradient passes through; the MoE aux loss is
        averaged over the batch axes (``Block._ffn``).  Each rank
        backpropagates it; ``sync_grads`` then finishes the replicated
        leaves' gradients."""
        ints = [n for n, p in self.named_parameters()
                if not p.is_floating_point()]
        if ints:
            raise ValueError(
                f"train_loss: {len(ints)} parameters are not floating point "
                f"(int8 experts, expert_quant=True, e.g. {ints[0]}); their "
                "gradients do not exist")
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        img = batch.get("img_embeds")
        if img is not None:
            img = torch.as_tensor(img, device=self.device)
        x, aux = self.train_trunk(tokens[:, :-1], img)
        labels = tokens[:, 1:]
        n_img = 0 if img is None else img.shape[1]
        if self.plan is None:
            if img is not None:
                x = x[:, n_img:]
            loss = self._chunked_ce(x, labels)
        else:
            loss = self._planned_ce(x, labels, n_img)
        if self.cfg.n_experts:
            loss = loss + 0.01 * aux / max(self.cfg.n_layers, 1)
        return loss

    def _planned_ce(self, x, labels, n_img: int):
        """The whole batch's mean cross entropy from this rank's slice x
        (B_loc, S_loc, d) of the final norm's output under a train plan,
        the same on every rank.  Without image embeddings each rank holds
        as many labels: the mean of the ranks' chunked means.  With them a
        sequence cut leaves a rank its positions past the image only:
        each rank sums its labels' cross entropies (the image positions
        weigh 0, so every rank runs the same products and collectives) and
        the sum over the ranks is divided by the batch's label count."""
        tp = self.tp
        n, lo = self._seq_slice(n_img + labels.shape[1])
        if n == 1 or not n_img:
            ce = self._chunked_ce(x[:, n_img:], labels[:, lo:lo + x.shape[1]])
            return all_reduce(ce, "sum", tp.tokens) / tp.n_tokens
        pos = lo + torch.arange(x.shape[1], device=x.device) - n_img
        mask = (pos >= 0)[None].expand(x.shape[0], -1)
        mine = labels[:, pos.clamp(min=0)]
        total = labels.numel() * tp.n_tokens // n
        return all_reduce(self._chunked_ce(x, mine, mask=mask), "sum",
                          tp.tokens) / total

    def _ce(self, x, labels, mask=None):
        """The cross entropy of one chunk: f32 logits, those past
        ``vocab_size`` set to -1e30; with ``mask`` its sum over the masked
        labels.  Under a train plan the unembedding is gathered here (so
        a chunk's recompute gathers it again); a width-cut one gives the
        rank's vocab columns, gathered over the width group, whose ranks
        all compute this loss alike."""
        p = self.embed
        if self.plan is not None:   # the table the unembedding reads
            name = "unembed" if "unembed" in p else "embed"
            p = {name: self._w(f"embed.{name}")}
        cut = self.plan is not None and self.plan.cuts_width(
            self.param_specs.get("embed.unembed", ()))
        if cut:
            x = copy(x, self.tp.width)
        logits = layers.unembed(p, x, self.cfg.logit_softcap)
        if cut:
            logits = all_gather(logits, self.tp.width, adjoint="slice")
        real = torch.arange(logits.shape[-1],
                            device=x.device) < self.cfg.vocab_size
        logits = torch.where(real, logits, -1e30)
        if mask is None:
            return layers.cross_entropy(logits, labels)
        return layers.cross_entropy(logits, labels, mask) * \
            mask.sum().clamp(min=1)

    def _chunked_ce(self, x, labels, max_logit_bytes: int = 2 ** 28,
                    mask=None):
        """x: (B, T, d), labels (B, T).  The JAX rule at one shard
        (transformer.py:531-571): ``chunk`` halves from T while B * chunk *
        V_pad * 4 bytes of logits exceed ``max_logit_bytes``; each chunk is
        recomputed in backward (``@jax.checkpoint`` there); the loss is the
        mean of the chunks' means (with ``mask`` (B, T) the sum of the
        chunks' masked sums)."""
        b, s, d = x.shape
        v = layers.pad_vocab(self.cfg.vocab_size)
        chunk = s
        while chunk > 1 and b * chunk * v * 4 > max_logit_bytes:
            chunk //= 2
        nc = s // chunk
        masked = () if mask is None else (mask,)
        if nc <= 1:
            return self._ce(x, labels, *masked)
        xr = x.reshape(b, nc, chunk, d)
        lr = labels.reshape(b, nc, chunk)
        mr = [m.reshape(b, nc, chunk) for m in masked]
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(nc):
            args = (xr[:, i], lr[:, i]) + tuple(m[:, i] for m in mr)
            if torch.is_grad_enabled():
                tot = tot + checkpoint(self._ce, *args, use_reentrant=False)
            else:
                tot = tot + self._ce(*args)
        return tot if masked else tot / nc

    @torch.no_grad()
    def prefill(self, lora, tokens, adapter_idx=None, img_embeds=None):
        """tokens: (B, S); img_embeds: (B, I, d) or None, prepended.
        Returns (last-position logits (B, V), cache at ``pos`` = I + S).

        Under a prefill plan: the rank's rows of the batch, of the adapter
        ids (per request, (B,)) and of ``img_embeds``, over the whole
        prompt; the sequence of I + S positions is cut over the plan's
        sequence axis, which must divide it (raises ``ValueError``
        otherwise, as the JAX package's ``shard_map`` does).  Returns the
        last position's logits on every rank and the rank's cache
        (``Block.prefill``); ``pos`` is I + S."""
        self._planned("prefill", "prefill")
        x, positions, n, lo = self._embed_slice(tokens, img_embeds)
        b, s_loc, _ = x.shape
        s = n * s_loc
        cut = None
        if self.tp is not None and lora is not None and \
                adapter_idx is not None:
            cut = self._prompt_cut(adapter_idx, b, s, lo, s_loc)
        caches = []
        for block, lp in zip(self.layers, self._lora_layers(lora)):
            x, kv = block.prefill(x, lp, adapter_idx, positions, cut)
            caches.append(kv)
        x = x[:, -1:]
        if n > 1:   # the last position: the last sequence rank's last row
            x = all_gather(x, self.tp.seq, dim=1)[:, -1:]
        logits = self._logits(x)
        pos = torch.full((), s, dtype=torch.int32, device=x.device)
        return logits[:, 0], {"pos": pos, "layers": caches}

    def _prompt_cut(self, adapter_idx, b: int, s: int, lo: int,
                    s_loc: int):
        """What ``ops.lora_apply`` needs of the whole prompt under a plan:
        the rank's tokens' whole-prompt arrival ranks (the per-request ids
        gathered over the batch axes) and the whole prompt's token
        count."""
        from ..kernels.sgmv import arrival_ranks
        ids = torch.as_tensor(adapter_idx, device=self.device)
        if ids.shape != (b,):
            raise ValueError(f"prefill under a plan takes per-request "
                             f"adapter ids of shape ({b},), not "
                             f"{tuple(ids.shape)}")
        ids = ids.to(torch.int32)
        if self.tp.batch is not None:
            ids = all_gather(ids, self.tp.batch, dim=0)
        first = self.tp.batch_index * b
        return {"arrival": arrival_ranks(ids, first, b, s, lo, s_loc),
                "tokens": ids.shape[0] * s}

    @torch.no_grad()
    def decode_step(self, lora, cache, tokens, adapter_idx=None):
        """tokens: (B, 1). Returns (logits (B, V), cache): the cache itself,
        its KV tensors (and recurrent states) written and its ``pos`` advanced
        by one in place (under a decode plan, the rank's rows and cache).

        ``pos`` is read on the device only, and nothing in the step waits
        for the host or the host for it, so a CUDA graph that captures one
        call replays the step at every position."""
        self._planned("decode_step", "decode")
        pos = cache["pos"]
        slots = {}   # one CacheSlot per (kind, rows), made once a step
        x = layers.embed_tokens(self.embed["embed"], tokens)
        if self.cfg.pos_emb == "sinusoidal":
            x = x + layers.sinusoidal_pos_emb(
                pos.reshape(1, 1), self.cfg.d_model).to(x.dtype)
        for block, lp, c in zip(self.layers, self._lora_layers(lora),
                                cache["layers"]):
            key = block.slot_key(c)
            if key is not None and key not in slots:
                slots[key] = block.slot(pos, key[1])
            x = block.decode(x, lp, adapter_idx, c, slots.get(key))
        logits = self._logits(x)
        pos.add_(1)
        return logits[:, 0], cache

    def pad_cache(self, cache, extra: int) -> Dict[str, Any]:
        """A copy of a prefill cache with room for ``extra`` more positions.

        A global layer's cache (its scales too) gets ``extra`` rows of
        zeros.  A local layer's rolling
        buffer of w rows grows to min(window, w + extra): one shorter than
        the window (a prompt shorter than the window, whose row i holds
        position i) grows, so the next ``extra`` steps evict nothing the
        window still holds; one of ``window`` rows passes through.  The JAX
        package passes every rolling buffer through (transformer.py:606-622),
        so its first decode step after a prompt shorter than the window
        evicts position 0 (ROADMAP.md queue 3).  An rglru or ssd layer's
        states pass through, copied.

        Under a prefill plan ``cache`` is the rank's prefill cache and the
        result the rank's piece of the whole padded cache in the layout of
        the decode plan of the same mesh and batch (``make_plan(cfg, mesh,
        "decode", global_batch=B)``), which a model under that plan decodes
        from: a global layer's slices are gathered over the cache axes and
        cut anew (``Block.pad_cache``); the rest keeps its layout, which
        both plans share.
        """
        self._planned("pad_cache", "prefill")
        decode = None
        if self.plan is not None:
            rows = self.plan.axis_size(*self.plan.batch_axes)
            b = next(iter(cache["layers"][0].values())).shape[0]
            decode = make_plan(self.cfg, self.plan.mesh, "decode",
                               global_batch=b * rows,
                               kv_quant=self.plan.kv_quant)
        return {"pos": cache["pos"].clone(),
                "layers": [blk.pad_cache(c, extra, decode) for blk, c in
                           zip(self.layers, cache["layers"])]}


def _check_plan(cfg: ModelConfig, plan) -> None:
    """Raise ``NotImplementedError`` for a plan the port does not run: a
    prefill or train plan with ``attn_batch_shard`` (ROADMAP.md item
    11e), and plans ``make_plan`` does not make (FSDP axes outside a
    train plan, a decode plan with a sequence axis, a prefill plan whose
    cache axes are not its sequence axis), or a train plan whose FSDP
    axes hold the same tokens on their ranks (a global batch the data
    axis does not divide)."""
    if plan.attn_batch_shard and plan.mode in ("prefill", "train"):
        raise NotImplementedError(
            f"{cfg.name}: a {plan.mode} plan with attn_batch_shard: "
            "batch-parallel attention over the sequence axis is ROADMAP.md "
            "item 11e")
    if plan.fsdp_axes and plan.mode != "train":
        raise NotImplementedError(
            f"{cfg.name}: a {plan.mode} plan with FSDP axes "
            f"{plan.fsdp_axes}: the port cuts weights FSDP-style only "
            "under a train plan, as make_plan makes it")
    if plan.mode == "train":
        alike = [a for a in plan.fsdp_axes if a not in plan.token_axes]
        if alike:
            raise NotImplementedError(
                f"{cfg.name}: a train plan whose FSDP axes {alike} do not "
                f"cut the batch (batch axes {plan.batch_axes}): the port "
                "trains FSDP over axes whose ranks hold different tokens; "
                "give a global batch the axes divide")
        return
    if plan.seq_axis and (plan.mode != "prefill"
                          or plan.cache_seq_axes != (plan.seq_axis,)):
        raise NotImplementedError(
            f"{cfg.name}: a {plan.mode} plan with sequence axis "
            f"{plan.seq_axis!r} and cache axes {plan.cache_seq_axes}: the "
            "port cuts the sequence only in a prefill plan whose cache "
            "axes are its sequence axis, as make_plan makes it")

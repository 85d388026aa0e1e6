"""Weight bridge: the JAX package's trees <-> the port's tensors.

The JAX package keeps parameters, LoRA banks and caches as nested
dicts/lists/tuples of arrays, each segment's layers stacked on axis 0
(``repro.models.transformer``, transformer.py:128-158).  Given those trees
as numpy arrays, this module builds the port's per-layer layout and back:

* params  (``Model.init``)      <-> ``Model``'s parameters, and any tree
  of the params' layout (gradients, AdamW moments) <-> a dict keyed by
  parameter name (``import_tree``, ``export_tree``);
* LoRA    (``Model.init_lora``) <-> {"layers": [{"a_q", "b_q", ...}, ...]},
  the placeholder ``{"_": zeros}`` of a layer without attention (rglru,
  ssd: no bank, transformer.py:144-156) <-> {}, on every such layer;
* caches  (``init_cache``, ``prefill``) <-> {"pos", "layers": [{"k", "v"}]},
  an rglru layer's {"conv", "lru"} and an ssd layer's {"conv_x",
  "conv_bc", "ssm"} states alike.

Under a sharding plan (``models.sharding``) ``load_params`` and
``cache_to_shard`` carry each leaf across whole onto the CPU, cut it to
the rank's piece there and move only that to the model's device, as the
JAX package's ``device_put`` onto a ``NamedSharding`` places them.

Every leaf crosses bit for bit: f32, int8 (int8 experts) and f16 (their
scales) as they are, and bf16, which torch cannot take from numpy, viewed
as uint16, then int16 (which torch reads), then as torch.bfloat16.  The
way back needs numpy's bfloat16 dtype, which is registered once the JAX
package's ml_dtypes is loaded; this module never imports it.  An MoE
layer's subtree ``moe`` ({"router", "w_gate", "w_up", "w_down"} and, for
int8 experts, their ``*_scale``) maps onto ``Block.moe`` like any other.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def tensor(arr, device="cpu") -> torch.Tensor:
    """One numpy array -> a torch tensor on ``device``, bit for bit (a
    tensor is moved as it is)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def array(t: torch.Tensor) -> np.ndarray:
    """One torch tensor -> a numpy array, bit for bit (bf16 -> bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(
            np.dtype("bfloat16"))
    return t.numpy()


def to_torch(tree, device="cpu"):
    """Map ``tensor`` over a nested dict/list/tuple of arrays."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return tensor(tree, device)


def to_numpy(tree):
    """Map ``array`` over a nested dict/list/tuple of tensors."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return array(tree)


# --------------------------------------------------------------------------- #
# per-segment stacks <-> per-layer lists
# --------------------------------------------------------------------------- #

def _unstack(segments) -> List[Dict[str, Any]]:
    """JAX [{"blocks": (block tree, ...)}] -> one tree per layer, in
    order: repeat r of a segment runs its blocks in pattern order."""
    out = []
    for seg in segments:
        blocks = seg["blocks"]
        repeats = _leaves(blocks[0])[0].shape[0]
        for r in range(repeats):
            for blk in blocks:
                out.append(_map(lambda a, r=r: a[r], blk))
    return out


def _stack(per_layer, pattern_len: int, n_layers: int):
    """Inverse of ``_unstack`` for the segments of ``build_segments``."""
    full, rem = divmod(n_layers, pattern_len)
    segs, i = [], 0
    for kinds, repeats in ((pattern_len, full), (rem, 1)):
        if not kinds or not repeats:
            continue
        rows = [per_layer[i + r * kinds:i + (r + 1) * kinds]
                for r in range(repeats)]
        i += kinds * repeats
        segs.append({"blocks": tuple(
            _zip_stack([row[b] for row in rows]) for b in range(kinds))})
    return segs


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _zip_stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def named_leaves(params) -> Dict[str, Any]:
    """A tree in the layout of a JAX ``Model.init`` tree -> {the port's
    parameter name: leaf}, a stacked leaf indexed by its layer's repeat
    (``leaf[r]``), nothing converted."""
    mapped = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for i, blk in enumerate(_unstack(params["segments"])):
        mapped[f"layers.{i}"] = blk
    out = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            out[prefix] = tree
    walk("", mapped)
    return out


def import_tree(params, device="cpu") -> Dict[str, torch.Tensor]:
    """A tree in the layout of a JAX ``Model.init`` tree (numpy or tensor
    leaves: the params, their gradients, AdamW moments, a checkpoint's)
    -> {the port's parameter name: tensor on ``device``}; the inverse of
    ``export_tree``."""
    return {name: tensor(leaf, device)
            for name, leaf in named_leaves(params).items()}


def load_params(model, params) -> None:
    """Copy a JAX ``Model.init`` tree (numpy leaves) into ``model``; a
    model under a plan (``Model(cfg, plan=...)``) gets the rank's pieces,
    each leaf cut by its ``param_specs`` on the CPU, one at a time."""
    if model.plan is None:
        tree = import_tree(params, model.device)
    else:
        from .models.sharding import shard_tensor
        tree = {name: shard_tensor(tensor(leaf), model.param_specs[name],
                                   model.plan).to(model.device)
                for name, leaf in named_leaves(params).items()}
    model.load_state_dict(tree, strict=True, assign=False)


def export_tree(model, fn) -> Dict[str, Any]:
    """``fn(name, parameter)`` of each of ``model``'s parameters, as a JAX
    ``Model.init`` tree of numpy arrays: a tree the shape of the params,
    such as their gradients or their AdamW moments, each keyed by the
    parameter's name (``fn`` returns a tensor; a layer's leaves are
    stacked over its segment's repeats)."""
    cfg = model.cfg
    per_layer = []
    for i, blk in enumerate(model.layers):
        tree: Dict[str, Any] = {}
        for name, p in blk.named_parameters():
            node = tree
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = array(fn(f"layers.{i}.{name}", p))
        per_layer.append(tree)

    def top(prefix, params):
        return {k: array(fn(f"{prefix}.{k}", v)) for k, v in params.items()}
    return {"embed": top("embed", model.embed),
            "final_norm": top("final_norm", model.final_norm),
            "segments": _stack(per_layer, len(cfg.block_pattern),
                               cfg.n_layers)}


def export_params(model) -> Dict[str, Any]:
    """``model``'s parameters as a JAX ``Model.init`` tree of numpy arrays."""
    return export_tree(model, lambda name, p: p)


#: the JAX package's LoRA placeholder of a layer without a bank
NO_BANK = "_"


def lora_to_torch(lora, device="cpu"):
    """JAX ``init_lora`` tree -> the port's {"layers": [...]}; a layer's
    placeholder {"_": ...} becomes {}."""
    return {"layers": [{} if NO_BANK in layer else to_torch(layer, device)
                       for layer in _unstack(lora["segments"])]}


def lora_to_numpy(lora, cfg):
    """The port's LoRA banks -> a JAX ``init_lora`` tree; a layer without a
    bank gets the placeholder, one zero of ``cfg.dtype`` a layer."""
    per_layer = [to_numpy(layer) if layer else
                 {NO_BANK: np.zeros((1,), np.dtype(cfg.dtype))}
                 for layer in lora["layers"]]
    return {"segments": _stack(per_layer, len(cfg.block_pattern),
                               cfg.n_layers)}


def cache_to_torch(cache, device="cpu"):
    """JAX ``init_cache``/``prefill`` cache -> the port's cache, ``pos`` a
    0-d int32 tensor on ``device`` beside the K/V (the model reads it
    there, as JAX reads its traced ``pos``)."""
    return {"pos": tensor(cache["pos"], device),
            "layers": to_torch(_unstack(cache["segments"]), device)}


def cache_to_shard(cache, plan, device="cpu"):
    """A JAX cache, as ``cache_to_torch`` carries it across, then cut to
    this rank's pieces by ``plan.cache_specs`` (``sharding.shard_cache``)
    on the CPU and moved to ``device``; a plan without a mesh leaves it
    whole."""
    from .models.sharding import shard_cache
    if plan.mesh is None:
        return cache_to_torch(cache, device)
    return to_torch(shard_cache(cache_to_torch(cache), plan), device)


def cache_to_numpy(cache, cfg):
    """The port's cache -> a JAX cache tree (``pos`` taken back from the
    device it lies on)."""
    return {"pos": array(cache["pos"]),
            "segments": _stack(to_numpy(cache["layers"]),
                               len(cfg.block_pattern), cfg.n_layers)}

"""Step builders: one (arch x shape x mesh) cell -> a step function with
its arguments and each argument's specs under the cell's plan
(counterpart of ``repro.launch.steps``).

On the ``meta`` device (the default) nothing is allocated: the arguments
are the whole cell's tensors as shapes and dtypes only, the port's
``ShapeDtypeStruct``s, and ``cell_bytes`` reads one device's piece of
each through the plan's specs, as the JAX dry-run reads its lowered
arguments.  On ``"cpu"`` or ``"cuda"`` the same arguments are real
tensors, drawn from ``seed``, and ``fn(*args)`` runs the step.

The mesh is a ``launch.mesh.MeshShape`` (names and sizes, the JAX
package's ``AbstractMesh``) or None.  By default the model is built
whole, without the plan (its ``remat``, ``kv_quant`` and
``expert_quant`` kept): a planned ``Model`` is one rank's and needs the
mesh's process groups, which a ``MeshShape`` has not.  The plan gives the
specs (``param_specs``, ``cache_specs``), the JAX build's
``plan.param_specs`` of the whole ``eval_shape`` (steps.py:66-68).

With ``planned=True`` the mesh is a ``DeviceMesh`` (on ``meta``, the one
of ``launch.mesh.meta_mesh``) and the bundle is one rank's: the model
built under the plan, its parameters, AdamW state and cache the rank's
pieces, the prefill's and decode's inputs the rank's rows
(``shard_tensor``; a train step takes the whole batch and cuts it
itself), the LoRA banks whole (replicated).  The specs are the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.shapes import (DRYRUN_ADAPTER_SLOTS, DRYRUN_LORA_RANK,
                              input_specs)
from ..models import Model
from ..models.config import ModelConfig, ShapeConfig
from ..models.sharding import local_shape, make_plan, shard_tensor
from ..training import (AdamWConfig, TrainConfig, init_train_state,
                        make_train_step)

#: the argument groups ``cell_bytes`` counts, in its order
ARG_GROUPS = ("params", "opt", "lora", "cache", "inputs")


@dataclasses.dataclass
class StepBundle:
    fn: Any
    args: Tuple[Any, ...]                 # meta tensors, or real ones
    specs: Tuple[Any, ...]                # each argument's specs
    donate: Tuple[int, ...]               # arguments the step updates
    plan: Any
    model: Model
    meta: Dict[str, Any]                  # kind; each argument's group


def _inputs(cfg: ModelConfig, shape: ShapeConfig, device: torch.device,
            seed: int) -> Dict[str, torch.Tensor]:
    """The cell's inputs: the stand-ins on ``meta``; elsewhere seeded
    draws of their shapes and dtypes (tokens in the vocabulary, adapter
    ids in [-1, DRYRUN_ADAPTER_SLOTS), -1 the base model; image embeddings
    standard normal)."""
    specs = input_specs(cfg, shape)
    if device.type == "meta":
        return specs
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, t in specs.items():
        if name == "img_embeds":
            out[name] = torch.randn(t.shape, generator=gen, device=device,
                                    dtype=torch.float32).to(t.dtype)
        else:
            lo, hi = ((0, cfg.vocab_size) if name == "tokens"
                      else (-1, DRYRUN_ADAPTER_SLOTS))
            out[name] = torch.randint(lo, hi, t.shape, generator=gen,
                                      device=device, dtype=t.dtype)
    return out


def _replicated(tree):
    """Every leaf's spec whole: ``(None,) * ndim``."""
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicated(v) for v in tree]
    return (None,) * tree.ndim


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               unroll: bool = False, remat: bool = True,
               layers_override: Optional[int] = None,
               plan_overrides: Optional[Dict[str, Any]] = None,
               device="meta", seed: int = 0,
               planned: bool = False) -> StepBundle:
    """The cell (``cfg``, ``shape``, ``mesh``): its plan (``make_plan``,
    with ``plan_overrides`` replaced in), the whole model on ``device``
    (weights from ``seed``; ``kv_quant`` and ``expert_quant`` as the plan
    says), its arguments and their specs, the branches of steps.py:51-143:

    * train: (params, the AdamW state {"step", "m", "v"}, the batch);
      ``fn`` runs the port's ``TrainStep`` (``meta["train_step"]``), which
      updates the parameters and the state in place, and returns
      (params, state, info);
    * prefill: (params, the LoRA banks of DRYRUN_ADAPTER_SLOTS adapters
      of rank DRYRUN_LORA_RANK, tokens, adapter ids[, img_embeds]) ->
      (logits, cache);
    * decode: (params, LoRA, the cache of ``global_batch`` x ``seq_len``
      from ``init_cache``, tokens, adapter ids) -> (logits, cache), the
      cache written in place.

    ``params`` is ``dict(model.named_parameters())``: the port's model
    holds its weights, so ``fn`` reads them there and takes the argument
    for the JAX signature and for the bytes it stands for.

    ``planned``: rank 0's bundle on the ``DeviceMesh`` ``mesh`` (the
    module's docstring); ``meta["cut"]`` names the arguments that hold
    the rank's pieces already."""
    if layers_override:
        cfg = dataclasses.replace(cfg, n_layers=layers_override)
    plan = make_plan(cfg, mesh, shape.kind, unroll=unroll,
                     remat=remat and shape.kind == "train",
                     global_batch=shape.global_batch)
    if plan_overrides:
        plan = dataclasses.replace(plan, **plan_overrides)
    model = Model(cfg, device=device, seed=seed,
                  plan=plan if planned else dataclasses.replace(plan,
                                                                mesh=None))
    params = dict(model.named_parameters())
    pspecs = dict(model.param_specs) if planned else plan.param_specs(params)
    inputs = _inputs(cfg, shape, model.device, seed)
    dp = plan.dp()
    meta: Dict[str, Any] = {"kind": shape.kind, "cut": ()}

    def rows(t):
        """The rank's rows of a whole input (under ``planned``)."""
        if not planned:
            return t
        return shard_tensor(t, (dp,) + (None,) * (t.ndim - 1), plan)

    if shape.kind == "train":
        tcfg = TrainConfig(optimizer=AdamWConfig())
        opt = init_train_state(model, tcfg)
        train_step = make_train_step(model, tcfg)

        def step(params, opt_state, batch):
            opt_state, info = train_step(opt_state, batch)
            return params, opt_state, info

        # moments inherit param specs; the step count replicated
        ospecs = {"step": (), **{k: {n: pspecs[n] for n in opt[k]}
                                 for k in ("m", "v")}}
        bspecs = {"tokens": (dp, None)}
        if "img_embeds" in inputs:
            bspecs["img_embeds"] = (dp, None, None)
        meta.update(args=("params", "opt", "inputs"), train_step=train_step,
                    cut=(0, 1) if planned else ())
        return StepBundle(step, (params, opt, inputs),
                          (pspecs, ospecs, bspecs), (0, 1), plan, model,
                          meta)

    # serving cells share LoRA adapters (the paper's scenario)
    lora = model.init_lora(DRYRUN_ADAPTER_SLOTS, DRYRUN_LORA_RANK, seed=seed)
    lspecs = _replicated(lora)

    if shape.kind == "prefill":
        def step(params, lora, tokens, adapter_idx, img_embeds=None):
            return model.prefill(lora, tokens, adapter_idx,
                                 img_embeds=img_embeds)

        args = [params, lora, rows(inputs["tokens"]),
                rows(inputs["adapter_idx"])]
        specs = [pspecs, lspecs, (dp, None), (dp,)]
        if "img_embeds" in inputs:
            args.append(rows(inputs["img_embeds"]))
            specs.append((dp, None, None))
        meta["args"] = ("params", "lora") + ("inputs",) * (len(args) - 2)
        if planned:
            meta["cut"] = tuple(range(len(args)))
        return StepBundle(step, tuple(args), tuple(specs), (), plan, model,
                          meta)

    # decode: one new token against a cache of length shape.seq_len
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    # the specs of the whole cache's shapes (a piece's could divide
    # otherwise)
    cspecs = plan.cache_specs(
        {"pos": cache["pos"],
         "layers": [blk.init_cache(shape.global_batch, shape.seq_len, "meta")
                    for blk in model.layers]})

    def step(params, lora, cache, tokens, adapter_idx):
        return model.decode_step(lora, cache, tokens, adapter_idx)

    meta["args"] = ("params", "lora", "cache", "inputs", "inputs")
    if planned:
        meta["cut"] = tuple(range(5))
    return StepBundle(step, (params, lora, cache, rows(inputs["tokens"]),
                             rows(inputs["adapter_idx"])),
                      (pspecs, lspecs, cspecs, (dp, None), (dp,)), (2,),
                      plan, model, meta)


def _piece_bytes(tree, specs, plan, cut: bool = False) -> int:
    """The bytes of one device's piece of every tensor of ``tree`` (dicts
    and lists of tensors), each cut by its spec in ``specs``, a tree of
    the same structure; with ``cut`` the tensors are the pieces."""
    if isinstance(tree, dict):
        return sum(_piece_bytes(v, specs[k], plan, cut)
                   for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_piece_bytes(v, s, plan, cut)
                   for v, s in zip(tree, specs))
    shape = tree.shape if cut else local_shape(tree.shape, specs, plan)
    return math.prod(shape) * tree.element_size()


def arg_bytes(bundle: StepBundle) -> Tuple[int, ...]:
    """The bytes of one device's piece of each argument of ``bundle``, in
    argument order (``cell_bytes``' rule)."""
    return tuple(_piece_bytes(arg, spec, bundle.plan,
                              i in bundle.meta["cut"])
                 for i, (arg, spec) in enumerate(zip(bundle.args,
                                                     bundle.specs)))


def cell_bytes(bundle: StepBundle) -> Dict[str, int]:
    """The bytes of one device's piece of every argument of ``bundle``
    under its plan, by group ({"params", "opt", "lora", "cache",
    "inputs"}, 0 where the cell has none, and their "total"), each tensor
    read through ``local_shape``; without a mesh, the whole arguments.

    This stands in for the argument bytes of XLA's ``memory_analysis``
    (dryrun.py:45-63).  The temporaries XLA also counts, the buffers its
    compiled program allocates for the step, have no counterpart here: an
    eager step allocates its own as it runs (``roofline.cost_of_step``
    counts them on ``meta``).  A planned bundle's pieces are counted as
    they are."""
    out = dict.fromkeys(ARG_GROUPS, 0)
    for group, n in zip(bundle.meta["args"], arg_bytes(bundle)):
        out[group] += n
    out["total"] = sum(out[g] for g in ARG_GROUPS)
    return out


def cell_id(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}:{shape_name}:{'pod2' if multi_pod else 'pod1'}"

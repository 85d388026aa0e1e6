"""The JAX package's sharded bodies on host devices.

Usage: python tests/sharded_body_jax.py <inputs.npz|.pkl> <outputs.npz|.pkl>

The inputs' ``kind`` picks the body (``attention`` when absent):

* ``attention``: ``repro.models.attention.decode_attention_sharded`` under
  the JAX package's ``shard_map`` shim, the cache cut over a ``model`` axis
  of 4, on the inputs' q, caches (and int8 scales), new K/V and pos; writes
  the output and the updated caches;
* ``moe``: ``repro.models.moe.apply_moe`` under ``shard_map`` over a
  ``model`` axis of 4, the experts cut over it where it divides them (else
  whole on every device), x cut over it with ``gather`` (else
  replicated); writes the output and the aux loss;
* ``ffn``: ``Model._ffn`` of the inputs' reduced architecture under its
  decode plan on the inputs' ``mesh`` (data, model), on one layer's
  ``moe.*`` leaves and x (B, 1, d); writes the output and the aux loss;
* ``seq_attention``: ``ring_attention`` (``window`` 0) or
  ``local_attention`` under ``shard_map`` over a ``model`` axis of 4, q,
  k, v (B, S, H, D) cut over the sequence; writes the output;
* ``prefill`` (a pickle, with ``archs``: {arch: {params, lora, tokens,
  idx, img}} and ``prompt``): ``Model.prefill`` of each reduced
  architecture under ``make_plan(cfg, mesh, "prefill", global_batch=B)``
  on the inputs' ``mesh``, on ``prompt`` positions: the image embeddings
  ``img`` (B, I, d) where not None, then ``tokens[:, :prompt - I]``;
  writes {arch: {logits, cache}} as a pickle;
* ``train`` (a pickle, with ``archs``, ``grads`` and ``steps``): for each
  reduced architecture in f32, ``Model.init(PRNGKey(2))`` and tokens
  (4, 33) from ``randint(PRNGKey(2))`` (``case_train``,
  tests/sharded_cases.py:44-63), ``train_loss`` without a plan and under
  ``make_plan(cfg, mesh, "train", global_batch=4)`` on the inputs'
  ``mesh``; for the archs in ``grads`` also ``jax.grad`` of the planned
  loss (``case_grad``); for each (arch, microbatches) in ``steps`` one
  planned ``make_train_step`` (AdamW lr 1e-3, warmup 2) from the same
  weights; writes {arch: {params, tokens, loss, loss_unplanned, grads?}}
  and {"steps": {(arch, microbatches): {loss, grad_norm, params}}} as a
  pickle;
* ``compression`` (a pickle): the JAX package's int8 ring under
  ``shard_map`` over ``data`` of a (``mesh``) mesh of n devices, device i
  taking row i of each input, run eagerly as ``case_compression``
  (tests/sharded_cases.py:118-135) runs it: ``quantized_psum`` of ``x``
  (``mode`` "psum"), or ``compressed_grad_sync`` of ``grads`` ({name:
  (calls, n, ...) f32}, cast to ``dtypes``) over the calls, the residual
  carried ("sync"); writes each device's outputs in f32 (exact for bf16);
* ``checkpoint`` (a pickle, with ``archs`` and ``dir``): for each reduced
  architecture in f32, ``Model.init(PRNGKey(2))`` and three token batches
  (4, 33) from ``randint(PRNGKey(2 + i))``; one jitted planned
  ``make_train_step`` (AdamW lr 1e-3, warmup 2) on batch 0 under
  ``make_plan(cfg, mesh, "train", global_batch=4)`` on the (2, 4) mesh,
  saved as step 1 by the JAX ``CheckpointManager`` under ``dir/<arch>``,
  restored through ``shardings=`` onto the (1, 8) plan's
  ``NamedSharding``s (the moments their parameters', the step
  replicated) and a second step there on batch 1; writes {arch: {params,
  tokens, dir, state (after step 1), loss, grad_norm and params of the
  second step}} as a pickle.

The MoE bodies are compiled with XLA's excess precision off, the
arithmetic the JAX source states (see tests/test_torch_moe.py).  A
subprocess of tests/test_torch_distributed.py: the device count (the
mesh's size) must be set before jax initialises.
"""
import dataclasses
import math
import os
import pickle
import sys

import numpy as np


def _load(path):
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    return dict(np.load(path))


INPUTS = _load(sys.argv[1]) if __name__ == "__main__" else {}
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d" % \
    math.prod(INPUTS.get("mesh", (1, 4)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_reduced  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import Model, make_plan  # noqa: E402
from repro.models.attention import (decode_attention_sharded,  # noqa: E402
                                    local_attention, ring_attention)
from repro.models.moe import apply_moe  # noqa: E402
from repro.models.transformer import shard_map  # noqa: E402
from repro.training import (AdamWConfig, TrainConfig,  # noqa: E402
                            adamw_init, make_train_step)


def _as_written(f, *args):
    return jax.jit(f).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def attention(inp):
    n = 4
    mesh = make_test_mesh(1, n)
    quant = "k_scale" in inp
    d = inp["q"].shape[-1]
    cspec, sspec = P(None, "model", None, None), P(None, "model", None)

    def body(q, kc, vc, nk, nv, pos, *scales):
        return decode_attention_sharded(
            q, kc, vc, nk, nv, pos, axis_name="model", n_shards=n,
            scale=1.0 / math.sqrt(d), k_scale=scales[0] if quant else None,
            v_scale=scales[1] if quant else None)

    in_specs = [P(), cspec, cspec, P(), P(), P()] + [sspec, sspec] * quant
    out_specs = [P(), cspec, cspec] + [sspec, sspec] * quant
    args = [inp["q"], inp["k"], inp["v"], inp["new_k"], inp["new_v"],
            jnp.int32(inp["pos"])]
    if quant:
        args += [inp["k_scale"], inp["v_scale"]]
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(in_specs),
                          out_specs=tuple(out_specs), check_vma=False))
    outs = [np.asarray(o) for o in f(*args)]
    names = ["out", "k", "v", "k_scale", "v_scale"][:len(outs)]
    return dict(zip(names, outs))


def moe(inp):
    n = 4
    mesh = make_test_mesh(1, n)
    gather = bool(inp["gather"])
    p = {k[4:]: inp[k] for k in inp if k.startswith("moe.")}
    e = p["w_gate"].shape[0]
    ep = "model" if e % n == 0 else None
    espec = {k: P(None, None) if k == "router" else P(ep, None, None)
             for k in p}
    xspec = P("model", None) if gather else P()

    def body(pl, xl):
        return apply_moe(pl, xl, top_k=int(inp["top_k"]), n_experts=e,
                         capacity_factor=float(inp["capacity_factor"]),
                         axis_name="model", n_shards=n, gather=gather)
    f = shard_map(body, mesh=mesh, in_specs=(espec, xspec),
                  out_specs=(xspec, P()), check_vma=False)
    out, aux = _as_written(f, p, inp["x"])
    return {"out": np.asarray(out), "aux": np.asarray(aux)}


def ffn(inp):
    mesh = make_test_mesh(*map(int, inp["mesh"]))
    cfg = dataclasses.replace(get_reduced(str(inp["arch"])), dtype="float32")
    x = inp["x"]
    model = Model(cfg, make_plan(cfg, mesh, "decode",
                                 global_batch=x.shape[0]))
    p = {"moe": {k[4:]: inp[k] for k in inp if k.startswith("moe.")}}
    with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh):
        out, aux = _as_written(model._ffn, p, x)
    return {"out": np.asarray(out), "aux": np.asarray(aux)}


def seq_attention(inp):
    n = 4
    mesh = make_test_mesh(1, n)
    spec = P(None, "model", None, None)
    window = int(inp["window"])
    kw = dict(axis_name="model", n_shards=n,
              scale=1.0 / math.sqrt(inp["q"].shape[-1]))
    if window:
        body = lambda q, k, v: local_attention(q, k, v, window=window, **kw)  # noqa: E731
    else:
        body = lambda q, k, v: ring_attention(q, k, v, **kw)  # noqa: E731
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                          out_specs=spec, check_vma=False))
    return {"out": np.asarray(f(inp["q"], inp["k"], inp["v"]))}


def prefill(inp):
    mesh = make_test_mesh(*map(int, inp["mesh"]))
    out = {}
    for arch, a in inp["archs"].items():
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        img = a.get("img")
        n_img = 0 if img is None else img.shape[1]
        tokens = jnp.asarray(a["tokens"][:, :inp["prompt"] - n_img])
        model = Model(cfg, make_plan(cfg, mesh, "prefill",
                                     global_batch=tokens.shape[0]))
        with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh):
            logits, cache = jax.jit(model.prefill)(
                a["params"], a["lora"], tokens, jnp.asarray(a["idx"]),
                None if img is None else jnp.asarray(img))
        out[arch] = {"logits": np.asarray(logits),
                     "cache": jax.tree.map(np.asarray, cache)}
    return out


def train(inp):
    from jax.sharding import NamedSharding
    mesh = make_test_mesh(*map(int, inp["mesh"]))
    key = jax.random.PRNGKey(2)
    use = jax.set_mesh if hasattr(jax, "set_mesh") else (lambda m: m)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731

    def put(tree, specs):
        return jax.tree.map(
            lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), tree,
            specs, is_leaf=lambda x: not isinstance(x, (dict, list, tuple)))

    out, built = {"steps": {}}, {}
    for arch in inp["archs"]:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        params = Model(cfg).init(key)
        tokens = jax.random.randint(key, (4, 33), 0, cfg.vocab_size)
        plan = make_plan(cfg, mesh, "train", global_batch=4)
        model = Model(cfg, plan)
        params_sh = put(params, plan.param_specs(params))
        batch_sh = {"tokens": jax.device_put(
            tokens, NamedSharding(mesh, P("data", None)))}
        entry = {"params": to_np(params), "tokens": np.asarray(tokens),
                 "loss_unplanned": float(jax.jit(Model(cfg).train_loss)(
                     params, {"tokens": tokens}))}
        with use(mesh):
            entry["loss"] = float(jax.jit(model.train_loss)(params_sh,
                                                           batch_sh))
            if arch in inp["grads"]:
                entry["grads"] = to_np(jax.jit(jax.grad(model.train_loss))(
                    params_sh, batch_sh))
        out[arch] = entry
        built[arch] = (model, params_sh, batch_sh)
    for arch, mb in inp["steps"]:
        model, params_sh, batch_sh = built[arch]
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2),
                           microbatches=mb)
        with use(mesh):
            new, _, info = jax.jit(make_train_step(model, tcfg))(
                params_sh, adamw_init(params_sh, tcfg.optimizer), batch_sh)
        out["steps"][(arch, mb)] = {"loss": float(info["loss"]),
                                    "grad_norm": float(info["grad_norm"]),
                                    "params": to_np(new)}
    return out


def compression(inp):
    from repro.training.compression import (compressed_grad_sync,
                                            quantized_psum)
    n = math.prod(inp["mesh"])
    mesh = make_test_mesh(*inp["mesh"])
    spec = P("data")

    def per_device(f, *args):
        # eager, not jitted: under jit XLA turns the source's / 127.0 into
        # a product with 1 / 127 and fuses the ring's multiply-add
        return shard_map(f, mesh=mesh, in_specs=(spec,) * len(args),
                         out_specs=spec, check_vma=False)(*args)

    if inp["mode"] == "psum":
        return {"out": np.asarray(per_device(
            lambda xl: quantized_psum(xl[0], "data", n)[None],
            jnp.asarray(inp["x"])))}

    def sync(g, r=None):
        first = lambda t: {k: v[0] for k, v in t.items()}  # noqa: E731
        synced, res = compressed_grad_sync(
            first(g), "data", n, None if r is None else first(r))
        return ({k: v[None] for k, v in synced.items()},
                {k: v[None] for k, v in res.items()})

    calls, residual = [], None
    for c in range(len(next(iter(inp["grads"].values())))):
        g = {k: jnp.asarray(v[c], inp["dtypes"][k])
             for k, v in inp["grads"].items()}
        synced, residual = (per_device(sync, g) if residual is None
                            else per_device(sync, g, residual))
        calls.append({
            "synced": {k: np.asarray(v, np.float32)
                       for k, v in synced.items()},
            "dtypes": {k: str(v.dtype) for k, v in synced.items()},
            "residual": {k: np.asarray(v) for k, v in residual.items()}})
    return {"calls": calls}


def checkpoint(inp):
    from jax.sharding import NamedSharding
    from repro.checkpoint import CheckpointManager
    use = jax.set_mesh if hasattr(jax, "set_mesh") else (lambda m: m)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    meshes = {"2x4": make_test_mesh(2, 4), "1x8": make_test_mesh(1, 8)}
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2))
    out = {}
    for arch in inp["archs"]:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        params = Model(cfg).init(jax.random.PRNGKey(2))
        tokens = np.stack([np.asarray(jax.random.randint(
            jax.random.PRNGKey(2 + i), (4, 33), 0, cfg.vocab_size))
            for i in range(3)])

        def planned(name):
            """(the model under ``name``'s train plan, the state's
            shardings)."""
            mesh = meshes[name]
            plan = make_plan(cfg, mesh, "train", global_batch=4)
            ps = jax.tree.map(
                lambda x, sp: NamedSharding(mesh, sp), params,
                plan.param_specs(params),
                is_leaf=lambda x: not isinstance(x, (dict, list, tuple)))
            return Model(cfg, plan), {"params": ps, "opt": {
                "step": NamedSharding(mesh, P()), "m": ps, "v": ps}}

        def step(name, model, state, i):
            mesh = meshes[name]
            batch = {"tokens": jax.device_put(
                jnp.asarray(tokens[i]), NamedSharding(mesh, P("data", None)))}
            with use(mesh):
                new, opt, info = jax.jit(make_train_step(model, tcfg))(
                    state["params"], state["opt"], batch)
            return {"params": new, "opt": opt}, info

        model, shardings = planned("2x4")
        first = jax.device_put(params, shardings["params"])
        state, _ = step("2x4", model, {"params": first, "opt": adamw_init(
            first, tcfg.optimizer)}, 0)
        directory = os.path.join(inp["dir"], arch)
        mgr = CheckpointManager(directory)
        mgr.save(1, state)
        mgr.wait()
        model, shardings = planned("1x8")
        second, info = step("1x8", model,
                            mgr.restore(state, 1, shardings=shardings), 1)
        out[arch] = {"params": to_np(params), "tokens": tokens,
                     "dir": directory, "state": to_np(state),
                     "loss": float(info["loss"]),
                     "grad_norm": float(info["grad_norm"]),
                     "second": to_np(second["params"])}
    return out


if __name__ == "__main__":
    kind = str(INPUTS.get("kind", "attention"))
    result = {"attention": attention, "moe": moe, "ffn": ffn,
              "seq_attention": seq_attention, "prefill": prefill,
              "train": train, "compression": compression,
              "checkpoint": checkpoint}[kind](INPUTS)
    if sys.argv[2].endswith(".pkl"):
        with open(sys.argv[2], "wb") as f:
            pickle.dump(result, f)
    else:
        np.savez(sys.argv[2], **result)

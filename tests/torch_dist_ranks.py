"""Rank bodies of tests/test_torch_distributed.py, and their launcher.

Each case runs in ``world`` processes spawned by ``spawn``: every rank
starts a gloo process group on a ``FileStore`` in the case's directory,
reads the case's inputs (``inputs.pkl``, numpy), runs its part of the
port's sharded decode on the CPU and writes what it got (``out<rank>.pkl``).
This module imports torch and the port only, so a rank loads no JAX.
"""
import contextlib
import dataclasses
import pickle
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import init_cpu_group, make_test_mesh
from repro_torch.models import Model, layers, moe, sharding, transformer
from repro_torch.models.attention import CacheSlot, decode_attention_sharded
from repro_torch.models.sharding import (COLLECTIVES, RankGroups,
                                         ShardingPlan, make_plan,
                                         reset_collectives, shard_tensor)


def spawn(case: str, world: int, inputs, workdir, timeout: float = 240.0):
    """Run ``case`` on ``world`` gloo ranks; return each rank's output.

    The ranks are joined within ``timeout`` seconds: a rank that raises
    fails the call with its traceback, and ranks still running at the
    deadline (a hung collective) are killed and the call raises
    ``TimeoutError``."""
    workdir = Path(workdir)
    (workdir / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    ctx = mp.start_processes(run, args=(world, case, str(workdir)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{case}: {world} ranks still running "
                                   f"after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [pickle.loads((workdir / f"out{r}.pkl").read_bytes())
            for r in range(world)]


def run(rank: int, world: int, case: str, workdir: str) -> None:
    torch.set_num_threads(1)
    workdir = Path(workdir)
    init_cpu_group(rank, world, str(workdir / "store"))
    try:
        inputs = pickle.loads((workdir / "inputs.pkl").read_bytes())
        out = CASES[case](inputs)
        (workdir / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
        # no rank tears its groups down while another still runs: without
        # it, gloo aborted a rank at teardown ("terminate called without an
        # active exception") in about 1 of 10 spawns with a flattened group
        dist.barrier()
    finally:
        dist.destroy_process_group()


def case_body(inp):
    """``decode_attention_sharded`` on this rank's slice of one cache cut
    over ``model`` of a (1, world) mesh: the output and the updated slice
    (and scales)."""
    mesh = make_test_mesh(1, dist.get_world_size(), device="cpu")
    plan = ShardingPlan(mesh=mesh, width_axis="model",
                        cache_seq_axes=("model",), mode="decode")
    tp = RankGroups(plan)
    caches = [shard_tensor(torch.from_numpy(inp[n]),
                           (None, "model") + (None,) * (inp[n].ndim - 2),
                           plan)
              for n in ("k", "v", "k_scale", "v_scale") if n in inp]
    s_loc = caches[0].shape[1]
    slot = CacheSlot.shard(torch.tensor(inp["pos"], dtype=torch.int32), s_loc,
                           tp.cache_index)
    reset_collectives()
    out = decode_attention_sharded(
        torch.from_numpy(inp["q"]), caches[0], caches[1],
        torch.from_numpy(inp["new_k"]), torch.from_numpy(inp["new_v"]), slot,
        *caches[2:], group=tp.cache)
    return {"index": tp.cache_index, "out": out.numpy(),
            "caches": [c.numpy() for c in caches],
            "collectives": dict(COLLECTIVES)}


class WholeAtCut:
    """Counts, whenever a weight is cut to the rank's piece, the tensors
    drawn (``layers.dense_init``/``embed_init``) or carried across
    (``bridge.tensor``) whole that are still alive; ``most`` is the
    largest count.  1 means the rank held one whole weight at a time,
    the one being cut."""

    def __init__(self):
        self.refs, self.most = [], 0

    def _made(self, fn):
        def made(*args, **kwargs):
            t = fn(*args, **kwargs)
            self.refs.append(t.untyped_storage()._weak_ref())
            return t
        return made

    def _cut(self, fn):
        def cut(*args, **kwargs):
            self.most = max(self.most, sum(
                not torch.UntypedStorage._expired(r) for r in self.refs))
            return fn(*args, **kwargs)
        return cut

    def watch(self) -> contextlib.ExitStack:
        """The patches, as one context manager."""
        stack = contextlib.ExitStack()
        for module, name, wrap in ((layers, "dense_init", self._made),
                                   (layers, "embed_init", self._made),
                                   (bridge, "tensor", self._made),
                                   (transformer, "shard_tensor", self._cut),
                                   (sharding, "shard_tensor", self._cut)):
            stack.enter_context(mock.patch.object(
                module, name, wrap(getattr(module, name))))
        return stack


def case_moe(inp):
    """``moe.apply_moe`` on this rank of a (1, world) mesh, experts
    parallel over ``model``: the rank's experts (all of them where the
    axis does not divide them), and x's rows of the rank (``gather``) or
    all of them; the output and the aux loss."""
    mesh = make_test_mesh(1, dist.get_world_size(), device="cpu")
    plan = ShardingPlan(mesh=mesh, width_axis="model", mode="decode")
    tp = RankGroups(plan)
    p = {}
    for key, arr in inp.items():
        if key.startswith("moe."):
            name = key[4:]
            spec = plan.param_spec(("layers", "0", "moe", name), arr.shape)
            p[name] = shard_tensor(bridge.tensor(arr), spec, plan)
    x = torch.from_numpy(inp["x"])
    if inp["gather"]:
        x = shard_tensor(x, ("model", None), plan)
    reset_collectives()
    out, aux = moe.apply_moe(
        p, x, top_k=int(inp["top_k"]), n_experts=inp["moe.router"].shape[1],
        capacity_factor=float(inp["capacity_factor"]), group=tp.ep,
        index=tp.ep_index, gather=bool(inp["gather"]))
    return {"index": tp.ep_index, "out": out.numpy(), "aux": float(aux),
            "e_local": p["w_gate"].shape[0],
            "collectives": dict(COLLECTIVES)}


def case_ffn(inp):
    """Layer 0's ``Block._ffn`` of a planned reduced MoE model on bridged
    weights, on this rank's rows of x (B, 1, d), with and without its aux
    loss: the outputs, the aux loss and the collectives of each."""
    cfg = dataclasses.replace(get_reduced(inp["arch"]), dtype="float32")
    mesh = make_test_mesh(*inp["mesh"], device="cpu")
    x = inp["x"]
    plan = make_plan(cfg, mesh, "decode", global_batch=x.shape[0])
    model = Model(cfg, device="cpu", plan=plan)
    bridge.load_params(model, inp["params"])
    h = shard_tensor(torch.from_numpy(x), (plan.dp(), None, None), plan)
    out = {"batch_index": plan.coordinate(plan.dp()),
           "n_batch": plan.axis_size(*plan.dp())}
    for with_aux in (True, False):
        reset_collectives()
        got, aux = model.layers[0]._ffn(h, aux=with_aux)
        out[with_aux] = {"out": got.numpy(), "aux": float(aux),
                         "collectives": dict(COLLECTIVES)}
    return out


def case_model(inp):
    """The port's decode under ``make_plan(cfg, make_test_mesh(data,
    model), "decode", global_batch=B)`` on bridged JAX weights and cache
    (the reduced architecture with the inputs' ``overrides``): this rank's
    rows of the logits at each step."""
    cfg = dataclasses.replace(get_reduced(inp["arch"]), dtype="float32",
                              **inp.get("overrides", {}))
    mesh = make_test_mesh(*inp["mesh"], device="cpu")
    tokens, idx = inp["tokens"], inp["idx"]
    plan = make_plan(cfg, mesh, "decode", global_batch=tokens.shape[0],
                     kv_quant=inp.get("kv_quant", False))
    drawn, loaded = WholeAtCut(), WholeAtCut()
    with drawn.watch():
        model = Model(cfg, device="cpu", plan=plan)
    with loaded.watch():
        bridge.load_params(model, inp["params"])
    lora = bridge.lora_to_torch(inp["lora"])
    cache = bridge.cache_to_shard(inp["cache"], plan)
    zeros = model.init_cache(tokens.shape[0], inp["rows"])
    init_shapes = all(
        {n: t.shape for n, t in a.items()} == {n: t.shape
                                              for n, t in b.items()}
        for a, b in zip(zeros["layers"], cache["layers"]))
    dp = plan.dp()
    tok = shard_tensor(torch.from_numpy(tokens).long(), (dp, None), plan)
    ids = shard_tensor(torch.from_numpy(idx), (dp,), plan)
    reset_collectives()
    logits = []
    for i in range(tok.shape[1]):
        out, cache = model.decode_step(lora, cache, tok[:, i:i + 1], ids)
        logits.append(out.numpy())
    shards = [getattr(blk, "shards", None) for blk in model.layers]
    return {"batch_index": plan.coordinate(dp) if dp else 0,
            "n_batch": plan.axis_size(*dp) if dp else 1,
            "cache_index": model.tp.cache_index,
            "logits": np.stack(logits), "pos": int(cache["pos"]),
            "init_shapes": init_shapes,
            "whole_at_cut": (drawn.most, loaded.most),
            "collectives": dict(COLLECTIVES),
            "specs": dict(model.param_specs),
            "width_cut": [sorted(s.cut) if s else None for s in shards]}


def case_build(inp):
    """Each of the inputs' reduced architectures built under the (2, 4)
    decode plan at batch 4: {arch: (width, cache shards)}."""
    mesh = make_test_mesh(2, 4, device="cpu")
    out = {}
    for arch in inp["archs"]:
        cfg = get_reduced(arch)
        model = Model(cfg, device="cpu", plan=make_plan(cfg, mesh, "decode",
                                                        global_batch=4))
        out[arch] = (model.plan.n_width, model.plan.n_cache)
    return out


CASES = {"body": case_body, "moe": case_moe, "ffn": case_ffn,
         "model": case_model, "build": case_build}

"""Rank bodies of tests/test_torch_distributed.py, and their launcher.

Each case runs in ``world`` processes spawned by ``spawn``: every rank
starts a gloo process group on a ``FileStore`` in the case's directory,
reads the case's inputs (``inputs.pkl``, numpy), runs its part of the
port's sharded prefill or decode on the CPU and writes what it got
(``out<rank>.pkl``).
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
from repro_torch.checkpoint import CheckpointManager, copy_into
from repro_torch.checkpoint.manager import (_flatten, _leaf_specs,
                                            _unflatten_into)
from repro_torch.configs import get_reduced
from repro_torch.launch.fault_tolerance import FaultTolerantLoop, FTConfig
from repro_torch.launch.mesh import init_cpu_group, make_test_mesh
from repro_torch.models import Model, layers, moe, sharding, transformer
from repro_torch.kernels import ref as kernel_ref
from repro_torch.models import attention
from repro_torch.models.attention import CacheSlot, decode_attention_sharded
from repro_torch.models.sharding import (COLLECTIVES, RankGroups,
                                         ShardingPlan, make_plan,
                                         reset_collectives, shard_tensor)
from repro_torch.training import (AdamWConfig, TrainConfig,
                                  compressed_grad_sync, init_train_state,
                                  make_train_step, quantized_psum,
                                  train_state_specs)
from repro_torch.training.train_lib import trainable


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
    plan of ``inp["kind"]`` (decode by default) at batch 4: {arch: (width,
    cache shards)}.  Under a prefill plan each also prefills 4 x 32
    positions of seeded tokens (a VLM 12 image embeddings and 20 tokens,
    the image crossing a slice's end) with 4 adapters, and the arch's entry
    gains the rank's rows of the logits, those of the model without a plan
    (the same seed, so the same weights) and the cache's ``pos``.  Under a
    train plan each takes ``train_loss`` of such a batch (33 tokens, a VLM
    12 image embeddings and 21 tokens) and backpropagates it, and the
    entry gains the loss, the loss of the model without a plan, and for
    an MoE whether its model with int8 experts refused ``train_loss``
    (``ValueError``; None for the others)."""
    kind = inp.get("kind", "decode")
    mesh = make_test_mesh(2, 4, device="cpu")
    out = {}
    for arch in inp["archs"]:
        cfg = get_reduced(arch)
        if kind in ("prefill", "train"):
            cfg = dataclasses.replace(cfg, dtype="float32")
        plan = make_plan(cfg, mesh, kind, global_batch=4,
                         remat=kind == "train")
        model = Model(cfg, device="cpu", plan=plan)
        out[arch] = (model.plan.n_width, model.plan.n_cache)
        if kind == "train":
            out[arch] += _train_build(cfg, plan, model)
        if kind != "prefill":
            continue
        whole = Model(cfg, device="cpu")
        lora = whole.init_lora(4, 4, seed=1)
        gen = torch.Generator().manual_seed(3)
        n_img = 12 if cfg.n_image_tokens else 0
        tokens = torch.randint(0, cfg.vocab_size, (4, 32 - n_img),
                               generator=gen)
        img = torch.randn((4, n_img, cfg.d_model), generator=gen) \
            if n_img else None
        idx = torch.arange(4, dtype=torch.int32) % 4
        want, _ = whole.prefill(lora, tokens, idx, img)
        dp = plan.dp()
        rows = (dp, None, None)
        got, cache = model.prefill(
            lora, shard_tensor(tokens, (dp, None), plan),
            shard_tensor(idx, (dp,), plan),
            shard_tensor(img, rows, plan) if n_img else None)
        out[arch] += (got.numpy(), shard_tensor(want, (dp, None), plan)
                      .numpy(), int(cache["pos"]))
    return out


def _train_build(cfg, plan, model):
    """(the planned loss, the loss without a plan, int8 experts refused)
    of ``case_build``'s train plan."""
    gen = torch.Generator().manual_seed(3)
    n_img = 12 if cfg.n_image_tokens else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 33 - n_img),
                                     generator=gen)}
    if n_img:
        batch["img_embeds"] = torch.randn((4, n_img, cfg.d_model),
                                          generator=gen)
    init_train_state(model)
    loss = model.train_loss(model.batch_rows(batch))
    loss.backward()
    want = float(Model(cfg, device="cpu").train_loss(batch))
    refused = None
    if cfg.n_experts:
        int8 = Model(cfg, device="cpu", plan=plan, expert_quant=True)
        try:
            int8.train_loss(int8.batch_rows(batch))
            refused = False
        except ValueError:
            refused = True
    return float(loss.detach()), want, refused


def case_seq_attention(inp):
    """``attention.ring_attention`` (window 0) or ``local_attention`` on
    this rank's slice of q, k, v (B, S, H, D) cut over ``model`` of a
    (1, world) mesh: the rank's index, its slice of the output and the
    collectives."""
    world = dist.get_world_size()
    mesh = make_test_mesh(1, world, device="cpu")
    plan = ShardingPlan(mesh=mesh, seq_axis="model", width_axis="model",
                        cache_seq_axes=("model",), mode="prefill")
    tp = RankGroups(plan)
    q, k, v = (shard_tensor(torch.from_numpy(inp[n]),
                            (None, "model", None, None), plan)
               for n in ("q", "k", "v"))
    scale = 1.0 / np.sqrt(q.shape[-1])
    ring = {"group": tp.seq, "index": tp.seq_index, "n_shards": world}
    reset_collectives()
    if inp["window"]:
        out = attention.local_attention(q, k, v, scale=float(scale),
                                        window=int(inp["window"]), **ring)
    else:
        out = attention.ring_attention(q, k, v, scale=float(scale), **ring)
    return {"index": tp.seq_index, "out": out.numpy(),
            "collectives": dict(COLLECTIVES)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def case_prefill(inp):
    """For each of the inputs' reduced architectures: the port's prefill
    under ``make_plan(cfg, make_test_mesh(2, 4), "prefill",
    global_batch=B)`` on bridged JAX weights, the rank's rows of the
    batch and the whole prompt of ``prompt`` positions (the image
    embeddings ``img``, where not None, then tokens); then ``pad_cache``
    to ``rows`` positions and ``steps`` decode steps of a model under the
    decode plan from that cache.  Per arch: the rank's indices,
    its rows of the prefill's logits, each cache leaf's relative departure
    from the JAX prefill's cache under the same plan cut by the same spec
    (``inp[arch]["jax_cache"]``), whether the tokens' arrival ranks are
    the whole prompt's, whether the padded cache has the decode model's
    shapes, the decode's logits at each step and the prefill's
    collectives."""
    mesh = make_test_mesh(2, 4, device="cpu")
    out = {}
    for arch, a in inp["archs"].items():
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        tokens, idx = a["tokens"], a["idx"]
        b, prompt, steps = tokens.shape[0], inp["prompt"], inp["steps"]
        rows = inp["rows"]
        plan = make_plan(cfg, mesh, "prefill", global_batch=b)
        model = Model(cfg, device="cpu", plan=plan)
        bridge.load_params(model, a["params"])
        lora = bridge.lora_to_torch(a["lora"])
        dp = plan.dp()
        tok = shard_tensor(torch.from_numpy(tokens).long(), (dp, None), plan)
        ids = shard_tensor(torch.from_numpy(idx), (dp,), plan)
        img = a.get("img")
        text = prompt - (0 if img is None else img.shape[1])
        if img is not None:
            img = shard_tensor(torch.from_numpy(img), (dp, None, None), plan)
        reset_collectives()
        logits, cache = model.prefill(lora, tok[:, :text], ids, img)
        collectives = dict(COLLECTIVES)
        want = bridge.cache_to_shard(a["jax_cache"], plan)
        cache_rel = {f"{i}.{n}": _rel(t.numpy(), want["layers"][i][n].numpy())
                     for i, layer in enumerate(cache["layers"])
                     for n, t in layer.items()}
        # the whole prompt's arrival ranks: token (b, s) is b * S + s
        tp = model.tp
        s_loc = prompt // tp.n_seq
        per_token = torch.from_numpy(idx).repeat_interleave(prompt)
        whole = kernel_ref._bucket_positions(
            per_token, int(idx.max()) + 1).reshape(b, prompt)
        first = tp.batch_index * tok.shape[0]
        lo = tp.seq_index * s_loc
        arrival = model._prompt_cut(ids, tok.shape[0], prompt, lo,
                                    s_loc)["arrival"]
        arrival_ok = torch.equal(
            arrival.long(), whole[first:first + tok.shape[0],
                                  lo:lo + s_loc].reshape(-1))
        padded = model.pad_cache(cache, rows - prompt)
        dec = Model(cfg, device="cpu", plan=make_plan(
            cfg, mesh, "decode", global_batch=b))
        bridge.load_params(dec, a["params"])
        zeros = dec.init_cache(b, rows)
        shapes_ok = all(
            {n: t.shape for n, t in x.items()} == {n: t.shape
                                                  for n, t in y.items()}
            for x, y in zip(zeros["layers"], padded["layers"]))
        steps_out = []
        for i in range(steps):
            got, padded = dec.decode_step(
                lora, padded, tok[:, text + i:text + i + 1], ids)
            steps_out.append(got.numpy())
        out[arch] = {"batch_index": tp.batch_index if dp else 0,
                     "n_batch": plan.axis_size(*dp) if dp else 1,
                     "seq_index": tp.seq_index, "n_seq": tp.n_seq,
                     "logits": logits.numpy(), "pos": int(cache["pos"]),
                     "cache_rel": cache_rel, "arrival_ok": arrival_ok,
                     "shapes_ok": shapes_ok, "decode": np.stack(steps_out),
                     "decode_pos": int(padded["pos"]),
                     "cache_index": dec.tp.cache_index,
                     "collectives": collectives}
    return out


def _adjoint_cases(plan, rank, n):
    """(name, rank's function, whole function, the rank's cut of the
    whole gradients) of each collective's use, on the 4 ranks of a (2, 2)
    mesh.  Each function takes {name: whole input}: the rank's cuts what
    the rank holds, runs the sharded computation and returns (its loss,
    the leaves whose gradients it compares); its loss is the same scalar
    on every rank (the planned loss's convention).  The whole function is
    the unsharded computation, differentiated in one process; the cut
    takes its {name: gradient} to the rank's leaves' gradients."""
    group = plan.group(("data", "model"))
    col = plan.coordinate("model")
    width = sharding.WidthShards(plan.group("model"), col, 2, frozenset())

    def rows(t):   # the rank's quarter of the rows
        m = t.shape[0] // n
        return t[rank * m:(rank + 1) * m]

    def cols(t, r):   # the columns of rank r's model coordinate (of 2)
        k = t.shape[-1] // 2
        return t[..., (r % 2) * k:(r % 2 + 1) * k]

    def total(t):   # the loss summed over the ranks
        return sharding.all_reduce(t, "sum", group)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    def gather_alike(T):   # every rank consumes the whole alike
        xs = leaf(rows(T["x"]))
        whole = sharding.all_gather(xs, group, dim=0, adjoint="slice")
        return (torch.sin(whole) * T["w"]).sum(), [xs]

    def gather_apart(T):   # each rank consumes the whole its own way
        xs = leaf(rows(T["x"]))
        whole = sharding.all_gather(xs, group, dim=0, adjoint="sum")
        return total((torch.tanh(whole) * T["c"][rank]).sum()), [xs]

    def gather_aux(T):   # beside one value all compute alike (the aux)
        xs = leaf(rows(T["x"]))
        whole = sharding.all_gather(xs, group, dim=0, adjoint="sum")
        aux = sharding.scale_grad((torch.sin(whole) * T["w"]).sum() ** 2,
                                  1 / n)
        return total((torch.tanh(whole) * T["c"][rank]).sum()) + aux, [xs]

    def scatter(T):
        mine = leaf(T["c"][rank])
        out = sharding.reduce_scatter(mine, group, dim=0)
        return total((torch.sin(out) * rows(T["w"])).sum()), [mine]

    def shifted(T):   # once and twice: a ring's chain
        mine = leaf(T["c"][rank])
        once = sharding.shift(mine, group)
        twice = sharding.shift(once, group)
        return total((torch.sin(once) * T["w"]).sum()
                     + (torch.cos(twice) * T["x"]).sum() * (rank + 1)), [mine]

    def mlp(T):   # width-TP: copy in, all-reduce out
        xs, w1, w2 = (leaf(T["x"]), leaf(width.piece(T["w1"])),
                      leaf(width.piece(T["w2"], 0)))
        h = torch.tanh(width.enter(xs, True) @ w1)
        return (torch.sin(width.reduce(h @ w2, True)) * T["w"]).sum(), \
            [xs, w1, w2]

    def pieces(T):   # cut to the piece, gathered whole, cut again
        xs = leaf(T["x"])
        mine = width.piece(torch.sin(xs))
        whole = width.relayout(torch.tanh(mine), True, False)
        back = width.relayout(whole * whole, False, True)
        return width.reduce((back * width.piece(T["c"][col])).sum(),
                            True), [xs]

    c_sum = lambda f: lambda T: sum(  # noqa: E731
        f(T, r) for r in range(n))
    cases = [
        ("all_gather-slice", gather_alike,
         lambda T: (torch.sin(T["x"]) * T["w"]).sum(),
         lambda G: [rows(G["x"])]),
        ("all_gather-sum", gather_apart,
         c_sum(lambda T, r: (torch.tanh(T["x"]) * T["c"][r]).sum()),
         lambda G: [rows(G["x"])]),
        ("scale_grad-aux", gather_aux,
         lambda T: c_sum(lambda T, r: (torch.tanh(T["x"])
                                       * T["c"][r]).sum())(T)
         + (torch.sin(T["x"]) * T["w"]).sum() ** 2,
         lambda G: [rows(G["x"])]),
        ("reduce_scatter", scatter,
         lambda T: (torch.sin(T["c"].sum(0)) * T["w"]).sum(),
         lambda G: [G["c"][rank]]),
        ("shift", shifted,
         c_sum(lambda T, r: (torch.sin(T["c"][(r - 1) % n]) * T["w"]).sum()
               + (torch.cos(T["c"][(r - 2) % n]) * T["x"]).sum() * (r + 1)),
         lambda G: [G["c"][rank]]),
        ("copy-all_reduce", mlp,
         lambda T: (torch.sin(torch.tanh(T["x"] @ T["w1"]) @ T["w2"])
                    * T["w"]).sum(),
         lambda G: [G["x"], width.piece(G["w1"]), width.piece(G["w2"], 0)]),
        ("piece-relayout", pieces,
         lambda T: sum(cols(torch.tanh(torch.sin(T["x"])) ** 2 * T["c"][m],
                            m).sum() for m in range(2)),
         lambda G: [G["x"]]),
    ]
    # a weight cut by its spec, gathered (whole, or over data alone, its
    # model cut kept) and used by each rank on its own data
    for spec, axes in ((("data", "model"), None),
                       ((("data", "model"), None), None),
                       (("data", "model"), ("data",))):
        def fsdp(T, spec=spec, axes=axes):
            piece = leaf(shard_tensor(T["w"], spec, plan))
            used = sharding.gather_whole(piece, spec, plan, axes=axes)
            mine = cols(T["c"][rank], rank) if axes else T["c"][rank]
            return total((torch.tanh(used) * mine).sum()), [piece]

        def fsdp_whole(T, axes=axes):
            return sum((cols(torch.tanh(T["w"]) * T["c"][r], r) if axes
                        else torch.tanh(T["w"]) * T["c"][r]).sum()
                       for r in range(n))
        cases.append((f"gather_whole-{spec}-{axes}", fsdp, fsdp_whole,
                      lambda G, spec=spec: [shard_tensor(G["w"], spec,
                                                         plan)]))
    return cases


def case_adjoints(inp):
    """Each collective's adjoint in each use (``_adjoint_cases``) in f64,
    and ``attention.ring_attention`` and ``local_attention`` (window 16)
    on 4 sequence ranks of a (1, 4) mesh in f32, against single-process
    autograd of the unsharded function: {case: the worst max |d| / max |g|
    of the rank's gradients}, the attention's collectives, and whether an
    all-reduce max of a tensor that needs a gradient raised."""
    rank, n = dist.get_rank(), dist.get_world_size()
    plan = ShardingPlan(mesh=make_test_mesh(2, 2, device="cpu"),
                        mode="train")
    T = {k: torch.from_numpy(inp[k]) for k in ("x", "w", "c", "w1", "w2")}
    out = {}
    for name, mine, whole, cut in _adjoint_cases(plan, rank, n):
        loss, leaves = mine(T)
        loss.backward()
        ref = {k: t.clone().requires_grad_(True) for k, t in T.items()}
        whole(ref).backward()
        want = cut({k: t.grad for k, t in ref.items()})
        out[name] = max(_rel(t.grad.numpy(), g.numpy()) for t, g in zip(leaves, want))
    try:
        sharding.all_reduce(T["x"].clone().requires_grad_(True), "max",
                            plan.group("model"))
        out["max_raises"] = False
    except ValueError:
        out["max_raises"] = True

    seq = ShardingPlan(mesh=make_test_mesh(1, n, device="cpu"),
                       seq_axis="model", mode="train")
    tp = RankGroups(seq)
    q, k, v, dout = (torch.from_numpy(inp[name]) for name in
                     ("q", "k", "v", "dout"))
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    spec = (None, "model", None, None)
    for window in (0, 16):
        def attend(q_, k_, v_, **ring):
            if window:
                return attention.local_attention(q_, k_, v_, scale=scale,
                                                 window=window, **ring)
            return attention.ring_attention(q_, k_, v_, scale=scale, **ring)
        ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (attend(*ref) * dout).sum().backward()
        mine = [shard_tensor(t, spec, seq).requires_grad_(True)
                for t in (q, k, v)]
        reset_collectives()
        got = attend(*mine, group=tp.seq, index=tp.seq_index, n_shards=n)
        (got * shard_tensor(dout, spec, seq)).sum().backward()
        out[f"attention-{window}"] = max(
            _rel(t.grad.numpy(), shard_tensor(r.grad, spec, seq).numpy())
            for t, r in zip(mine, ref))
        out[f"attention-{window}-collectives"] = dict(COLLECTIVES)
    return out


def _planned(cfg, params, mesh):
    """The reduced model under the (2, 4) train plan at batch 4 on bridged
    JAX weights, its parameters requiring gradients."""
    model = Model(cfg, device="cpu",
                  plan=make_plan(cfg, mesh, "train", global_batch=4,
                                 remat=True))
    bridge.load_params(model, params)
    init_train_state(model)
    return model


def _whole(model, tensors):
    """{name: the whole tensor} of a rank's pieces ({name: piece}),
    gathered by each parameter's spec."""
    with torch.no_grad():
        return {n: sharding.gather_whole(t, model.param_specs[n],
                                         model.plan).numpy()
                for n, t in tensors.items()}


def case_train(inp):
    """The port's training under ``make_plan(cfg, make_test_mesh(2, 4),
    "train", global_batch=4)`` on the JAX train body's weights and tokens
    (``inp["jax"]``): per arch the planned loss, and for the archs in
    ``grads`` each parameter's gradient after ``sync_grads`` gathered
    whole, with the collectives of the forward and of the backward; per
    (arch, microbatches) in ``steps`` one ``TrainStep`` (AdamW lr 1e-3,
    warmup 2) on the whole batch: its loss and gradient norm, and against
    the port's step without a plan on the same weights and batch (``vs``
    "port") the worst relative departure of the rank's updated pieces from
    the same pieces of that step, or (``vs`` "jax") the parameters after
    the step gathered whole."""
    mesh = make_test_mesh(2, 4, device="cpu")
    out = {"rank": dist.get_rank(), "steps": {}}
    for arch in inp["archs"]:
        a = inp["jax"][arch]
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        model = _planned(cfg, a["params"], mesh)
        rows = model.batch_rows({"tokens": torch.from_numpy(a["tokens"])
                                 .long()})
        reset_collectives()
        loss = model.train_loss(rows)
        forward = dict(COLLECTIVES)
        reset_collectives()
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.sync_grads(grads)
        entry = {"loss": float(loss.detach()), "forward": forward,
                 "backward": dict(COLLECTIVES),
                 "specs": dict(model.param_specs)}
        if arch in inp["grads"]:
            entry["grads"] = _whole(model, grads)
        out[arch] = entry
    for arch, mb, vs in inp["steps"]:
        a = inp["jax"][arch]
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2),
                           microbatches=mb)
        batch = {"tokens": a["tokens"]}
        model = _planned(cfg, a["params"], mesh)
        step = make_train_step(model, tcfg)
        _, info = step(init_train_state(model, tcfg), batch)
        entry = {"loss": float(info["loss"]),
                 "grad_norm": float(info["grad_norm"])}
        if vs == "jax":
            entry["params"] = _whole(model, dict(model.named_parameters()))
        else:
            whole = Model(cfg, device="cpu")
            bridge.load_params(whole, a["params"])
            wstep = make_train_step(whole, tcfg)
            _, winfo = wstep(init_train_state(whole, tcfg), batch)
            entry["whole"] = {"loss": float(winfo["loss"]),
                              "grad_norm": float(winfo["grad_norm"])}
            mine = dict(model.named_parameters())
            worst = 0.0
            with torch.no_grad():
                for n, w in whole.named_parameters():
                    want = shard_tensor(w, model.param_specs[n], model.plan)
                    worst = max(worst, float(
                        (mine[n] - want).norm() / want.norm().clamp(min=1e-30)))
            entry["worst"] = worst
        out["steps"][(arch, mb)] = entry
    return out


def case_compression(inp):
    """The int8 ring over the ``data`` axis of a (world, 1) mesh, the
    group's index i taking row i of each input: ``quantized_psum`` of
    ``x`` (``mode`` "psum"), or ``compressed_grad_sync`` of ``grads``
    ({name: (calls, world, ...) f32}, cast to ``dtypes``) over the calls,
    the residual carried ("sync"), with whether an ``n_shards`` other than
    the group's size raised ``ValueError``.  The outputs in f32 (exact for
    bf16), and the collectives of the psum or of each sync."""
    world = dist.get_world_size()
    mesh = make_test_mesh(world, 1, device="cpu")
    group = mesh.get_group("data")
    i = dist.get_group_rank(group, dist.get_rank())
    if inp["mode"] == "psum":
        reset_collectives()
        out = quantized_psum(torch.from_numpy(inp["x"][i]), group, world)
        return {"index": i, "out": out.numpy(),
                "collectives": dict(COLLECTIVES)}
    dtypes = {k: getattr(torch, v) for k, v in inp["dtypes"].items()}
    calls, residual = [], None
    for c in range(len(next(iter(inp["grads"].values())))):
        grads = {k: torch.from_numpy(v[c, i]).to(dtypes[k])
                 for k, v in inp["grads"].items()}
        reset_collectives()
        synced, residual = compressed_grad_sync(grads, group, world, residual)
        calls.append({"synced": {k: v.float().numpy()
                                 for k, v in synced.items()},
                      "dtypes": {k: str(v.dtype) for k, v in synced.items()},
                      "residual": {k: v.numpy() for k, v in residual.items()},
                      "collectives": dict(COLLECTIVES)})
    try:
        compressed_grad_sync(grads, group, world // 2)
        refused = False
    except ValueError:
        refused = True
    return {"index": i, "calls": calls, "refused": refused}


class _Planned:
    """A reduced model in f32 on bridged JAX weights under the train plan of
    ``mesh`` (None: no plan), with its train state ({"params", "opt"}),
    its specs and its step (AdamW lr 1e-3, warmup 2)."""

    def __init__(self, cfg, params, mesh):
        plan = None if mesh is None else \
            make_plan(cfg, mesh, "train", global_batch=4, remat=True)
        self.model = Model(cfg, device="cpu", plan=plan)
        bridge.load_params(self.model, params)
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2))
        self.state = {"params": trainable(self.model),
                      "opt": init_train_state(self.model, tcfg)}
        self.specs = train_state_specs(self.model, self.state)
        self.plan = self.model.plan
        self.train = make_train_step(self.model, tcfg)

    def step(self, state, batch):
        """One step on ``batch``: the state, its "opt" the step's."""
        opt, self.info = self.train(state["opt"], batch)
        return {"params": state["params"], "opt": opt}

    def flat(self, state=None):
        """{path: a copy of the leaf} of the live state (or ``state``)."""
        return {k: t.detach().clone()
                for k, t in _flatten(state or self.state).items()}

    def pieces_of(self, whole):
        """{path: this rank's piece of ``whole[path]``} under the plan."""
        spec = _leaf_specs(self.state, self.specs) if self.plan else {}
        return {k: shard_tensor(t, spec[k], self.plan) if self.plan else t
                for k, t in whole.items()}

    def whole(self, state=None):
        """{path: a copy of the whole leaf} of the rank's pieces, gathered
        (``gather_whole`` returns a leaf it does not cut itself)."""
        flat = _flatten(state or self.state)
        if self.plan is None:
            return {k: t.detach().clone() for k, t in flat.items()}
        spec = _leaf_specs(self.state, self.specs)
        with torch.no_grad():
            return {k: sharding.gather_whole(t.detach(), spec[k],
                                             self.plan).clone()
                    for k, t in flat.items()}


def _differ(got, want):
    """The paths whose tensors are not bit for bit equal."""
    return sorted(k for k, t in got.items() if not torch.equal(t, want[k]))


def _worst(got, want, prefix):
    """max over the leaves under ``prefix`` of ||got - want||_2 /
    ||want||_2."""
    return max(float((got[k] - want[k]).norm()
                     / want[k].norm().clamp(min=1e-30))
               for k in got if k.startswith(prefix))


def _checkpoint_arch(cfg, a, meshes, workdir: Path):
    """``case_checkpoint`` for one architecture (see there)."""
    rank = dist.get_rank()
    tokens = a["tokens"]

    def batch(i):
        return {"tokens": tokens[i % len(tokens)]}
    out = {}
    # (a) two planned steps on (2, 4), saved at step 2, a third step; the
    # restore onto the same mesh and the third step again
    run = _Planned(cfg, a["params"], meshes["2x4"])
    mgr = CheckpointManager(str(workdir / "planned"))
    for i in range(2):
        run.state = run.step(run.state, batch(i))
    writes = []
    save = np.save

    def counted(*args, **kwargs):
        writes.append(args[0])
        return save(*args, **kwargs)
    reset_collectives()
    with mock.patch.object(np, "save", counted):
        mgr.save(2, run.state, specs=run.specs, plan=run.plan)
        gathers = dict(COLLECTIVES)
        saved = run.whole()
        run.state = run.step(run.state, batch(2))
        mgr.wait()
    out["save"] = {"collectives": gathers, "writes": len(writes),
                   "timings": mgr.timings,
                   "cut": sum(any(e is not None for e in sp) for sp in
                              _leaf_specs(run.state, run.specs).values())}
    third, third_whole = run.flat(), run.whole()
    norm3 = float(run.info["grad_norm"])
    if rank == 0:
        # (c) an unplanned save of the gathered state
        CheckpointManager(str(workdir / "unplanned"), async_save=False).save(
            2, _unflatten_into(run.state, saved))
        out["saved"] = {k: t.numpy() for k, t in saved.items()}
        out["dirs"] = [str(workdir / side / "step_00000002")
                       for side in ("planned", "unplanned")]
    restored = _flatten(mgr.restore(run.state, 2, specs=run.specs,
                                    plan=run.plan))
    before = _differ(restored, run.pieces_of(saved))
    copy_into(run.state, _unflatten_into(run.state, restored))
    run.state = run.step(run.state, batch(2))
    out["same_mesh"] = {"before": before, "after": _differ(run.flat(), third)}
    # (b) the same checkpoint onto (1, 8), (4, 2) and, on rank 0, no plan
    for name in ("1x8", "4x2", "none"):
        if name == "none" and rank:
            continue
        other = _Planned(cfg, a["params"], meshes.get(name))
        restored = _flatten(mgr.restore(other.state, None, specs=other.specs,
                                        plan=other.plan))
        before = _differ(restored, other.pieces_of(saved))
        copy_into(other.state, _unflatten_into(other.state, restored))
        other.state = other.step(other.state, batch(2))
        got, want = other.flat(), other.pieces_of(third_whole)
        out[name] = {"before": before,
                     "params": _worst(got, want, "params/"),
                     "moments": max(_worst(got, want, "opt/m/"),
                                    _worst(got, want, "opt/v/")),
                     "step": int(other.state["opt"]["step"]),
                     "grad_norm": float(other.info["grad_norm"]),
                     "want_grad_norm": norm3}
        del other
    # (d) JAX's checkpoint of one planned step on (2, 4) onto the port's
    # (1, 8) plan, by parameter name, and its second step
    jax_state = CheckpointManager(a["jax_dir"]).restore(a["jax_state"])
    named = {"params": bridge.import_tree(jax_state["params"]),
             "opt": {"step": jax_state["opt"]["step"],
                     **{k: bridge.import_tree(jax_state["opt"][k])
                        for k in ("m", "v")}}}
    other = _Planned(cfg, a["params"], meshes["1x8"])
    copy_into(other.state, _unflatten_into(
        other.state, other.pieces_of(_flatten(named))))
    other.state = other.step(other.state, batch(1))
    whole = other.whole()
    out["from_jax"] = {"loss": float(other.info["loss"]),
                       "grad_norm": float(other.info["grad_norm"])}
    if rank == 0:
        out["from_jax"]["params"] = {k[len("params/"):]: t.numpy()
                                     for k, t in whole.items()
                                     if k.startswith("params/")}
    del other
    # (e) the loop on (2, 4): a crash at step 4, the resume from step 3,
    # against the same steps without a crash
    loop_run = _Planned(cfg, a["params"], meshes["2x4"])
    loop = FaultTolerantLoop(FTConfig(str(workdir / "loop"),
                                      checkpoint_every=3),
                             loop_run.state, specs=loop_run.specs,
                             plan=loop_run.plan)
    ended = loop.run_with_restarts(lambda: loop_run.state, loop_run.step,
                                   batch, 6, failure_at=4)
    once = _Planned(cfg, a["params"], meshes["2x4"])
    for i in range(6):
        once.state = once.step(once.state, batch(i))
    out["loop"] = {"resumed_from": loop.report.resumed_from,
                   "restarts": loop.report.restarts,
                   "committed": loop.mgr.steps(),
                   "step": int(ended["opt"]["step"]),
                   "differ": _differ(loop_run.flat(ended), once.flat())}
    return out


def case_checkpoint(inp):
    """A planned train state's checkpoint (``CheckpointManager.save``/
    ``restore`` with ``specs`` and ``plan``, ``FaultTolerantLoop``) for
    each arch of ``inp["archs"]`` in f32 on the JAX checkpoint body's
    weights and three batches (``inp["jax"][arch]``), AdamW lr 1e-3,
    warmup 2, under ``make_plan(cfg, mesh, "train", global_batch=4)``:
    (a) two steps on the (2, 4) mesh, an async save at step 2 (its
    gathers, and the files each rank wrote), a third step; the restore
    onto the same mesh (the pieces against ``shard_tensor`` of the saved
    whole) and the third step again, bitwise against the first;
    (b) the restore onto (1, 8), (4, 2) and, on rank 0, no plan, and the
    third step from each: the worst relative departure of the parameters
    and of the moments from the same pieces of the uninterrupted step, and
    the gradient norms; (c) on rank 0 an unplanned save of the gathered
    state at step 2 beside the planned one (their directories); (d) JAX's
    checkpoint of one planned step onto the (1, 8) plan by parameter name
    (``bridge.import_tree``) and the second step, its parameters gathered
    whole; (e) ``FaultTolerantLoop.run_with_restarts`` on (2, 4), 6 steps,
    a checkpoint every 3, a crash at step 4, against 6 steps without."""
    meshes = {name: make_test_mesh(d, m, device="cpu")
              for name, (d, m) in (("2x4", (2, 4)), ("1x8", (1, 8)),
                                   ("4x2", (4, 2)))}
    out = {"rank": dist.get_rank()}
    for arch in inp["archs"]:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        out[arch] = _checkpoint_arch(cfg, inp["jax"][arch], meshes,
                                     Path(inp["dir"]) / arch)
    return out


def case_remat(inp):
    """Each reduced arch in f32 under the (2, 2) train plan at batch 4,
    built from seed 0 twice, with ``remat`` off and on: the loss of
    ``inp["tokens"]`` and each parameter's gradient after backward (the
    rank's pieces), the collectives of the forward and of the backward,
    the weight gathers of the forward made outside the layers (the
    model-level ``Model._w``: the embedding and the unembedding) and the
    calls of ``torch.utils.checkpoint`` from ``train_trunk``."""
    mesh = make_test_mesh(2, 2, device="cpu")
    tokens = torch.from_numpy(inp["tokens"]).long()
    out = {"rank": dist.get_rank()}
    for arch in inp["archs"]:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        out[arch] = {}
        for remat in (False, True):
            model = Model(cfg, device="cpu", seed=0,
                          plan=make_plan(cfg, mesh, "train", global_batch=4,
                                         remat=remat))
            init_train_state(model)
            rows = model.batch_rows({"tokens": tokens})
            calls, outside = [], []

            def counted(*args, **kwargs):
                calls.append(1)
                return transformer_checkpoint(*args, **kwargs)

            def model_w(self, name):
                before = COLLECTIVES["weight_gather"]
                w = transformer_model_w(self, name)
                outside.append(COLLECTIVES["weight_gather"] - before)
                return w
            with mock.patch.object(transformer, "checkpoint", counted), \
                    mock.patch.object(Model, "_w", model_w):
                reset_collectives()
                loss = model.train_loss(rows)
                forward = dict(COLLECTIVES)
                outside_forward = sum(outside)
                reset_collectives()
                loss.backward()
            out[arch][remat] = {
                "loss": loss.detach().numpy(),
                "grads": {n: p.grad.numpy()
                          for n, p in model.named_parameters()},
                "forward": forward, "backward": dict(COLLECTIVES),
                "outside_gathers": outside_forward,
                "checkpoints": len(calls)}
    return out


transformer_checkpoint = transformer.checkpoint
transformer_model_w = Model._w

CASES = {"body": case_body, "moe": case_moe, "ffn": case_ffn,
         "model": case_model, "build": case_build,
         "seq_attention": case_seq_attention, "prefill": case_prefill,
         "train": case_train, "adjoints": case_adjoints,
         "compression": case_compression, "checkpoint": case_checkpoint,
         "remat": case_remat}

"""The port's sharded decode and prefill against the JAX package's, on
gloo ranks.

Each test spawns its ranks (``tests/torch_dist_ranks.py``: gloo on a
``FileStore`` under ``tmp_path``, one CPU process a rank) with its own
timeout of SPAWN_TIMEOUT seconds, and joins them; a hung collective fails
the one test.

(i) The bodies, against the JAX ones under its ``shard_map`` shim on
host devices (``tests/sharded_body_jax.py``, a subprocess, as
``tests/test_sharded.py`` runs its cases) on the same numpy-seeded inputs:
``attention.decode_attention_sharded`` on 4 ranks, an f32 and an int8
cache, the output to rel 2e-5 in f32 (each int8 slice rounds P * v_scale
against its own max on both sides), the updated slices bit for bit;
expert-parallel ``moe.apply_moe`` on 4 ranks in f32, x replicated
(``gather=False``, the decode's) and sequence-sharded (``gather=True``),
past the dropless bound with a skewed router (the same tokens lose a
pair), with int8 experts and with 6 experts on 4 ranks (whole on each,
rank 0 owns every pair), each rank's output to rel 2e-5 and the aux loss;
and reduced olmoe's ``Block._ffn`` under the (2, 4) decode plan, its aux
loss JAX's mean over the expert and batch axes (the port all-reduces over
the batch axis alone: an expert group's ranks route the same tokens).  (ii) ``case_decode`` of
``tests/sharded_cases.py:88-115``: reduced phi4-mini, gemma3-1b, olmoe,
moonshot and recurrentgemma at batch 4 on a (2, 4) mesh, phi4-mini and
mamba2 at batch 1 (a cache over ``(data, model)``, 8-way; JAX's
``decode_b1``), each rank's logits at 4 steps after a prefill to the JAX
single-device ``decode_step`` chain on bridged weights at rel < 1e-4,
each rank holding one whole weight at most while it draws and while it
loads its pieces; and two meshes where a mixer's specs disagree (mamba2
with 4 heads of 32 on 8 ranks: ``w_x`` cut mid-head, ``w_dt`` and the
``ssm`` state whole; recurrentgemma with W 48 on 3 ranks: ``w_x`` cut
off the 16 gate blocks, ``w_a`` whole).  (iii) every architecture builds
under a decode plan; prefill and train plans with ``attn_batch_shard``
raise ``NotImplementedError`` naming item 11e (the train plans
themselves: tests/test_torch_train_plan.py).  (iv) The
prefill under a plan: ``attention.ring_attention`` and
``local_attention`` on 4 sequence ranks against the JAX bodies under
``shard_map``; reduced phi4-mini, gemma3-1b (window 16 over slices of 8:
two neighbour slices), olmoe, internvl2-2b (12 image embeddings across
the first slice's end), musicgen-medium (sinusoidal positions), mamba2
and recurrentgemma prefilled under the (2, 4) prefill plan at batch 4
over 32 positions against the JAX package's prefill under the same plan
(logits to rel 2e-4, each rank's cache piece to rel 1e-5), then ``pad_cache`` into the decode plan's
layout and 4 decode steps under the decode plan against the JAX
``case_decode`` flow (rel 2e-4); every architecture prefilled under a
prefill plan against the port's model without one.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.attention import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.models.transformer import pad_cache as jax_pad_cache  # noqa: E402
from repro_torch.configs import get_reduced as port_reduced  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.sharding import make_plan  # noqa: E402
from tests import torch_dist_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 240.0   # seconds a spawn's ranks may take (the suite's
                        # per-test guard, tests/conftest.py, is 300)
BODY = Path(__file__).resolve().parent / "sharded_body_jax.py"
KEY = jax.random.PRNGKey(2)
PROMPT, STEPS = 27, 4   # a cache of 32 rows: steps at pos 27..30, across
                        # the 8-way slices' boundary at 28 (33 rows on a
                        # model axis of 3)
PREFILL_PROMPT = 32     # the planned prefill's: 8 positions a sequence rank


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / (np.max(np.abs(want)) + 1e-9))


# --------------------------------------------------------------------------- #
# (i) the body
# --------------------------------------------------------------------------- #

def _body_inputs(quant: bool, pos: int, b=2, s=32, h=8, kv=2, d=32):
    rng = np.random.default_rng(11 + pos + 100 * quant)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    inp = {"q": normal(b, h, d), "new_k": normal(b, kv, d),
           "new_v": normal(b, kv, d), "pos": np.int32(pos)}
    if quant:
        for n in ("k", "v"):
            qv, sc = jax_quantize_kv(jnp.asarray(normal(b, s, kv, d)))
            inp[n], inp[f"{n}_scale"] = np.array(qv), np.array(sc)
    else:
        inp["k"], inp["v"] = normal(b, s, kv, d), normal(b, s, kv, d)
    return inp


def _jax_body(inp, tmp_path, suffix=".npz"):
    """The JAX body of ``inp["kind"]`` (tests/sharded_body_jax.py) on
    ``inp``, passed as an npz (or, ``suffix`` ".pkl", a pickle)."""
    src, dst = tmp_path / f"body_in{suffix}", tmp_path / f"body_out{suffix}"
    if suffix == ".pkl":
        src.write_bytes(pickle.dumps(inp))
    else:
        np.savez(src, **inp)
    proc = subprocess.run(
        [sys.executable, str(BODY), str(src), str(dst)], capture_output=True,
        text=True, timeout=SPAWN_TIMEOUT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    if suffix == ".pkl":
        return pickle.loads(dst.read_bytes())
    return dict(np.load(dst))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("pos", [5, 21])
def test_sharded_body_matches_jax_shard_map(quant, pos, tmp_path):
    # pos 5: only slice 0 holds live rows (slices 1-3 weigh 0); pos 21:
    # slice 2 owns the write, slice 3 is empty
    inp = _body_inputs(quant, pos)
    want = _jax_body(inp, tmp_path)
    outs = ranks.spawn("body", 4, inp, tmp_path, SPAWN_TIMEOUT)
    for r in outs:
        assert _rel(r["out"], want["out"]) < 2e-5
        i, n = r["index"], 4
        for got, name in zip(r["caches"], ("k", "v", "k_scale", "v_scale")):
            s_loc = want[name].shape[1] // n
            np.testing.assert_array_equal(
                got, want[name][:, i * s_loc:(i + 1) * s_loc])
        # one all-reduce max and one all-reduce sum
        assert r["collectives"] == {"all_reduce": 2, "all_gather": 0,
                                    "reduce_scatter": 0, "shift": 0,
                                    "weight_gather": 0}
    assert sorted(r["index"] for r in outs) == [0, 1, 2, 3]


def _moe_inputs(t, gather, experts=8, quant=False, router_add=0.0):
    """Reduced olmoe's widths (d 64, f 32, top-2) with ``experts`` experts
    from ``init_moe(PRNGKey(3))`` (int8 with ``quant``), the router's
    column 0 raised by ``router_add``, x (t, d) f32 from ``default_rng``."""
    cfg = get_reduced("olmoe_1b_7b")
    p = jax_moe.init_moe(jax.random.PRNGKey(3), cfg.d_model, cfg.d_ff,
                         experts, jnp.float32, quant=quant)
    p = dict(p, router=p["router"].at[:, 0].add(router_add))
    x = np.random.default_rng(t).standard_normal(
        (t, cfg.d_model)).astype(np.float32)
    return {"kind": "moe", "x": x, "gather": gather, "top_k": cfg.top_k,
            "capacity_factor": cfg.capacity_factor,
            **{f"moe.{k}": np.asarray(v) for k, v in p.items()}}


@pytest.mark.parametrize("t,gather,experts,quant,router_add", [
    pytest.param(16, False, 8, False, 0.0, id="replicated"),
    pytest.param(32, True, 8, False, 0.0, id="gathered"),
    # 2400 tokens over the 4 ranks: T*k 4800 > 4096, capacity 750, and
    # expert 0 takes more than that
    pytest.param(2400, True, 8, False, 0.3, id="past-dropless"),
    pytest.param(16, False, 8, True, 0.0, id="int8-experts"),
    pytest.param(16, False, 6, False, 0.0, id="6-experts-replicated"),
    pytest.param(32, True, 6, False, 0.0, id="6-experts-gathered"),
])
def test_expert_parallel_moe_matches_jax_shard_map(t, gather, experts, quant,
                                                   router_add, tmp_path):
    inp = _moe_inputs(t, gather, experts, quant, router_add)
    want = _jax_body(inp, tmp_path)
    outs = ranks.spawn("moe", 4, inp, tmp_path, SPAWN_TIMEOUT)
    assert sorted(r["index"] for r in outs) == [0, 1, 2, 3]
    t_loc = t // 4 if gather else t
    for r in outs:
        rows = slice(r["index"] * t_loc, (r["index"] + 1) * t_loc) \
            if gather else slice(None)
        assert r["out"].shape == (t_loc, 64)
        assert _rel(r["out"], want["out"][rows]) < 2e-5
        np.testing.assert_allclose(r["aux"], float(want["aux"]), rtol=1e-6)
        # experts that do not divide stay whole: e_local = E
        assert r["e_local"] == (experts // 4 if experts % 4 == 0
                                else experts)
        assert r["collectives"] == {
            "all_reduce": int(not gather), "all_gather": int(gather),
            "reduce_scatter": int(gather), "shift": 0, "weight_gather": 0}
    if router_add:
        # the tokens that lost a pair: the rows apart from the dropless
        # oracle, the same in both packages, and some
        p = {k[4:]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith("moe.")}
        ref = np.asarray(jax_moe.apply_moe_ref(
            p, jnp.asarray(inp["x"]), top_k=2, n_experts=experts))
        got = np.concatenate([r["out"] for r in
                              sorted(outs, key=lambda r: r["index"])])
        jax_rows = np.abs(want["out"] - ref).max(1) > 1e-4
        port_rows = np.abs(got - ref).max(1) > 1e-4
        assert jax_rows.sum() > 0
        np.testing.assert_array_equal(port_rows, jax_rows)


def test_moe_ffn_under_a_decode_plan_matches_jax(tmp_path):
    # reduced olmoe's layer 0 on a (2, 4) mesh: experts over model, the
    # batch's rows over data, the aux loss JAX's mean over both
    cfg = dataclasses.replace(get_reduced("olmoe_1b_7b"), dtype="float32")
    params = JaxModel(cfg, ShardingPlan()).init(KEY)
    x = np.random.default_rng(5).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    layer0 = params["segments"][0]["blocks"][0]["moe"]
    inp = {"kind": "ffn", "arch": "olmoe_1b_7b", "mesh": (2, 4), "x": x,
           **{f"moe.{k}": np.asarray(v[0]) for k, v in layer0.items()}}
    want = _jax_body(inp, tmp_path)
    outs = ranks.spawn("ffn", 8, {**inp, "params": jax.tree.map(
        np.asarray, params)}, tmp_path, SPAWN_TIMEOUT)
    for r in outs:
        rows = slice(r["batch_index"] * 2, r["batch_index"] * 2 + 2)
        assert r["n_batch"] == 2
        assert _rel(r[True]["out"], want["out"][rows]) < 2e-5
        np.testing.assert_allclose(r[True]["aux"], float(want["aux"]),
                                   rtol=1e-6)
        # the output's all-reduce, then the aux loss's over the batch's
        # axis (it is the same on every rank of the experts' axis);
        # without the aux loss only the first
        assert r[True]["collectives"]["all_reduce"] == 2
        assert r[False]["collectives"]["all_reduce"] == 1
        np.testing.assert_array_equal(r[False]["out"], r[True]["out"])


# --------------------------------------------------------------------------- #
# (ii) the model: case_decode
# --------------------------------------------------------------------------- #

#: the mixers' per-head and per-channel leaves, which ``init`` sets to
#: one value each; drawn at random here, so that a rank slicing another
#: rank's heads or channels of them shows
CONSTANT_LEAVES = ("a_log", "dt_bias", "d_skip", "a_param")


def _vary_constants(params):
    def vary(path, leaf):
        name = getattr(path[-1], "key", None)
        if name not in CONSTANT_LEAVES:
            return leaf
        noise = np.random.default_rng(len(leaf.shape) + leaf.size).uniform(
            -0.5, 0.5, leaf.shape).astype(np.float32)
        return leaf + jnp.asarray(noise, leaf.dtype)
    return jax.tree_util.tree_map_with_path(vary, params)


def _jax_reference(arch: str, batch: int, rows: int = 32,
                   prompt: int = PROMPT, n_img: int = 0, **overrides):
    """JAX single-device decode of the reduced ``arch`` (with
    ``overrides`` of its config): prefill ``prompt`` positions (``n_img``
    seeded image embeddings, then tokens), pad the cache to ``rows`` rows,
    then STEPS decode steps; (numpy inputs of the rank case, the reference
    logits (STEPS, B, V))."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              **overrides)
    m_pre = JaxModel(cfg, ShardingPlan(mode="prefill"))
    m_dec = JaxModel(cfg, ShardingPlan(mode="decode"))
    params = _vary_constants(m_pre.init(KEY))
    lora = m_pre.init_lora(KEY, 4, 4)
    text = prompt - n_img
    tokens = jax.random.randint(KEY, (batch, text + STEPS), 0,
                                cfg.vocab_size)
    img = jax.random.normal(jax.random.fold_in(KEY, 7),
                            (batch, n_img, cfg.d_model)) if n_img else None
    idx = jnp.arange(batch, dtype=jnp.int32) % 4
    _, cache = jax.jit(m_pre.prefill)(params, lora, tokens[:, :text], idx,
                                      img)
    cache = jax_pad_cache(cache, rows - prompt)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    inputs = {"arch": arch, "overrides": overrides,
              "params": to_np(params), "lora": to_np(lora),
              "cache": to_np(cache),
              "tokens": np.asarray(tokens[:, text:], np.int32),
              "all_tokens": np.asarray(tokens, np.int32),
              "img": None if img is None else np.asarray(img),
              "idx": np.asarray(idx, np.int32), "rows": rows}
    step = jax.jit(m_dec.decode_step)
    want = []
    for i in range(STEPS):
        logits, cache = step(params, lora, cache,
                             tokens[:, text + i:text + i + 1], idx)
        want.append(np.asarray(logits))
    return inputs, np.stack(want)


@pytest.mark.parametrize("arch,batch", [("phi4_mini_3p8b", 4),
                                        ("gemma3_1b", 4),
                                        ("phi4_mini_3p8b", 1)])
def test_case_decode_matches_jax(arch, batch, tmp_path):
    inputs, want = _jax_reference(arch, batch)
    inputs["mesh"] = (2, 4)
    outs = ranks.spawn("model", 8, inputs, tmp_path, SPAWN_TIMEOUT)
    n_cache = 4 if batch > 1 else 8
    assert sorted({r["cache_index"] for r in outs}) == list(range(n_cache))
    _check_ranks(outs, want, batch)
    for r in outs:
        # resident TP: q/k/v column-, wo and w_down row-sharded over model
        assert r["specs"]["layers.0.wq"] == (None, "model")
        assert r["specs"]["layers.0.wo"] == ("model", None)
        assert r["specs"]["layers.0.mlp.w_down"] == ("model", None)
        assert r["specs"]["embed.embed"] == (None, None)
    assert {r["n_batch"] for r in outs} == {2 if batch > 1 else 1}


def test_case_decode_where_widths_do_not_divide(tmp_path):
    # a model axis of 3: gemma3's 48-wide q/k/v/o and 512-row vocab stay
    # whole (_fits), its 96-wide MLP is cut; the 33-row cache in slices
    # of 11
    inputs, want = _jax_reference("gemma3_1b", 2, rows=33)
    inputs["mesh"] = (2, 3)
    outs = ranks.spawn("model", 6, inputs, tmp_path, SPAWN_TIMEOUT)
    assert sorted({r["cache_index"] for r in outs}) == [0, 1, 2]
    _check_ranks(outs, want, 2)
    for r in outs:
        assert r["specs"]["layers.0.wq"] == (None, None)
        assert r["specs"]["layers.0.wo"] == (None, None)
        assert r["specs"]["layers.0.mlp.w_down"] == ("model", None)


# the experts' and the mixers' specs under the (2, 4) decode plan, and the
# leaves each mixer's code reads as cut (``WidthShards``; None: a layer
# with attention)
MOE_SPECS = {"layers.0.moe.w_gate": ("model", None, None),
             "layers.0.moe.w_down": ("model", None, None),
             "layers.0.moe.router": (None, None),
             "layers.0.wq": (None, "model")}
SSD_CUT = ["cache.conv_x", "cache.ssm", "conv_x", "w_dt", "w_out", "w_x",
           "w_z"]
RGLRU_CUT = ["cache.conv", "cache.lru", "conv_w", "w_a", "w_gate", "w_i",
             "w_out", "w_x"]


@pytest.mark.parametrize("arch,batch,specs,cut", [
    ("olmoe_1b_7b", 4, MOE_SPECS, [None] * 2),
    ("moonshot_v1_16b_a3b", 4, MOE_SPECS, [None] * 2),
    ("mamba2_2p7b", 1, {"layers.0.ssd.w_x": (None, "model"),
                        "layers.0.ssd.w_dt": (None, "model"),
                        "layers.0.ssd.w_out": ("model", None),
                        "layers.0.ssd.w_bc": (None, None)}, [SSD_CUT] * 2),
    ("recurrentgemma_9b", 4, {"layers.0.rglru.w_a": ("model", None, None),
                              "layers.0.rglru.w_out": ("model", None),
                              "layers.0.mlp.w_down": ("model", None),
                              "layers.2.wq": (None, "model")},
     [RGLRU_CUT, RGLRU_CUT, None, RGLRU_CUT, RGLRU_CUT]),
])
def test_moe_and_state_models_decode_like_jax(arch, batch, specs, cut,
                                              tmp_path):
    inputs, want = _jax_reference(arch, batch)
    inputs["mesh"] = (2, 4)
    outs = ranks.spawn("model", 8, inputs, tmp_path, SPAWN_TIMEOUT)
    n_cache = 4 if batch > 1 else 8
    assert sorted({r["cache_index"] for r in outs}) == list(range(n_cache))
    _check_ranks(outs, want, batch)
    for r in outs:
        assert {n: r["specs"][n] for n in specs} == specs
        assert r["width_cut"] == cut


@pytest.mark.parametrize("arch,mesh,overrides,specs,cut", [
    # H 4 on 8 ranks: d_inner 128 is cut (16 channels, half a head), the
    # heads are not; x after its conv is gathered for the scan
    ("mamba2_2p7b", (1, 8), {"ssm_head_dim": 32},
     {"layers.0.ssd.w_x": (None, "model"), "layers.0.ssd.w_dt": (None, None),
      "layers.0.ssd.w_out": ("model", None)},
     ["cache.conv_x", "conv_x", "w_out", "w_x", "w_z"]),
    # W 48 on 3 ranks: 16 channels a rank, 16 gate blocks of 3 are not cut;
    # the gates' input is gathered
    ("recurrentgemma_9b", (1, 3), {"lru_width": 48},
     {"layers.0.rglru.w_x": (None, "model"),
      "layers.0.rglru.w_a": (None, None, None),
      "layers.0.rglru.w_out": ("model", None)},
     ["cache.conv", "cache.lru", "conv_w", "w_gate", "w_out", "w_x"]),
])
def test_mixers_whose_specs_disagree_decode_like_jax(arch, mesh, overrides,
                                                     specs, cut, tmp_path):
    inputs, want = _jax_reference(arch, 2, **overrides)
    inputs["mesh"] = mesh
    outs = ranks.spawn("model", mesh[0] * mesh[1], inputs, tmp_path,
                       SPAWN_TIMEOUT)
    _check_ranks(outs, want, 2)
    for r in outs:
        assert {n: r["specs"][n] for n in specs} == specs
        assert r["width_cut"][0] == cut


def _check_ranks(outs, want, batch):
    """Each rank's rows of the logits at every step to rel 1e-4 of the
    JAX decode's; its cache advanced; ``init_cache`` the rank's shapes."""
    for r in outs:
        nb, bi = r["n_batch"], r["batch_index"]
        rows = slice(bi * batch // nb, (bi + 1) * batch // nb)
        assert r["logits"].shape == (STEPS, batch // nb) + want.shape[2:]
        assert _rel(r["logits"], want[:, rows]) < 1e-4
        assert r["pos"] == PROMPT + STEPS
        assert r["init_shapes"]
        assert r["collectives"]["all_reduce"] > 0
        # each weight cut as it was drawn, and as it was carried across:
        # the rank never held two whole weights at once
        assert r["whole_at_cut"] == (1, 1)


# --------------------------------------------------------------------------- #
# (iii) which plans the port takes
# --------------------------------------------------------------------------- #

def test_every_architecture_builds_under_a_decode_plan(tmp_path):
    outs = ranks.spawn("build", 8, {"archs": list(ARCH_IDS)}, tmp_path,
                       SPAWN_TIMEOUT)
    for r in outs:
        assert r == {a: (4, 4) for a in ARCH_IDS}


def test_prefill_and_train_plans_raise():
    # the prefill and train plans the port refuses: batch-parallel
    # attention over the sequence axis (the hill-climb's variant), item 11e
    cfg = port_reduced("phi4-mini-3.8b")
    mesh = MeshShape((2, 4), ("data", "model"))
    for kind in ("prefill", "train"):
        plan = dataclasses.replace(make_plan(cfg, mesh, kind, global_batch=4),
                                   attn_batch_shard=True)
        with pytest.raises(NotImplementedError, match="item 11e"):
            Model(cfg, device="cpu", plan=plan)


def test_every_architecture_builds_under_a_prefill_plan(tmp_path):
    # the attention families cut the sequence over model (4 slices), the
    # SSM and hybrid ones keep it whole; every one prefills as the model
    # without a plan does
    outs = ranks.spawn("build", 8, {"archs": list(ARCH_IDS),
                                    "kind": "prefill"}, tmp_path,
                       SPAWN_TIMEOUT)
    for r in outs:
        assert set(r) == set(ARCH_IDS)
        for arch, (width, cache, got, want, pos) in r.items():
            assert (width, cache) == (4, 4)
            assert got.shape == want.shape == (2, want.shape[1])
            assert np.isfinite(got).all()
            assert _rel(got, want) < 2e-4, arch
            assert pos == 32


# --------------------------------------------------------------------------- #
# (iv) the prefill under a plan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("window,shifts", [
    pytest.param(0, 3, id="ring"),
    # a window of 16 over slices of 8: the two slices before
    pytest.param(16, 2, id="local-two-slices"),
    pytest.param(5, 1, id="local-one-slice"),
    # past the whole sequence: capped at the other 3 slices
    pytest.param(40, 3, id="local-capped"),
])
def test_sequence_sharded_attention_matches_jax_shard_map(window, shifts,
                                                          tmp_path):
    rng = np.random.default_rng(21 + window)
    b, s, h, kv, d = 2, 32, 4, 2, 16
    inp = {"kind": "seq_attention", "window": window,
           "q": rng.standard_normal((b, s, h, d)).astype(np.float32),
           "k": rng.standard_normal((b, s, kv, d)).astype(np.float32),
           "v": rng.standard_normal((b, s, kv, d)).astype(np.float32)}
    want = _jax_body(inp, tmp_path)["out"]
    outs = ranks.spawn("seq_attention", 4, inp, tmp_path, SPAWN_TIMEOUT)
    assert sorted(r["index"] for r in outs) == [0, 1, 2, 3]
    for r in outs:
        i = r["index"]
        assert _rel(r["out"], want[:, i * 8:(i + 1) * 8]) < 2e-5
        assert r["collectives"]["shift"] == shifts


@pytest.mark.parametrize("archs,batch,rows", [
    # internvl2 with 12 image embeddings, across the first slice's end;
    # musicgen's sinusoidal positions at each slice's global positions
    pytest.param(("phi4_mini_3p8b", "gemma3_1b", "olmoe_1b_7b",
                  "internvl2_2b", "musicgen_medium"), 4, 36,
                 id="attention"),
    pytest.param(("mamba2_2p7b", "recurrentgemma_9b"), 4, 36, id="state"),
    # batch 1: the prefill plan has no batch axis, the decode plan cuts the
    # cache over (data, model), 8 slices of 5 rows
    pytest.param(("phi4_mini_3p8b",), 1, 40, id="batch-1"),
])
def test_prefill_under_a_plan_matches_jax(archs, batch, rows, tmp_path):
    refs = {a: _jax_reference(a, batch, rows=rows, prompt=PREFILL_PROMPT,
                              n_img=12 if a == "internvl2_2b" else 0)
            for a in archs}
    per_arch = {a: {"params": inp["params"], "lora": inp["lora"],
                    "tokens": inp["all_tokens"], "idx": inp["idx"],
                    "img": inp["img"]}
                for a, (inp, _) in refs.items()}
    planned = _jax_body({"kind": "prefill", "mesh": (2, 4),
                         "prompt": PREFILL_PROMPT, "archs": per_arch},
                        tmp_path, suffix=".pkl")
    for a in archs:
        per_arch[a]["jax_cache"] = planned[a]["cache"]
    outs = ranks.spawn("prefill", 8, {"archs": per_arch, "steps": STEPS,
                                      "prompt": PREFILL_PROMPT, "rows": rows},
                       tmp_path, SPAWN_TIMEOUT)
    n_batch = 2 if batch > 1 else 1
    for a in archs:
        attention_family = a not in ("mamba2_2p7b", "recurrentgemma_9b")
        n_seq = 4 if attention_family else 1
        assert sorted({r[a]["seq_index"] for r in outs}) == list(range(n_seq))
        assert sorted({r[a]["cache_index"] for r in outs}) == \
            list(range(8 // n_batch))
        for r in outs:
            o = r[a]
            assert (o["n_seq"], o["n_batch"]) == (n_seq, n_batch)
            bi, per = o["batch_index"], batch // n_batch
            batch_rows = slice(bi * per, (bi + 1) * per)
            assert _rel(o["logits"], planned[a]["logits"][batch_rows]) < 2e-4
            worst = max(o["cache_rel"], key=o["cache_rel"].get)
            assert o["cache_rel"][worst] < 1e-5, (a, worst)
            assert o["pos"] == PREFILL_PROMPT
            assert o["arrival_ok"] and o["shapes_ok"]
            assert _rel(o["decode"], refs[a][1][:, batch_rows]) < 2e-4
            assert o["decode_pos"] == PREFILL_PROMPT + STEPS
            c = o["collectives"]
            if attention_family:   # the ring, and the weights gathered
                assert c["shift"] > 0 and c["weight_gather"] > 0
            else:                  # width-TP over the whole sequence
                assert c["shift"] == c["weight_gather"] == 0
                assert c["all_reduce"] > 0

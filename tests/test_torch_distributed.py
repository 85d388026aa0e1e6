"""The port's sharded decode against the JAX package's, on gloo ranks.

Each test spawns its ranks (``tests/torch_dist_ranks.py``: gloo on a
``FileStore`` under ``tmp_path``, one CPU process a rank) with its own
timeout of SPAWN_TIMEOUT seconds, and joins them; a hung collective fails
the one test.

(i) ``attention.decode_attention_sharded`` on 4 ranks, an f32 and an
int8 cache, against the JAX body under its ``shard_map`` shim on 4 host
devices (``tests/sharded_body_jax.py``, a subprocess, as
``tests/test_sharded.py`` runs its cases) on the same numpy-seeded inputs:
the output to rel 2e-5 in f32 (each int8 slice rounds P * v_scale against
its own max on both sides), the updated slices bit for bit.  (ii) ``case_decode`` of
``tests/sharded_cases.py:88-115``: reduced phi4-mini and gemma3-1b at
batch 4 on a (2, 4) mesh and phi4-mini at batch 1 (its cache over
``(data, model)``, 8-way), each rank's logits at 4 steps after a prefill
to the JAX single-device ``decode_step`` chain on bridged weights at
rel < 1e-4, each rank holding one whole weight at most while it draws and
while it loads its pieces.  (iii) MoE, SSM and hybrid models under a plan of width 4
raise ``NotImplementedError`` naming ROADMAP item 11b.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
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


def _jax_body(inp, tmp_path):
    src, dst = tmp_path / "body_in.npz", tmp_path / "body_out.npz"
    np.savez(src, **inp)
    proc = subprocess.run(
        [sys.executable, str(BODY), str(src), str(dst)], capture_output=True,
        text=True, timeout=SPAWN_TIMEOUT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
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
        assert r["collectives"] == {"all_reduce": 2, "all_gather": 0}
    assert sorted(r["index"] for r in outs) == [0, 1, 2, 3]


# --------------------------------------------------------------------------- #
# (ii) the model: case_decode
# --------------------------------------------------------------------------- #

def _jax_reference(arch: str, batch: int, rows: int = 32):
    """JAX single-device decode: prefill PROMPT tokens, pad the cache to
    ``rows`` rows, then STEPS decode steps; (numpy inputs of the rank
    case, the reference logits (STEPS, B, V))."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    m_pre = JaxModel(cfg, ShardingPlan(mode="prefill"))
    m_dec = JaxModel(cfg, ShardingPlan(mode="decode"))
    params = m_pre.init(KEY)
    lora = m_pre.init_lora(KEY, 4, 4)
    tokens = jax.random.randint(KEY, (batch, PROMPT + STEPS), 0,
                                cfg.vocab_size)
    idx = jnp.arange(batch, dtype=jnp.int32) % 4
    _, cache = jax.jit(m_pre.prefill)(params, lora, tokens[:, :PROMPT], idx)
    cache = jax_pad_cache(cache, rows - PROMPT)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    inputs = {"arch": arch, "params": to_np(params), "lora": to_np(lora),
              "cache": to_np(cache),
              "tokens": np.asarray(tokens[:, PROMPT:], np.int32),
              "idx": np.asarray(idx, np.int32), "rows": rows}
    step = jax.jit(m_dec.decode_step)
    want = []
    for i in range(STEPS):
        logits, cache = step(params, lora, cache,
                             tokens[:, PROMPT + i:PROMPT + i + 1], idx)
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
# (iii) what the port does not shard yet
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_moe_and_state_mixers_raise_under_a_wide_plan(arch):
    cfg = port_reduced(arch)
    plan = make_plan(cfg, MeshShape((2, 4), ("data", "model")), "decode",
                     global_batch=4)
    assert plan.n_width == 4
    with pytest.raises(NotImplementedError, match="item 11b"):
        Model(cfg, device="cpu", plan=plan)


def test_prefill_and_train_plans_raise():
    cfg = port_reduced("phi4-mini-3.8b")
    mesh = MeshShape((2, 4), ("data", "model"))
    for kind in ("prefill", "train"):
        with pytest.raises(NotImplementedError, match="11b and 11c"):
            Model(cfg, device="cpu", plan=make_plan(cfg, mesh, kind,
                                                    global_batch=4))

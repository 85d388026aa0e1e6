"""The port's RG-LRU mixer and recurrentgemma against the JAX package, on
the same numpy inputs and bridged weights.

The mixer's pieces (``ssm.causal_conv`` with and without a state,
``rglru.rglru_scan`` with and without h0, ``rglru.apply_rglru`` in prefill
and in its O(1) decode, and the states each returns) within 2e-5 in f32
and 3e-2 in bf16 of ``repro.models.{ssm,rglru}``; reduced recurrentgemma
(2 rglru layers, 1 local, 2 rglru; window 16) in f32 within a relative
error of 2e-4 (test_consistency.py:39) of the JAX ``Model``: prefill
logits, the prefill cache (conv and lru states, the rolling buffer), and a
decode chain from the prefill cache over prompts longer than the window,
so the rolling buffer wraps; the bridge's round trips of the rglru
parameters, of the JAX LoRA placeholder ``{"_": ...}`` and of the state
caches; and the JAX executor's ``lora_count()`` of 1 on recurrentgemma
against the port's N (ROADMAP.md queue 3, reference behaviours).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models import rglru as jrglru, ssm as jssm  # noqa: E402
from repro.models.transformer import pad_cache as jax_pad_cache  # noqa: E402
from repro.serving.executor import JaxExecutor  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.serving.executor import TorchExecutor  # noqa: E402

ARCH = "recurrentgemma-9b"
KEY = jax.random.PRNGKey(1)
DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 3e-2)}
B = 2


def _both(arr, dtype):
    """One array as (jax array, torch tensor) with identical bits."""
    j = jnp.asarray(arr).astype(dtype)
    return j, bridge.tensor(np.asarray(j))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / (np.max(np.abs(want)) + 1e-9))


def test_config_equals_jax_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == \
        dataclasses.asdict(jax_reduced(ARCH))
    cfg = get_config(ARCH)
    assert cfg.layer_kinds.count("rglru") == 26
    assert cfg.layer_kinds.count("local") == 12
    assert cfg.n_heads // cfg.n_kv_heads == 16


# --------------------------------------------------------------------------- #
# the mixer's pieces
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("activate", [False, True])
@pytest.mark.parametrize("s", [1, 2, 7])
def test_causal_conv_matches_jax(s, activate, with_state, dtype):
    # S below, at and past the conv's width - 1 (3)
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s)
    jx, tx = _both(rng.standard_normal((B, s, 24)), jdt)
    jw, tw = _both(rng.standard_normal((4, 24)) * 0.3, jdt)
    js, ts = (None, None)
    if with_state:
        js, ts = _both(rng.standard_normal((B, 3, 24)), jdt)
    want, want_state = jssm.causal_conv(jx, jw, state=js, activate=activate)
    got, state = ssm.causal_conv(tx, tw, state=ts, activate=activate)
    assert got.dtype == tx.dtype and state.shape == (B, 3, 24)
    _close(got, want, tol)
    _close(state, want_state, tol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 5, 33])
def test_rglru_scan_matches_jax(s, with_h0):
    rng = np.random.default_rng(7 + s)
    a = rng.uniform(0.2, 1.0, (B, s, 16)).astype(np.float32)
    bx = rng.standard_normal((B, s, 16)).astype(np.float32)
    h0 = rng.standard_normal((B, 16)).astype(np.float32) if with_h0 else None
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(bx),
                             None if h0 is None else jnp.asarray(h0))
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                           None if h0 is None else torch.from_numpy(h0))
    _close(got, want, 2e-5)
    # and the plain recurrence, step by step
    h = np.zeros((B, 16), np.float32) if h0 is None else h0
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
    np.testing.assert_allclose(got[:, -1].numpy(), h, rtol=2e-5, atol=2e-5)


def _mixer(dtype):
    """The reduced config's mixer parameters from the JAX initialiser
    (a_param drawn off 1 so the softplus is exercised), as (JAX tree,
    port tensors)."""
    cfg = dataclasses.replace(jax_reduced(ARCH), dtype=dtype)
    p = jrglru.init_rglru(KEY, cfg, cfg.jnp_dtype)
    p["a_param"] = jax.random.normal(jax.random.PRNGKey(9),
                                     p["a_param"].shape) * 2.0
    return cfg, p, bridge.to_torch(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_lru", [False, True])
def test_apply_rglru_prefill_matches_jax(with_lru, dtype):
    jdt, tol = DTYPES[dtype]
    cfg, jp, tp = _mixer(dtype)
    rng = np.random.default_rng(11)
    jx, tx = _both(rng.standard_normal((B, 13, cfg.d_model)), jdt)
    lru = rng.standard_normal((B, cfg.lru_width)).astype(np.float32) \
        if with_lru else None
    want, (wconv, wlru) = jrglru.apply_rglru(
        jp, jx, lru_state=None if lru is None else jnp.asarray(lru))
    got, (conv, state) = rglru.apply_rglru(
        tp, tx, lru_state=None if lru is None else torch.from_numpy(lru))
    assert got.dtype == tx.dtype and conv.dtype == tx.dtype
    assert state.dtype == torch.float32
    _close(got, want, tol)
    _close(conv, wconv, tol)
    _close(state, wlru, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rglru_decode_matches_jax_in_place(dtype):
    jdt, tol = DTYPES[dtype]
    cfg, jp, tp = _mixer(dtype)
    rng = np.random.default_rng(12)
    jconv, tconv = _both(rng.standard_normal((B, 3, cfg.lru_width)), jdt)
    lru = rng.standard_normal((B, cfg.lru_width)).astype(np.float32)
    tlru = torch.from_numpy(lru.copy())
    jlru = jnp.asarray(lru)
    for step in range(4):
        jx, tx = _both(rng.standard_normal((B, 1, cfg.d_model)), jdt)
        want, (jconv, jlru) = jrglru.apply_rglru(jp, jx, conv_state=jconv,
                                                 lru_state=jlru)
        got, (conv, state) = rglru.apply_rglru(tp, tx, conv_state=tconv,
                                               lru_state=tlru)
        # the states are the tensors given, written in place
        assert conv is tconv and state is tlru
        _close(got, want, tol)
        _close(tconv, jconv, tol)
        _close(tlru, jlru, tol)


# --------------------------------------------------------------------------- #
# reduced recurrentgemma on bridged weights
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def pair():
    """(JAX prefill model, JAX decode model, params, lora, port model, port
    lora) on the same float32 weights of reduced recurrentgemma."""
    cfg = dataclasses.replace(jax_reduced(ARCH), dtype="float32")
    jm = JaxModel(cfg, ShardingPlan(mode="prefill"))
    jd = JaxModel(cfg, ShardingPlan(mode="decode"))
    params, lora = jm.init(KEY), jm.init_lora(KEY, 4, 4)
    model = Model(dataclasses.replace(get_reduced(ARCH), dtype="float32"),
                  device="cpu")
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    return jm, jd, params, lora, model, bridge.lora_to_torch(
        jax.tree.map(np.asarray, lora))


def _tokens(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
            np.asarray([1, 2], np.int32))


@pytest.mark.parametrize("s", [9, 24, 40])
def test_prefill_logits_and_cache_match_jax(pair, s):
    # the window is 16: 9 tokens fill 9 rows of the local layer's buffer,
    # 24 and 40 roll it
    jm, _, params, lora, model, port_lora = pair
    tokens, idx = _tokens(model.cfg, s)
    want, jcache = jm.prefill(params, lora, tokens, idx)
    got, cache = model.prefill(port_lora, torch.from_numpy(tokens).long(),
                               torch.from_numpy(idx))
    assert _rel(got, want) < 2e-4
    kinds = model.cfg.layer_kinds
    assert [set(c) for c in cache["layers"]] == [
        {"conv", "lru"} if k == "rglru" else {"k_loc", "v_loc"}
        for k in kinds]
    conv = cache["layers"][0]["conv"]
    assert conv.shape == (B, 3, 64) and conv.dtype == torch.float32
    assert cache["layers"][0]["lru"].shape == (B, 64)
    got_tree = bridge.cache_to_numpy(cache, model.cfg)
    for g, w in zip(jax.tree.leaves(got_tree["segments"]),
                    jax.tree.leaves(jcache["segments"])):
        assert g.shape == w.shape and _rel(g, w) < 2e-4


@pytest.mark.parametrize("s", [17, 23])
def test_decode_chain_matches_jax(pair, s):
    # a prefill of s - 1 tokens past the window, then 6 decode steps with
    # the teacher's tokens: the rolling buffer wraps, the RG-LRU decodes
    # from its scanned state
    jm, jd, params, lora, model, port_lora = pair
    tokens, idx = _tokens(model.cfg, s + 6, seed=s)
    t_tok, t_idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    _, jcache = jm.prefill(params, lora, tokens[:, :s - 1], idx)
    jcache = jax_pad_cache(jcache, 8)
    _, cache = model.prefill(port_lora, t_tok[:, :s - 1], t_idx)
    cache = model.pad_cache(cache, 8)
    step = jax.jit(jd.decode_step)
    for i in range(s - 1, s + 5):
        want, jcache = step(params, lora, jcache, tokens[:, i:i + 1], idx)
        got, cache = model.decode_step(port_lora, cache, t_tok[:, i:i + 1],
                                       t_idx)
        assert _rel(got, want) < 2e-4, f"position {i}"
    assert int(cache["pos"]) == int(jcache["pos"]) == s + 5
    got_tree = bridge.cache_to_numpy(cache, model.cfg)
    for g, w in zip(jax.tree.leaves(got_tree["segments"]),
                    jax.tree.leaves(jcache["segments"])):
        assert _rel(g, w) < 2e-4
    # teacher forcing: the last decode against the prefill of the tokens
    # it has seen
    full, _ = model.prefill(port_lora, t_tok[:, :s + 5], t_idx)
    assert _rel(got, full.numpy()) < 2e-4


def test_rglru_layers_have_no_lora_and_adapters_reach_local_layers(pair):
    _, _, params, lora, model, port_lora = pair
    assert [bool(b) for b in port_lora["layers"]] == [
        k == "local" for k in model.cfg.layer_kinds]
    assert model.init_lora(4, 4)["layers"][0] == {}
    tokens, _ = _tokens(model.cfg, 12)
    t_tok = torch.from_numpy(tokens).long()
    a, _ = model.prefill(port_lora, t_tok, torch.tensor([0, 0],
                                                        dtype=torch.int32))
    b, _ = model.prefill(port_lora, t_tok, torch.tensor([3, 0],
                                                        dtype=torch.int32))
    assert not torch.allclose(a[0], b[0]) and torch.equal(a[1], b[1])


# --------------------------------------------------------------------------- #
# the bridge
# --------------------------------------------------------------------------- #

def _assert_bitwise(want, got):
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert w.tobytes() == g.tobytes()


@pytest.fixture(params=["bfloat16", "float32"])
def models(request):
    cfg = dataclasses.replace(jax_reduced(ARCH), dtype=request.param)
    return (JaxModel(cfg, ShardingPlan(mode="prefill")),
            Model(dataclasses.replace(get_reduced(ARCH),
                                      dtype=request.param), device="cpu"))


def test_params_round_trip_bitwise(models):
    jm, model = models
    params = jax.tree.map(np.asarray, jm.init(KEY))
    bridge.load_params(model, params)
    _assert_bitwise(params, bridge.export_params(model))
    # layer 4, the second block of the (rglru, rglru) remainder segment
    blk = params["segments"][1]["blocks"][1]["rglru"]
    np.testing.assert_array_equal(bridge.array(model.layers[4].rglru["w_a"]),
                                  blk["w_a"][0])
    assert model.layers[0].rglru["a_param"].dtype == torch.float32
    assert model.layers[0].rglru["w_a"].shape == (16, 4, 4)


def test_lora_placeholder_round_trip_bitwise(models):
    jm, model = models
    lora = jax.tree.map(np.asarray, jm.init_lora(KEY, 4, 8))
    assert "_" in lora["segments"][0]["blocks"][0]
    port = bridge.lora_to_torch(lora)
    assert port["layers"][0] == {} and port["layers"][1] == {}
    assert port["layers"][2]["a_q"].shape == (4, model.cfg.d_model, 8)
    _assert_bitwise(lora, bridge.lora_to_numpy(port, model.cfg))


def test_state_cache_round_trip_bitwise(models):
    jm, model = models
    init = jax.tree.map(np.asarray, jm.init_cache(B, 16))
    _assert_bitwise(init, bridge.cache_to_numpy(bridge.cache_to_torch(init),
                                                model.cfg))
    # the port's own zero cache: the same keys, shapes and dtypes
    _assert_bitwise(init, bridge.cache_to_numpy(model.init_cache(B, 16),
                                                model.cfg))
    tokens, _ = _tokens(model.cfg, 12)
    _, cache = jm.prefill(jm.init(KEY), None, tokens)
    cache = jax.tree.map(np.asarray, cache)
    port = bridge.cache_to_torch(cache)
    assert port["layers"][0]["lru"].dtype == torch.float32
    assert port["layers"][0]["conv"].dtype == model.cfg.torch_dtype
    _assert_bitwise(cache, bridge.cache_to_numpy(port, model.cfg))


# --------------------------------------------------------------------------- #
# the executor's adapter count
# --------------------------------------------------------------------------- #

def test_lora_count_jax_one_port_n(pair):
    # the JAX executor reads segment 0's first block, an rglru block whose
    # placeholder is (repeats, 1): every request is served on adapter 0;
    # the port reads the first layer with a bank (ROADMAP.md queue 3)
    jm, jd, params, lora, model, port_lora = pair
    jex = JaxExecutor(jd, params, lora, max_batch=2, cache_len=8)
    assert jex.lora_count() == 1
    ex = TorchExecutor(model, port_lora, max_batch=2, cache_len=8,
                       device="cpu")
    assert ex.lora_count() == 4

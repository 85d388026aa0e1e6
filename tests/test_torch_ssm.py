"""The port's Mamba2 / SSD mixer and mamba2 against the JAX package, on the
same numpy inputs and bridged weights.

The mixer's pieces (``ssm.ssd_chunked`` with and without an initial state
at S 8, 24, 12 and 13: one chunk, three chunks, the chunk shrunk to 6 and a
prime length that runs chunks of 1, and ``ssm.apply_ssd`` in prefill and
in its O(1) decode, with the states each returns) within 2e-5 in f32 and
3e-2 in bf16 of ``repro.models.ssm``; reduced mamba2 (2 ssd layers, d 64,
state 16, head dim 16, chunk 8) in f32 within a relative error of 2e-4
(test_consistency.py:39) of the JAX ``Model``: prefill logits, the prefill
cache (conv_x, conv_bc and ssm states) and a decode chain from it, whose
states the port writes in place; the bridge's round trips of the ssd
parameters, of every layer's LoRA placeholder ``{"_": ...}`` and of the
state caches; and both executors' ``lora_count()`` of 1, so every request
runs as adapter 0 on both sides, with no kernel wrapper launched.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import pad_cache as jax_pad_cache  # noqa: E402
from repro.serving.executor import JaxExecutor  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model, ssm  # noqa: E402
from repro_torch.serving.executor import TorchExecutor  # noqa: E402

ARCH = "mamba2-2.7b"
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
    assert cfg.layer_kinds == ("ssd",) * 64
    assert ssm.ssd_dims(cfg) == jssm.ssd_dims(cfg) == (5120, 80, 64, 128)
    assert round(cfg.param_count() / 1e9, 2) == 2.83


# --------------------------------------------------------------------------- #
# the mixer's pieces
# --------------------------------------------------------------------------- #

def _scan_inputs(s, dtype, seed):
    """x (B, S, 4, 8), b and c (B, S, 16) in ``dtype``, dt (B, S, 4) f32
    after the softplus, a_log (4,) f32, and a (B, 4, 8, 16) f32 state, each
    as (jax array, torch tensor)."""
    rng = np.random.default_rng(seed)
    jx, tx = _both(rng.standard_normal((B, s, 4, 8)), dtype)
    jb, tb = _both(rng.standard_normal((B, s, 16)) * 0.5, dtype)
    jc, tc = _both(rng.standard_normal((B, s, 16)) * 0.5, dtype)
    jdt, tdt = _both(np.log1p(np.exp(rng.standard_normal((B, s, 4)) - 1.0)),
                     jnp.float32)
    ja, ta = _both(rng.standard_normal(4) * 0.5, jnp.float32)
    jst, tst = _both(rng.standard_normal((B, 4, 8, 16)), jnp.float32)
    return (jx, jb, jc, jdt, ja, jst), (tx, tb, tc, tdt, ta, tst)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [8, 24, 12, 13])
def test_ssd_chunked_matches_jax(s, with_state, dtype):
    # chunk 8: S 8 one chunk, 24 three, 12 shrinks the chunk to 6, the
    # prime 13 to 1
    jdt, tol = DTYPES[dtype]
    (jx, jb, jc, jd, ja, jst), (tx, tb, tc, td, ta, tst) = \
        _scan_inputs(s, jdt, s)
    want, want_state = jssm.ssd_chunked(
        jx, jb, jc, jd, ja, chunk=8,
        init_state=jst if with_state else None)
    got, state = ssm.ssd_chunked(tx, tb, tc, td, ta, chunk=8,
                                 init_state=tst if with_state else None)
    assert got.dtype == state.dtype == torch.float32
    assert got.shape == (B, s, 4, 8) and state.shape == (B, 4, 8, 16)
    _close(got, want, tol)
    _close(state, want_state, tol)


def test_ssd_chunked_equals_the_plain_recurrence():
    # whatever the chunking, the scan is h_t = exp(dt_t a) h_{t-1} +
    # dt_t x_t b_t^T and y_t = h_t c_t
    (_, _, _, _, _, _), (x, b, c, dt, a_log, h0) = \
        _scan_inputs(13, jnp.float32, 3)
    a = -torch.exp(a_log)
    h, ys = h0.clone(), []
    for t in range(13):
        h = h * torch.exp(dt[:, t] * a)[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], b[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], h))
    for chunk in (13, 8, 1):
        y, state = ssm.ssd_chunked(x, b, c, dt, a_log, chunk=chunk,
                                   init_state=h0)
        torch.testing.assert_close(y, torch.stack(ys, 1), rtol=2e-5,
                                   atol=2e-5)
        torch.testing.assert_close(state, h, rtol=2e-5, atol=2e-5)


def _mixer(dtype):
    """The reduced config's mixer parameters from the JAX initialiser
    (a_log, dt_bias and d_skip drawn off their constants, so each is
    exercised), as (config, JAX tree, port tensors)."""
    cfg = dataclasses.replace(jax_reduced(ARCH), dtype=dtype)
    p = jssm.init_ssd(KEY, cfg, cfg.jnp_dtype)
    for i, name in enumerate(("a_log", "dt_bias", "d_skip")):
        p[name] = p[name] + 0.5 * jax.random.normal(
            jax.random.PRNGKey(9 + i), p[name].shape)
    return cfg, p, bridge.to_torch(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [13, 24])
def test_apply_ssd_prefill_matches_jax(s, with_state, dtype):
    jdt, tol = DTYPES[dtype]
    cfg, jp, tp = _mixer(dtype)
    d_inner, h, hd, n = ssm.ssd_dims(cfg)
    rng = np.random.default_rng(11 + s)
    jx, tx = _both(rng.standard_normal((B, s, cfg.d_model)), jdt)
    st = rng.standard_normal((B, h, hd, n)).astype(np.float32) \
        if with_state else None
    want, (wcx, wcbc, wssm) = jssm.apply_ssd(
        jp, jx, cfg, ssm_state=None if st is None else jnp.asarray(st))
    got, (cx, cbc, state) = ssm.apply_ssd(
        tp, tx, cfg, ssm_state=None if st is None else torch.from_numpy(st))
    assert got.dtype == cx.dtype == cbc.dtype == tx.dtype
    assert state.dtype == torch.float32
    assert (cx.shape, cbc.shape, state.shape) == (
        (B, 3, d_inner), (B, 3, 2 * n), (B, h, hd, n))
    _close(got, want, tol)
    _close(cx, wcx, tol)
    _close(cbc, wcbc, tol)
    _close(state, wssm, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_ssd_decode_matches_jax_in_place(dtype):
    jdt, tol = DTYPES[dtype]
    cfg, jp, tp = _mixer(dtype)
    d_inner, h, hd, n = ssm.ssd_dims(cfg)
    rng = np.random.default_rng(12)
    jcx, tcx = _both(rng.standard_normal((B, 3, d_inner)), jdt)
    jcbc, tcbc = _both(rng.standard_normal((B, 3, 2 * n)), jdt)
    jst, tst = _both(rng.standard_normal((B, h, hd, n)), jnp.float32)
    for step in range(4):
        jx, tx = _both(rng.standard_normal((B, 1, cfg.d_model)), jdt)
        want, (jcx, jcbc, jst) = jssm.apply_ssd(
            jp, jx, cfg, conv_state=(jcx, jcbc), ssm_state=jst)
        got, (cx, cbc, state) = ssm.apply_ssd(
            tp, tx, cfg, conv_state=(tcx, tcbc), ssm_state=tst)
        # the states are the tensors given, written in place
        assert cx is tcx and cbc is tcbc and state is tst
        _close(got, want, tol)
        _close(tcx, jcx, tol)
        _close(tcbc, jcbc, tol)
        _close(tst, jst, tol)


# --------------------------------------------------------------------------- #
# reduced mamba2 on bridged weights
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def pair():
    """(JAX prefill model, JAX decode model, params, lora, port model, port
    lora) on the same float32 weights of reduced mamba2."""
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


@pytest.mark.parametrize("s", [8, 13, 24])
def test_prefill_logits_and_cache_match_jax(pair, s):
    jm, _, params, lora, model, port_lora = pair
    tokens, idx = _tokens(model.cfg, s)
    want, jcache = jm.prefill(params, lora, tokens, idx)
    got, cache = model.prefill(port_lora, torch.from_numpy(tokens).long(),
                               torch.from_numpy(idx))
    assert _rel(got, want) < 2e-4
    assert [set(c) for c in cache["layers"]] == \
        [{"conv_x", "conv_bc", "ssm"}] * 2
    assert cache["layers"][0]["ssm"].shape == (B, 8, 16, 16)
    assert int(cache["pos"]) == int(jcache["pos"]) == s
    got_tree = bridge.cache_to_numpy(cache, model.cfg)
    for g, w in zip(jax.tree.leaves(got_tree["segments"]),
                    jax.tree.leaves(jcache["segments"])):
        assert g.shape == w.shape and _rel(g, w) < 2e-4


@pytest.mark.parametrize("s", [9, 17])
def test_decode_chain_matches_jax(pair, s):
    # a prefill of s - 1 tokens (8: one chunk; 16: two), then 6 decode
    # steps with the teacher's tokens from the scanned states
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
    # it has seen (s + 5 positions, chunked otherwise)
    full, _ = model.prefill(port_lora, t_tok[:, :s + 5], t_idx)
    assert _rel(got, full.numpy()) < 2e-4


def test_decode_writes_the_states_in_place(pair):
    _, _, _, _, model, port_lora = pair
    tokens, idx = _tokens(model.cfg, 10, seed=4)
    t_tok = torch.from_numpy(tokens).long()
    _, cache = model.prefill(port_lora, t_tok[:, :9], torch.from_numpy(idx))
    cache = model.pad_cache(cache, 2)
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in cache["layers"]]
    before = [{k: v.clone() for k, v in c.items()} for c in cache["layers"]]
    pos = cache["pos"]
    _, out = model.decode_step(port_lora, cache, t_tok[:, 9:],
                               torch.from_numpy(idx))
    assert out is cache and out["pos"] is pos and int(pos) == 10
    for c, p, old in zip(cache["layers"], ptrs, before):
        assert {k: v.data_ptr() for k, v in c.items()} == p
        assert all(not torch.equal(c[k], old[k]) for k in c)


def test_mamba2_layers_have_no_lora(pair):
    _, _, _, lora, model, port_lora = pair
    assert port_lora["layers"] == [{}, {}]
    assert model.init_lora(4, 4)["layers"] == [{}, {}]
    # the adapter ids change nothing, as in JAX
    tokens, _ = _tokens(model.cfg, 12)
    t_tok = torch.from_numpy(tokens).long()
    a, _ = model.prefill(port_lora, t_tok, torch.tensor([0, 0],
                                                        dtype=torch.int32))
    b, _ = model.prefill(port_lora, t_tok, torch.tensor([3, -1],
                                                        dtype=torch.int32))
    assert torch.equal(a, b)


def test_published_widths_build_and_run():
    # one layer of mamba2-2.7b at its published widths (d 2560, 80 heads of
    # 64, state 128), the vocab cut to 512: prefill of 5 tokens, one decode
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1, vocab_size=512,
                              dtype="float32")
    model = Model(cfg, device="cpu")
    assert model.layers[0].ssd["w_x"].shape == (2560, 5120)
    tokens = torch.from_numpy(_tokens(cfg, 6)[0]).long()
    logits, cache = model.prefill(model.init_lora(4, 8), tokens[:, :5])
    assert cache["layers"][0]["ssm"].shape == (B, 80, 64, 128)
    logits, _ = model.decode_step(None, model.pad_cache(cache, 1),
                                  tokens[:, 5:])
    assert logits.shape == (B, 512) and bool(torch.isfinite(logits).all())


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
    blk = params["segments"][0]["blocks"][0]["ssd"]
    np.testing.assert_array_equal(bridge.array(model.layers[1].ssd["w_bc"]),
                                  blk["w_bc"][1])
    for name in ("a_log", "dt_bias", "d_skip"):
        assert model.layers[0].ssd[name].dtype == torch.float32
    assert model.layers[0].ssd["conv_x"].dtype == model.cfg.torch_dtype


def test_lora_placeholder_round_trip_bitwise(models):
    jm, model = models
    lora = jax.tree.map(np.asarray, jm.init_lora(KEY, 4, 8))
    assert all("_" in blk for seg in lora["segments"]
               for blk in seg["blocks"])
    port = bridge.lora_to_torch(lora)
    assert port["layers"] == [{}] * model.cfg.n_layers
    _assert_bitwise(lora, bridge.lora_to_numpy(port, model.cfg))
    _assert_bitwise(lora, bridge.lora_to_numpy(model.init_lora(4, 8),
                                               model.cfg))


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
    assert port["layers"][0]["ssm"].dtype == torch.float32
    assert port["layers"][0]["conv_x"].dtype == model.cfg.torch_dtype
    assert port["layers"][0]["conv_bc"].dtype == model.cfg.torch_dtype
    _assert_bitwise(cache, bridge.cache_to_numpy(port, model.cfg))


# --------------------------------------------------------------------------- #
# the executors
# --------------------------------------------------------------------------- #

def test_lora_count_is_one_on_both_sides(pair):
    # no layer has a bank: the JAX executor reads the placeholder's 1, the
    # port finds no bank and gives 1, so every request runs as adapter 0
    jm, jd, params, lora, model, port_lora = pair
    jex = JaxExecutor(jd, params, lora, max_batch=2, cache_len=8)
    assert jex.lora_count() == 1
    ex = TorchExecutor(model, port_lora, max_batch=2, cache_len=8,
                       device="cpu")
    assert ex.lora_count() == 1
    assert ex.graph is None and int(ex.cache["pos"]) == 0
    ops.reset_launches()
    logits = ex.decode(np.asarray([0, 0], np.int32))
    assert logits.shape == (2, 512) and bool(torch.isfinite(logits).all())
    assert int(ex.cache["pos"]) == 1
    assert not any(ops.launch_counts().values())

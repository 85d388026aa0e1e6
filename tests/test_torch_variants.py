"""The port's dense architectures against the JAX package, on bridged
weights.

Reduced gemma3-1b (local layers on a rolling cache, tied embeddings),
qwen1.5-4b (q/k/v biases), internlm2-20b, musicgen-medium (LayerNorm, GELU,
sinusoidal positions) and internvl2-2b (an image-embedding prefix), each in
float32: prefill and decode logits within a relative error of 2e-4 of the
JAX ``Model`` (test_consistency.py:39), the prefill cache (rolled buffers
included) within 2e-5, the port's own teacher forcing, the rolling decode
against ``decode_attention_rolling`` within 2e-5, and the JAX package's
decode after a prompt shorter than the window, which evicts a position the
window still holds (ROADMAP.md queue 3), beside the port's.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models.attention import decode_attention_rolling  # noqa: E402
from repro.models.transformer import pad_cache as jax_pad_cache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import CacheSlot, decode_attention  # noqa: E402

ARCHS = ("gemma3-1b", "qwen1.5-4b", "internlm2-20b", "musicgen-medium",
         "internvl2-2b")
KEY = jax.random.PRNGKey(1)
B = 2


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / (np.max(np.abs(want)) + 1e-9))


def _build(arch, **change):
    """(JAX prefill model, JAX decode model, params, lora, port model, port
    lora) on the same float32 weights of reduced ``arch``."""
    cfg = dataclasses.replace(jax_reduced(arch), dtype="float32", **change)
    jm = JaxModel(cfg, ShardingPlan(mode="prefill"))
    jd = JaxModel(cfg, ShardingPlan(mode="decode"))
    params, lora = jm.init(KEY), jm.init_lora(KEY, 4, 4)
    model = Model(dataclasses.replace(get_reduced(arch), dtype="float32",
                                      **change), device="cpu")
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    return jm, jd, params, lora, model, bridge.lora_to_torch(
        jax.tree.map(np.asarray, lora))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _build(request.param)


def _inputs(cfg, s, seed=0):
    """Tokens (B, s), adapter ids, and for a VLM seeded image embeddings
    (B, n_image_tokens, d); numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    img = None
    if cfg.n_image_tokens:
        img = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return tokens, np.asarray([1, 2], np.int32), img


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("arch", ARCHS + ("olmoe-1b-7b",
                                          "moonshot-v1-16b-a3b"))
def test_configs_equal_jax_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == \
        dataclasses.asdict(jax_reduced(arch))


def test_prefill_and_decode_match_jax(pair):
    jm, jd, params, lora, model, port_lora = pair
    cfg = model.cfg
    tokens, idx, img = _inputs(cfg, 24)
    t_tok, t_idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    want, _ = jm.prefill(params, lora, tokens, idx, img_embeds=img)
    got, _ = model.prefill(port_lora, t_tok, t_idx, img_embeds=_t(img))
    assert _rel(got, want) < 2e-4

    _, jcache = jm.prefill(params, lora, tokens[:, :-1], idx, img_embeds=img)
    want, _ = jd.decode_step(params, lora, jax_pad_cache(jcache, 4),
                             tokens[:, -1:], idx)
    _, cache = model.prefill(port_lora, t_tok[:, :-1], t_idx,
                             img_embeds=_t(img))
    assert int(cache["pos"]) == 23 + cfg.n_image_tokens
    padded = model.pad_cache(cache, 4)
    got, _ = model.decode_step(port_lora, padded, t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4
    assert int(padded["pos"]) == 24 + cfg.n_image_tokens
    # the JAX cache, bridged, decodes to the same logits
    got, _ = model.decode_step(
        port_lora, bridge.cache_to_torch(jax.tree.map(
            np.asarray, jax_pad_cache(jcache, 4))), t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4


@pytest.mark.parametrize("s", [9, 23])
def test_prefill_cache_matches_jax(pair, s):
    # gemma3's window is 16: 9 tokens fill a 9-row buffer, 23 roll 16 rows
    jm, _, params, lora, model, port_lora = pair
    tokens, idx, img = _inputs(model.cfg, s, seed=s)
    _, jcache = jm.prefill(params, lora, tokens, idx, img_embeds=img)
    _, cache = model.prefill(port_lora, torch.from_numpy(tokens).long(),
                             torch.from_numpy(idx), img_embeds=_t(img))
    got = bridge.cache_to_numpy(cache, model.cfg)
    want = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert int(got["pos"]) == s + model.cfg.n_image_tokens
    for g, w in zip(jax.tree.leaves(got["segments"]),
                    jax.tree.leaves(want["segments"])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def test_teacher_forcing(pair):
    model, port_lora = pair[4], pair[5]
    tokens, idx, img = _inputs(model.cfg, 24, seed=1)
    tokens, idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    full, _ = model.prefill(port_lora, tokens, idx, img_embeds=_t(img))
    _, cache = model.prefill(port_lora, tokens[:, :-1], idx,
                             img_embeds=_t(img))
    dec, _ = model.decode_step(port_lora, model.pad_cache(cache, 4),
                               tokens[:, -1:], idx)
    assert bool(torch.isfinite(full).all()) and _rel(dec, full.numpy()) < 2e-4


@pytest.mark.parametrize("w,window,pos", [
    (16, 16, 5), (16, 16, 15), (16, 16, 16), (16, 16, 16 * 3 + 7),
    (8, 16, 3), (8, 16, 8 * 4 + 5)])   # cache_len 8 < window 16
def test_rolling_decode_matches_jax(w, window, pos):
    # flash-decode's plain version over the prefix [0, min(pos + 1, w)) of
    # the buffer, against the JAX package's position mask over all w rows
    rng = np.random.default_rng(pos)
    b, h, kv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, w, kv, d)).astype(np.float32)
              for _ in range(2))
    nk, nv = (rng.standard_normal((b, kv, d)).astype(np.float32)
              for _ in range(2))
    want, wk, wv = decode_attention_rolling(
        q, kc, vc, nk, nv, jnp.asarray(pos, jnp.int32),
        scale=1.0 / math.sqrt(d), window=window)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    slot = CacheSlot.rolling(torch.tensor(pos, dtype=torch.int32), w)
    got = decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(nk),
                           torch.from_numpy(nv), slot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    assert slot.live is None and int(slot.length) == min(pos + 1, w)


@pytest.fixture(scope="module")
def gemma3():
    return _build("gemma3-1b")


@pytest.mark.parametrize("prompt", [9, 15])
def test_short_prompt_decode_jax_evicts_port_exact(gemma3, prompt):
    # a prompt shorter than gemma3's window (16): the JAX package's rolling
    # buffer has ``prompt`` rows and pad_cache passes it through, so its
    # first decode step overwrites row 0, position 0, which the window
    # still holds; the port's pad_cache grows the buffer
    jm, jd, params, lora, model, port_lora = gemma3
    tokens, idx, _ = _inputs(model.cfg, prompt + 1, seed=prompt)
    full, _ = jm.prefill(params, lora, tokens, idx)
    _, jcache = jm.prefill(params, lora, tokens[:, :-1], idx)
    jax_dec, _ = jd.decode_step(params, lora, jax_pad_cache(jcache, 4),
                                tokens[:, -1:], idx)
    assert _rel(np.asarray(jax_dec), full) > 0.1
    t_tok, t_idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    _, cache = model.prefill(port_lora, t_tok[:, :-1], t_idx)
    padded = model.pad_cache(cache, 4)
    assert padded["layers"][0]["k_loc"].shape[1] == min(
        prompt + 4, model.cfg.local_window)
    got, _ = model.decode_step(port_lora, padded, t_tok[:, -1:], t_idx)
    assert _rel(got, full) < 2e-4


def test_pad_cache_rolling_buffers():
    model = Model(dataclasses.replace(get_reduced("gemma3-1b"),
                                      dtype="float32"), device="cpu")
    window = model.cfg.local_window
    for s, rows in ((9, 13), (14, 16), (23, 16)):
        _, cache = model.prefill(None, torch.zeros((1, s), dtype=torch.long))
        padded = model.pad_cache(cache, 4)
        for c, p in zip(cache["layers"], padded["layers"]):
            if "k" in c:
                assert p["k"].shape[1] == s + 4
            else:
                assert p["k_loc"].shape[1] == rows
                assert torch.equal(p["v_loc"][:, :c["v_loc"].shape[1]],
                                   c["v_loc"])
        # padding again: a rolling buffer grows no further than the window
        again = model.pad_cache(padded, 4)
        for p, a in zip(padded["layers"], again["layers"]):
            if "k" in p:
                assert a["k"].shape[1] == s + 8
            else:
                assert a["k_loc"].shape[1] == min(window, rows + 4)
        assert int(again["pos"]) == s and again["pos"] is not cache["pos"]

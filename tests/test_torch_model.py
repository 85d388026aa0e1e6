"""The port's model against the JAX package's, on bridged weights.

Reduced phi4-mini at float32: prefill and decode logits must match the JAX
``Model`` to a relative error below 2e-4 (test_consistency.py:39), and the
port passes its own counterparts of test_consistency.py:17-70.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models.transformer import pad_cache as jax_pad_cache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced as port_reduced  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402

KEY = jax.random.PRNGKey(1)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want))
                 / (np.max(np.abs(want)) + 1e-9))


def _port_cfg():
    return dataclasses.replace(port_reduced("phi4-mini-3.8b"),
                               dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """(JAX prefill model, JAX decode model, params, lora, port model,
    port lora) on the same float32 weights."""
    cfg = dataclasses.replace(get_reduced("phi4_mini_3p8b"), dtype="float32")
    jm = JaxModel(cfg, ShardingPlan(mode="prefill"))
    jd = JaxModel(cfg, ShardingPlan(mode="decode"))
    params, lora = jm.init(KEY), jm.init_lora(KEY, 4, 4)
    model = Model(_port_cfg(), device="cpu")
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    port_lora = bridge.lora_to_torch(jax.tree.map(np.asarray, lora))
    return jm, jd, params, lora, model, port_lora


def _tokens(b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s), np.int32)


@pytest.mark.parametrize("ids", [[1, 2], [0, -1]])
def test_prefill_and_decode_match_jax(pair, ids):
    jm, jd, params, lora, model, port_lora = pair
    tokens, idx = _tokens(), np.asarray(ids, np.int32)
    t_tok, t_idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    want, _ = jm.prefill(params, lora, tokens, idx)
    got, _ = model.prefill(port_lora, t_tok, t_idx)
    assert got.shape == (2, 512) and _rel(got, want) < 2e-4

    _, jcache = jm.prefill(params, lora, tokens[:, :-1], idx)
    want, _ = jd.decode_step(params, lora, jax_pad_cache(jcache, 4),
                             tokens[:, -1:], idx)
    _, cache = model.prefill(port_lora, t_tok[:, :-1], t_idx)
    got, new_cache = model.decode_step(port_lora, model.pad_cache(cache, 4),
                                       t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4
    assert int(new_cache["pos"]) == tokens.shape[1]
    # the JAX cache, bridged, decodes to the same logits
    got, _ = model.decode_step(
        port_lora,
        bridge.cache_to_torch(jax.tree.map(np.asarray,
                                           jax_pad_cache(jcache, 4))),
        t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4


def test_decode_matches_prefill(pair):
    model, port_lora = pair[4], pair[5]
    tokens = torch.from_numpy(_tokens(seed=1)).long()
    idx = torch.tensor([1, 2], dtype=torch.int32)
    full, _ = model.prefill(port_lora, tokens, idx)
    _, cache = model.prefill(port_lora, tokens[:, :-1], idx)
    dec, _ = model.decode_step(port_lora, model.pad_cache(cache, 4),
                               tokens[:, -1:], idx)
    rel = float((dec - full).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 2e-4


def test_lora_changes_output():
    model = Model(_port_cfg(), device="cpu")
    lora = model.init_lora(4, 8)
    tokens = torch.from_numpy(_tokens(s=16, seed=2)).long()
    la, _ = model.prefill(lora, tokens, torch.tensor([0, 0]))
    lb, _ = model.prefill(lora, tokens, torch.tensor([1, 1]))
    lnone, _ = model.prefill(None, tokens, None)
    assert not torch.allclose(la, lb)
    assert not torch.allclose(la, lnone)


def test_per_request_adapters_independent():
    """The adapter of request 0 must not affect the logits of request 1."""
    model = Model(_port_cfg(), device="cpu", seed=1)
    lora = model.init_lora(4, 8, seed=1)
    tokens = torch.from_numpy(_tokens(s=16, seed=3)).long()
    l1, _ = model.prefill(lora, tokens, torch.tensor([0, 2]))
    l2, _ = model.prefill(lora, tokens, torch.tensor([1, 2]))
    assert not torch.allclose(l1[0], l2[0])
    assert torch.allclose(l1[1], l2[1])


def test_decode_past_cache_end_skips_write(pair):
    # pos >= cache_len: the write is skipped and all of S is attended
    # (attention.py:247-253), on both sides
    jm, jd, params, lora, model, port_lora = pair
    idx = np.array([3, 1], np.int32)
    tokens = _tokens(s=1, seed=4)
    jcache = jm.init_cache(2, 8)
    jcache = dict(jcache, pos=jnp.asarray(11, jnp.int32))
    want, _ = jd.decode_step(params, lora, jcache, tokens, idx)
    cache = bridge.cache_to_torch(jax.tree.map(np.asarray, jcache))
    got, _ = model.decode_step(port_lora, cache, torch.from_numpy(tokens).long(),
                               torch.from_numpy(idx))
    assert _rel(got, want) < 2e-4
    assert all(bool((c["k"] == 0).all()) for c in cache["layers"])


def test_mamba2_builds_and_runs():
    # the last of the JAX package's architectures: attention-free, no LoRA
    from repro_torch.configs import get_config
    published = get_config("mamba2-2.7b")
    assert published.family == "ssm" and published.n_heads == 0
    model = Model(port_reduced("mamba2-2.7b"), device="cpu")
    lora = model.init_lora(4, 4)
    assert lora["layers"] == [{}] * model.cfg.n_layers
    tokens = torch.from_numpy(_tokens(s=12, seed=5)).long()
    idx = torch.tensor([0, 3], dtype=torch.int32)
    logits, cache = model.prefill(lora, tokens, idx)
    assert logits.shape == (2, 512) and bool(torch.isfinite(logits).all())
    logits, _ = model.decode_step(lora, model.pad_cache(cache, 2),
                                  tokens[:, -1:], idx)
    assert logits.shape == (2, 512) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("kind", ["ssm", "attention", "mamba"])
def test_unknown_block_kind_raises_value_error(kind):
    # as the JAX package's _init_block (transformer.py:116)
    cfg: ModelConfig = dataclasses.replace(_port_cfg(),
                                           block_pattern=("global", kind))
    with pytest.raises(ValueError, match=kind):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "moonshot-v1-16b-a3b"])
def test_moe_architectures_build_and_run(arch):
    from repro_torch.configs import get_config
    published = get_config(arch)
    assert published.n_experts == 64 and published.family == "moe"
    model = Model(port_reduced(arch), device="cpu")
    lora = model.init_lora(4, 4)
    tokens = torch.from_numpy(_tokens(s=12, seed=5)).long()
    idx = torch.tensor([0, 3], dtype=torch.int32)
    logits, cache = model.prefill(lora, tokens, idx)
    assert logits.shape == (2, 512) and bool(torch.isfinite(logits).all())
    logits, _ = model.decode_step(lora, model.pad_cache(cache, 2),
                                  tokens[:, -1:], idx)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("change", [
    {"n_experts": 4, "top_k": 2},
    {"block_pattern": ("local", "global"), "n_experts": 4, "top_k": 2},
])
def test_moe_blocks_build_and_run(change):
    # phi4-mini's reduced widths with experts in place of the MLP, in
    # global or local layers: decode after the prefill of all but the last
    # token matches the prefill of all
    cfg: ModelConfig = dataclasses.replace(_port_cfg(), **change)
    model = Model(cfg, device="cpu", seed=2)
    assert all(hasattr(blk, "moe") and not hasattr(blk, "mlp")
               for blk in model.layers)
    lora = model.init_lora(4, 8, seed=2)
    tokens = torch.from_numpy(_tokens(seed=6)).long()
    idx = torch.tensor([1, 2], dtype=torch.int32)
    full, _ = model.prefill(lora, tokens, idx)
    _, cache = model.prefill(lora, tokens[:, :-1], idx)
    dec, _ = model.decode_step(lora, model.pad_cache(cache, 4),
                               tokens[:, -1:], idx)
    rel = float((dec - full).abs().max() / (full.abs().max() + 1e-9))
    assert bool(torch.isfinite(full).all()) and rel < 2e-4

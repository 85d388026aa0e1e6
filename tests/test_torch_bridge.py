"""The weight bridge: JAX trees -> the port's tensors -> JAX trees is
bitwise for every leaf of the params, LoRA banks and caches, in bf16 and
f32, of reduced phi4-mini, gemma3 (tied embeddings, local layers' rolling
caches, a remainder segment), qwen1.5 (q/k/v biases), musicgen
(LayerNorm biases, a GELU MLP) and olmoe (an MoE subtree: an f32 router
beside bf16 or f32 experts, or int8 experts with f16 scales), and of the
int8 KV caches of phi4-mini and gemma3 (``kv_quant``: int8 K/V with
(R, B, S, KV) f16 scales beside gemma3's local layers in the model's
dtype)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced as port_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402

KEY = jax.random.PRNGKey(3)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_bitwise(want, got):
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert w.tobytes() == g.tobytes()


def _case(arch, dtype, quant=False, kv_quant=False):
    name = dtype if arch == "phi4-mini-3.8b" else f"{arch}-{dtype}"
    suffix = "-int8" * quant + "-kv-int8" * kv_quant
    return pytest.param((arch, dtype, quant, kv_quant), id=name + suffix)


@pytest.fixture(params=[_case(a, d) for a in ("phi4-mini-3.8b", "gemma3-1b",
                                              "qwen1.5-4b", "musicgen-medium",
                                              "olmoe-1b-7b")
                        for d in ("bfloat16", "float32")]
                + [_case("olmoe-1b-7b", d, quant=True)
                   for d in ("bfloat16", "float32")]
                + [_case(a, d, kv_quant=True)
                   for a in ("phi4-mini-3.8b", "gemma3-1b")
                   for d in ("bfloat16", "float32")])
def models(request):
    arch, dtype, quant, kv_quant = request.param
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    port_cfg = dataclasses.replace(port_reduced(arch), dtype=dtype)
    return (JaxModel(cfg, ShardingPlan(mode="prefill", expert_quant=quant,
                                       kv_quant=kv_quant)),
            Model(port_cfg, device="cpu", expert_quant=quant,
                  kv_quant=kv_quant))


def test_params_round_trip_bitwise(models):
    jm, model = models
    params = _numpy(jm.init(KEY))
    bridge.load_params(model, params)
    _assert_bitwise(params, bridge.export_params(model))
    # the per-layer split: repeat r of a segment runs its blocks in pattern
    # order, so layer i is row r of one block of one segment
    i = 0
    for seg in params["segments"]:
        blocks = seg["blocks"]
        for r in range(blocks[0]["wq"].shape[0]):
            for blk in blocks:
                assert model.layers[i].kind == model.cfg.layer_kinds[i]
                np.testing.assert_array_equal(
                    bridge.array(model.layers[i].wq), blk["wq"][r])
                i += 1
    assert i == len(model.layers) == model.cfg.n_layers
    assert ("unembed" in params["embed"]) != model.cfg.tie_embeddings
    if model.cfg.n_experts:
        # the stacked MoE leaves: router (R, d, E) in f32, experts
        # (R, E, d, f) / (R, E, f, d), int8 ones with (R, E, 1, f or d) f16
        # scales
        cfg, leaves = model.cfg, params["segments"][0]["blocks"][0]["moe"]
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert leaves["router"].shape == (cfg.n_layers, d, e)
        assert leaves["router"].dtype == np.float32
        assert leaves["w_down"].shape == (cfg.n_layers, e, f, d)
        if "w_up_scale" in leaves:
            assert leaves["w_up"].dtype == np.int8
            assert leaves["w_up_scale"].shape == (cfg.n_layers, e, 1, f)
            assert leaves["w_up_scale"].dtype == np.float16
            assert model.layers[0].moe["w_down_scale"].dtype == torch.float16


def test_lora_round_trip_bitwise(models):
    jm, model = models
    lora = _numpy(jm.init_lora(KEY, 4, 8))
    port = bridge.lora_to_torch(lora)
    assert port["layers"][0]["a_q"].shape == (4, model.cfg.d_model, 8)
    _assert_bitwise(lora, bridge.lora_to_numpy(port, model.cfg))


def test_cache_round_trip_bitwise(models):
    jm, model = models
    init = _numpy(jm.init_cache(2, 16))
    _assert_bitwise(init, bridge.cache_to_numpy(
        bridge.cache_to_torch(init), model.cfg))
    # the port's own zero cache: the same keys, shapes and dtypes
    _assert_bitwise(init, bridge.cache_to_numpy(model.init_cache(2, 16),
                                                model.cfg))
    cfg = model.cfg
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12),
                                               np.int32)
    _, cache = jm.prefill(jm.init(KEY), None, tokens)
    cache = _numpy(cache)
    port = bridge.cache_to_torch(cache)
    assert int(port["pos"]) == 12
    # pos lies beside the K/V, a 0-d int32 tensor, as the model reads it
    g = cfg.layer_kinds.index("global")
    assert port["pos"].shape == () and port["pos"].dtype == torch.int32
    assert port["pos"].device == port["layers"][g]["k"].device
    assert port["layers"][g]["k"].shape == (2, 12, cfg.n_kv_heads,
                                            cfg.resolved_head_dim)
    global_keys = {"k", "v", "k_scale", "v_scale"} if model.kv_quant \
        else {"k", "v"}
    for kind, c in zip(cfg.layer_kinds, port["layers"]):
        assert set(c) == (global_keys if kind == "global"
                          else {"k_loc", "v_loc"})
    if model.kv_quant:
        # int8 K/V, their (B, S, KV) f16 scales (R, B, S, KV in the JAX
        # tree), the local layers' buffers in the model's dtype
        kv = port["layers"][g]
        assert kv["k"].dtype == torch.int8
        assert kv["k_scale"].dtype == torch.float16
        assert kv["k_scale"].shape == kv["k"].shape[:3]
        for kind, c in zip(cfg.layer_kinds, port["layers"]):
            if kind == "local":
                assert c["k_loc"].dtype == cfg.torch_dtype
    _assert_bitwise(cache, bridge.cache_to_numpy(port, cfg))


def test_bf16_values_cross_exactly():
    x = np.asarray(jax.numpy.asarray([1.5, -2.25, 3e-3, 7e4],
                                     jax.numpy.bfloat16))
    t = bridge.tensor(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))

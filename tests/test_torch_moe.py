"""The port's MoE FFN and MoE models against the JAX package, on the same
numpy inputs and bridged weights.

``apply_moe`` at reduced olmoe's widths (d 64, 8 experts of 32, top-2) on
``init_moe(PRNGKey(0))`` and tokens from ``np.random.default_rng(0)``: the
dropless path (T 2047, T*k 4094 <= 4096) and the capacity path (T 2049,
capacity 641, the router's column 0 raised by 0.3 so that expert 0 takes
778 pairs and 137 drop, on both sides), within 2e-5 in float32 and 3e-2
in bfloat16 (test_kernels_property.py:14-16), the aux loss equal;
``apply_moe_ref``; ``quantize_experts`` bit for bit and ``_dequant``.
Then reduced olmoe-1b-7b and moonshot-v1-16b-a3b in float32, with and
without int8 experts, bridged from ``Model.init(PRNGKey(1))``: prefill and
decode logits within a relative error of 2e-4 (test_consistency.py:39),
the port's own teacher forcing, and a ("local", "global") stack with
experts.  The JAX side is compiled with XLA's excess precision off
(``_as_written``): by default XLA keeps the int8 experts' bf16 dequant
product in f32 inside a compiled block, about 3e-3 from the bf16 product
the JAX source states and the port computes (shown by
``test_int8_experts_xla_default_keeps_dequant_in_f32``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.transformer import pad_cache as jax_pad_cache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402

ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
CFG = jax_reduced("olmoe-1b-7b")
KW = dict(top_k=CFG.top_k, n_experts=CFG.n_experts)
B = 2


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / (np.max(np.abs(want)) + 1e-9))


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _moe_case(dtype, t, router_add=0.0):
    """JAX params and x, and the port's copies: reduced olmoe's widths,
    ``init_moe(PRNGKey(0))``, the router's column 0 raised by
    ``router_add``, x (t, d) from ``default_rng(0)`` in ``dtype``."""
    jdt = jnp.dtype(dtype)
    p = jax_moe.init_moe(jax.random.PRNGKey(0), CFG.d_model, CFG.d_ff,
                         CFG.n_experts, jdt)
    p = dict(p, router=p["router"].at[:, 0].add(router_add))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (t, CFG.d_model)).astype(np.float32), jdt)
    port_p = bridge.to_torch(jax.tree.map(np.asarray, p))
    return p, x, port_p, bridge.tensor(np.asarray(x))


def _dropped(experts, cap):
    """Pairs past their expert's capacity, given each token's experts."""
    load = np.bincount(np.asarray(experts).ravel(), minlength=CFG.n_experts)
    return int(np.maximum(load - cap, 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,router_add,cap,drops", [
    pytest.param(2047, 0.0, 4094, {"float32": 0, "bfloat16": 0},
                 id="dropless"),
    # bf16 rounds x, which moves a few tokens off expert 0
    pytest.param(2049, 0.3, 641, {"float32": 137, "bfloat16": 134},
                 id="capacity"),
])
def test_apply_moe_matches_jax(t, router_add, cap, drops, dtype):
    p, x, port_p, port_x = _moe_case(dtype, t, router_add)
    want, want_aux = jax_moe.apply_moe(p, x, capacity_factor=1.25, **KW)
    got, aux = moe.apply_moe(port_p, port_x, capacity_factor=1.25, **KW)
    assert got.dtype == port_x.dtype and got.shape == (t, CFG.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert moe.capacity(t, CFG.top_k, CFG.n_experts, 1.25) == cap
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ p["router"], -1)
    jax_experts = jax.lax.top_k(probs, CFG.top_k)[1]
    port_experts = moe._route(port_p, port_x, CFG.top_k)[2]
    assert _dropped(jax_experts, cap) == _dropped(port_experts, cap) == \
        drops[dtype]


def test_capacity_path_drops_the_same_pairs():
    # float32, where a dropped pair is far above the rounding: the rows
    # that differ from the dropless oracle are the tokens that lost a pair,
    # the same 137 in both packages
    p, x, port_p, port_x = _moe_case("float32", 2049, 0.3)
    want = np.asarray(jax_moe.apply_moe(p, x, capacity_factor=1.25, **KW)[0])
    want_ref = np.asarray(jax_moe.apply_moe_ref(p, x, **KW))
    got = moe.apply_moe(port_p, port_x, capacity_factor=1.25, **KW)[0]
    got_ref = moe.apply_moe_ref(port_p, port_x, **KW)
    jax_rows = np.abs(want - want_ref).max(1) > 1e-4
    port_rows = (got - got_ref).abs().amax(1).numpy() > 1e-4
    assert jax_rows.sum() == port_rows.sum() == 137
    np.testing.assert_array_equal(port_rows, jax_rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_ref_matches_jax(dtype):
    p, x, port_p, port_x = _moe_case(dtype, 257)
    want = jax_moe.apply_moe_ref(p, x, **KW)
    got = moe.apply_moe_ref(port_p, port_x, **KW)
    assert got.dtype == port_x.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropless_apply_moe_equals_its_oracle(dtype):
    _, _, port_p, port_x = _moe_case(dtype, 2047)
    got = moe.apply_moe(port_p, port_x, capacity_factor=1.25, **KW)[0]
    want = moe.apply_moe_ref(port_p, port_x, **KW)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_experts_bitwise(dtype):
    p = _moe_case(dtype, 1)[0]
    want = jax.tree.map(np.asarray, jax_moe.quantize_experts(p))
    got = bridge.to_numpy(moe.quantize_experts(
        bridge.to_torch(jax.tree.map(np.asarray, p))))
    assert set(got) == set(want) == {"router", "w_gate", "w_up", "w_down",
                                     "w_gate_scale", "w_up_scale",
                                     "w_down_scale"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert want["w_gate"].dtype == np.int8
    assert want["w_down_scale"].shape == (CFG.n_experts, 1, CFG.d_model)


@pytest.mark.parametrize("like", ["float32", "bfloat16"])
def test_dequant_matches_jax(like):
    q = jax_moe.quantize_experts(_moe_case("float32", 1)[0])
    port_q = bridge.to_torch(jax.tree.map(np.asarray, q))
    for name in ("w_gate", "w_up", "w_down"):
        want = np.asarray(jax_moe._dequant(q, name, jnp.dtype(like)))
        got = bridge.array(moe._dequant(port_q, name, getattr(torch, like)))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # a weight that is not int8 passes through
    assert moe._dequant({"w": port_q["router"]}, "w", torch.bfloat16) is \
        port_q["router"]


def test_init_moe_layout():
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 64, 32, 8, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32 and \
        p["router"].shape == (64, 8)
    assert p["w_gate"].shape == p["w_up"].shape == (8, 64, 32)
    assert p["w_down"].shape == (8, 32, 64)
    assert p["w_gate"].dtype == torch.bfloat16
    # N(0, 1/fan_in): fan_in d for the gate, d_ff for the down projection
    assert abs(float(p["w_gate"].float().std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["w_down"].float().std()) - 32 ** -0.5) < 0.01
    q = moe.init_moe(gen, 64, 32, 8, torch.bfloat16, "cpu", quant=True)
    assert q["w_up"].dtype == torch.int8
    assert q["w_up_scale"].dtype == torch.float16


# --------------------------------------------------------------------------- #
# MoE models
# --------------------------------------------------------------------------- #

KEY = jax.random.PRNGKey(1)


def _build(arch, quant=False, **change):
    """(JAX prefill model, JAX decode model, params, lora, port model, port
    lora) on the same float32 weights of reduced ``arch``."""
    cfg = dataclasses.replace(jax_reduced(arch), dtype="float32", **change)
    jm = JaxModel(cfg, ShardingPlan(mode="prefill", expert_quant=quant))
    jd = JaxModel(cfg, ShardingPlan(mode="decode", expert_quant=quant))
    params, lora = jm.init(KEY), jm.init_lora(KEY, 4, 4)
    model = Model(dataclasses.replace(get_reduced(arch), dtype="float32",
                                      **change), device="cpu",
                  expert_quant=quant)
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    return jm, jd, params, lora, model, bridge.lora_to_torch(
        jax.tree.map(np.asarray, lora))


@pytest.fixture(scope="module", params=[
    pytest.param((a, q), id=a + ("-int8" if q else ""))
    for a in ARCHS for q in (False, True)])
def pair(request):
    arch, quant = request.param
    return _build(arch, quant)


def _inputs(s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab_size, (B, s)).astype(np.int32)
    return tokens, np.asarray([1, 2], np.int32)


def _as_written(fn, *args, excess_precision=False):
    """``fn(*args)`` compiled by XLA with its ``xla_allow_excess_precision``
    off: the arithmetic the JAX source states.  XLA's default keeps
    ``_dequant``'s bf16 product (moe.py:54-59) in f32 inside a compiled
    block, so int8 experts' dequantised weights are not rounded to bf16."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": excess_precision})(*args)


def _prefill_and_decode_match_jax(built, s=24):
    jm, jd, params, lora, model, port_lora = built
    tokens, idx = _inputs(s)
    t_tok, t_idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    want, _ = _as_written(jm.prefill, params, lora, tokens, idx)
    got, _ = model.prefill(port_lora, t_tok, t_idx)
    assert _rel(got, want) < 2e-4

    _, jcache = _as_written(jm.prefill, params, lora, tokens[:, :-1], idx)
    want, _ = _as_written(jd.decode_step, params, lora,
                          jax_pad_cache(jcache, 4), tokens[:, -1:], idx)
    _, cache = model.prefill(port_lora, t_tok[:, :-1], t_idx)
    got, _ = model.decode_step(port_lora, model.pad_cache(cache, 4),
                               t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4
    # the JAX cache, bridged, decodes to the same logits
    got, _ = model.decode_step(
        port_lora, bridge.cache_to_torch(jax.tree.map(
            np.asarray, jax_pad_cache(jcache, 4))), t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4


def test_prefill_and_decode_match_jax(pair):
    model = pair[4]
    quant = "w_gate_scale" in model.layers[0].moe
    assert all(blk.moe["w_up"].dtype == (torch.int8 if quant
                                         else torch.float32)
               for blk in model.layers)
    assert not hasattr(model.layers[0], "mlp")
    _prefill_and_decode_match_jax(pair)


def test_teacher_forcing(pair):
    model, port_lora = pair[4], pair[5]
    tokens, idx = _inputs(24, seed=1)
    tokens, idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    full, _ = model.prefill(port_lora, tokens, idx)
    _, cache = model.prefill(port_lora, tokens[:, :-1], idx)
    dec, _ = model.decode_step(port_lora, model.pad_cache(cache, 4),
                               tokens[:, -1:], idx)
    assert bool(torch.isfinite(full).all()) and _rel(dec, full.numpy()) < 2e-4


def test_local_global_stack_with_experts_matches_jax():
    # a local layer with experts (transformer.py:95-101 builds the MoE for
    # either kind); prompts of 23 and 24 tokens run past the 16 window
    built = _build("olmoe-1b-7b", block_pattern=("local", "global"),
                   local_window=16)
    model = built[4]
    assert [blk.kind for blk in model.layers] == ["local", "global"]
    assert all(hasattr(blk, "moe") for blk in model.layers)
    _prefill_and_decode_match_jax(built)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_experts_xla_default_keeps_dequant_in_f32(arch):
    # a reference behaviour, not a port fault: with XLA's default excess
    # precision the JAX prefill of an int8-expert model skips the bf16
    # rounding of ``_dequant`` and lands about 3e-3 from the arithmetic its
    # source states, which the port follows to 2e-4
    jm, _, params, lora, model, port_lora = _build(arch, quant=True)
    tokens, idx = _inputs(24)
    default, _ = _as_written(jm.prefill, params, lora, tokens, idx,
                             excess_precision=True)
    written, _ = _as_written(jm.prefill, params, lora, tokens, idx)
    got, _ = model.prefill(port_lora, torch.from_numpy(tokens).long(),
                           torch.from_numpy(idx))
    assert _rel(np.asarray(default), written) > 1e-3
    assert _rel(got, written) < 2e-4

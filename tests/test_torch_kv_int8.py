"""The port's int8 KV cache (``Model(kv_quant=True)``) against the JAX
package's (``ShardingPlan(kv_quant=True)``), on the CPU.

``quantize_kv`` bit for bit on f32 and bf16 inputs (rows of zeros, of
values that round to a zero f16 scale, and of values at +-127 scales among
them) and its round-trip bound (test_consistency_int8.py:16-21); the int8
plain attention against the JAX quantized decode branch at one shard
(attention.py:271-314) to 2e-5 in f32, with the cache write bit for bit;
the prefill caches of reduced phi4-mini, qwen1.5 and gemma3 (global layers
int8 beside local layers in the model's dtype); decode after ``pad_cache``
against the JAX decode to 2e-4 (test_consistency.py:39); the port's int8
against its own unquantized cache to 2e-2 (test_consistency_int8.py:24-52);
and the serving executor's chain of steps over the cache's end against the
JAX executor's, as test_torch_executor.py runs it.  JAX runs jitted, as
test_consistency_int8.py runs it.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models.attention import decode_attention_sharded  # noqa: E402
from repro.models.attention import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.models.transformer import pad_cache as jax_pad_cache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced as port_reduced  # noqa: E402
from repro_torch.kernels import flash_decode, ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import (CacheSlot, decode_attention,  # noqa: E402
                                          quantize_kv)
from repro_torch.serving.executor import TorchExecutor  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.scheduler import StepPlan  # noqa: E402

KEY = jax.random.PRNGKey(4)
ARCHS = ["phi4-mini-3.8b", "qwen1.5-4b", "gemma3-1b"]
CACHE_LEN = 8


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / (np.max(np.abs(want)) + 1e-9))


def _quant_inputs(dtype):
    """(5, 6, 3, 32) values with rows of zeros, of values too small for an
    f16 scale, of one value at +-127 scales among smaller ones, and of
    values far from 1."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 6, 3, 32)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 2] = 1e-12
    x[1, 2, 1] = np.linspace(-1.0, 1.0, 32)         # +-1 at the ends
    x[1, 3, 0, :] = 0.5
    x[1, 3, 0, 5] = -127 * 0.25                     # -127 steps of 0.25
    x[2, 4, 2] *= 1e4
    x[3, 5, 1] *= 1e-3
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise_jax(dtype):
    x = _quant_inputs(dtype)
    want_q, want_s = jax.jit(jax_quantize_kv)(x)
    got_q, got_s = quantize_kv(bridge.tensor(np.asarray(x)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float16
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint16),
                                  np.asarray(want_s).view(np.uint16))
    # the rows set up above: zeros give 0 over a zero scale, and so does
    # a row whose scale rounds to 0 in f16 (its values over 0: +-inf,
    # clipped to +-127); the extreme values reach +-127
    assert not got_q[0, 0, 0].any() and float(got_s[0, 0, 0]) == 0.0
    assert float(got_s[0, 1, 2]) == 0.0 and int(got_q[0, 1, 2].abs().max()) == 127
    assert int(got_q[1, 3, 0, 5]) == -127 and int(got_q[1, 2, 1, 0]) == -127


def test_quantize_kv_roundtrip_error():
    # the bound of test_consistency_int8.py:16-21: half a (stored f16) step
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 8, 64)).astype(np.float32) * 3)
    q, s = quantize_kv(x)
    recon = q.float() * s.float()[..., None]
    assert float((recon - x).abs().max()) <= float(s.float().max()) / 2 + 1e-5


def _decode_inputs(seed, b=4, s=40, h=8, kv=2, d=32):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    kq, ks = jax_quantize_kv(jnp.asarray(normal(b, s, kv, d)))
    vq, vs = jax_quantize_kv(jnp.asarray(normal(b, s, kv, d)))
    return (normal(b, h, d), np.array(kq), np.array(vq), np.array(ks),
            np.array(vs), normal(b, kv, d), normal(b, kv, d))


def _jax_branch(d):
    """The JAX quantized decode branch at one shard, jitted: (q, caches,
    new K/V, pos, scales) -> (out, k, v, k_scale, v_scale)."""
    return jax.jit(lambda q, kc, vc, nk, nv, p, ksc, vsc:
                   decode_attention_sharded(
                       q, kc, vc, nk, nv, p, axis_name="", n_shards=1,
                       scale=1.0 / math.sqrt(d), k_scale=ksc, v_scale=vsc))


@pytest.mark.parametrize("pos", [0, 1, 17, 39, 43])
def test_int8_decode_matches_jax_quantized_branch(pos):
    # one new token written at pos (past the cache's end at 43: no write,
    # all 40 positions attended), then attention over min(pos + 1, 40)
    q, kq, vq, ks, vs, nk, nv = _decode_inputs(pos)
    out, jk, jv, jks, jvs = _jax_branch(q.shape[-1])(
        q, kq, vq, nk, nv, jnp.int32(pos), ks, vs)
    caches = [torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)]
    slot = CacheSlot.at(torch.tensor(pos, dtype=torch.int32), kq.shape[1])
    got = decode_attention(torch.from_numpy(q), caches[0], caches[1],
                           torch.from_numpy(nk), torch.from_numpy(nv), slot,
                           caches[2], caches[3])
    assert _rel(got.numpy(), out) < 2e-5
    for c, w in zip(caches, (jk, jv, jks, jvs)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(w))


@pytest.mark.parametrize("d", [8, 24, 80, 96, 100, 192])
def test_int8_any_head_dim_matches_jax_quantized_branch(d):
    # head dims the card runs on a padded instance (8 on the int8 mode's
    # 16): the wrapper's plain version after the JAX branch's own write at
    # pos, over its pos + 1 positions, to 2e-5 in f32
    q, kq, vq, ks, vs, nk, nv = _decode_inputs(d, h=8, kv=2, d=d)
    pos = 29
    out, *caches = _jax_branch(d)(q, kq, vq, nk, nv, jnp.int32(pos), ks, vs)
    k, v, k_scale, v_scale = (torch.from_numpy(np.array(c)) for c in caches)
    got = flash_decode.flash_decode(torch.from_numpy(q), k, v, pos + 1,
                                    k_scale, v_scale)
    assert got.shape == q.shape
    assert _rel(got.numpy(), out) < 2e-5


@pytest.mark.parametrize("d", [32, 96, 128])
def test_int8_exact_dot_departs_only_by_rounding_flips(d):
    # the plain version with exact_dot (q . k's exact f32 value: the
    # kernel's arithmetic with q in f32) against its einsum-order sum (the
    # JAX package's arithmetic): the two f32 sums differ by a rounding or
    # so, and each P * v_scale rounds to the same bf16 value on both
    # sides but for the few within that of a bf16 rounding boundary; with
    # those terms taken from the einsum-order side the outputs agree to
    # 2e-5
    q, kq, vq, ks, vs, _, _ = _decode_inputs(40 + d, b=4, s=300, h=16, kv=2,
                                             d=d)
    q, k, v, k_scale, v_scale = (torch.from_numpy(a)
                                 for a in (q, kq, vq, ks, vs))
    length = torch.tensor([1, 77, 300, 250], dtype=torch.int32)
    terms = []
    for exact in (False, True):
        p = flash_decode._int8_softmax(q, k, length, k_scale, exact)
        f32 = p * flash_decode._per_head(v_scale)
        terms.append((p, f32, f32.to(torch.bfloat16)))
    (p, f32, bf), (p_x, f32_x, bf_x) = terms
    torch.testing.assert_close(f32_x, f32, rtol=1e-5, atol=0)
    flipped = bf_x != bf
    assert int(flipped.sum()) < 1e-3 * flipped.numel()
    mixed = torch.where(flipped, bf, bf_x)
    out = torch.einsum("bkgs,bskd->bkgd", mixed.float(), v.float()) \
        / p_x.sum(-1, keepdim=True)
    want = flash_decode.flash_decode_int8_plain(q, k, v, length, k_scale,
                                                v_scale)
    torch.testing.assert_close(out.reshape(want.shape), want, rtol=2e-5,
                               atol=2e-5)


def test_int8_plain_ragged_lengths_match_jax_rows():
    # per-row lengths (the JAX branch takes one pos for the batch, so each
    # row is held against its own call): 0 gives 0, as the kernel does
    q, kq, vq, ks, vs, nk, nv = _decode_inputs(11)
    s = kq.shape[1]
    lengths = [0, 1, 23, s]
    fn = _jax_branch(q.shape[-1])
    rows = [fn(q, kq, vq, nk, nv, jnp.int32(max(n, 1) - 1), ks, vs)
            for n in lengths]
    # every row's cache as its own call left it
    caches = [torch.from_numpy(np.stack([np.asarray(r[j])[i]
                                         for i, r in enumerate(rows)]))
              for j in range(1, 5)]
    got = flash_decode.flash_decode_int8_plain(
        torch.from_numpy(q), caches[0], caches[1],
        torch.tensor(lengths, dtype=torch.int32), caches[2], caches[3])
    assert not got[0].any()
    for i in range(1, len(lengths)):
        assert _rel(got[i].numpy(), np.asarray(rows[i][0])[i]) < 2e-5
    # the f32 oracle (P unrounded) agrees to bf16's step
    want = ref.flash_decode_int8_ref(
        torch.from_numpy(q), caches[0], caches[1],
        torch.tensor(lengths, dtype=torch.int32), caches[2], caches[3])
    torch.testing.assert_close(got[1:], want[1:], rtol=3e-2, atol=3e-2)


def test_flash_decode_wrapper_takes_the_int8_mode_on_cpu():
    q, kq, vq, ks, vs, _, _ = _decode_inputs(3)
    args = [torch.from_numpy(a) for a in (q, kq, vq)]
    scales = [torch.from_numpy(a) for a in (ks, vs)]
    got = ops.flash_decode(*args, 25, *scales)
    assert torch.equal(got, flash_decode.flash_decode_int8_plain(
        *args, 25, *scales))
    with pytest.raises(ValueError, match="both scales"):
        flash_decode.flash_decode(*args, 25, scales[0], None)


def _pair(arch, dtype="float32"):
    """(JAX prefill and decode models with kv_quant, params, lora, port
    model with kv_quant, port lora) on the same weights."""
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    jm = JaxModel(cfg, ShardingPlan(mode="prefill", kv_quant=True))
    jd = JaxModel(cfg, ShardingPlan(mode="decode", kv_quant=True))
    params, lora = jm.init(KEY), jm.init_lora(KEY, 4, 4)
    model = Model(dataclasses.replace(port_reduced(arch), dtype=dtype),
                  device="cpu", kv_quant=True)
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    return jm, jd, params, lora, model, bridge.lora_to_torch(
        jax.tree.map(np.asarray, lora))


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _pair(arch)
        return built[arch]
    return get


def _tokens(b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s), np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_quantizes_as_jax(pairs, arch):
    # The cache a prefill returns is quantize_kv of the layer's K/V, over D
    # per (token, head), on both sides: JAX's int8 cache is bit for bit the
    # port's quantize_kv of JAX's unquantized K/V, and the port's is bit for
    # bit the port's quantize_kv of its own.  (The two sides' f32 K/V
    # differ in their last bits, as their f32 products are summed in
    # another order: ROADMAP.md queue 3.)
    jm, _, params, lora, model, port_lora = pairs(arch)
    cfg = jm.cfg
    tokens, idx = _tokens()[:, :-1], np.array([1, 2], np.int32)
    jm_fp = JaxModel(cfg, ShardingPlan(mode="prefill"))
    _, jq = jax.jit(jm.prefill)(params, lora, tokens, idx)
    _, jfp = jax.jit(jm_fp.prefill)(params, lora, tokens, idx)
    jq = bridge.cache_to_torch(jax.tree.map(np.asarray, jq))
    jfp = bridge.cache_to_torch(jax.tree.map(np.asarray, jfp))
    model_fp = Model(model.cfg, device="cpu")
    model_fp.load_state_dict(model.state_dict())
    t_tok, t_idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    _, pq = model.prefill(port_lora, t_tok, t_idx)
    _, pfp = model_fp.prefill(port_lora, t_tok, t_idx)
    kinds = model.cfg.layer_kinds
    assert "global" in kinds
    for kind, jql, jfl, pql, pfl in zip(kinds, jq["layers"], jfp["layers"],
                                        pq["layers"], pfp["layers"]):
        if kind == "local":   # the model's dtype, as without kv_quant
            assert set(pql) == set(jql) == {"k_loc", "v_loc"}
            assert all(torch.equal(pql[n], pfl[n]) for n in pql)
            assert all(jql[n].dtype == torch.float32 for n in jql)
            continue
        assert set(pql) == set(jql) == {"k", "v", "k_scale", "v_scale"}
        for n in "kv":
            assert pql[n].dtype == torch.int8 and \
                pql[f"{n}_scale"].dtype == torch.float16
            assert pql[f"{n}_scale"].shape == pql[n].shape[:3]
            for got, fp in ((jql, jfl), (pql, pfl)):
                q, s = quantize_kv(fp[n])
                assert torch.equal(got[n], q)
                assert torch.equal(got[f"{n}_scale"].view(torch.int16),
                                   s.view(torch.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_pad_cache_matches_jax(pairs, arch):
    jm, jd, params, lora, model, port_lora = pairs(arch)
    tokens, idx = _tokens(), np.array([1, 2], np.int32)
    t_tok, t_idx = torch.from_numpy(tokens).long(), torch.from_numpy(idx)
    _, jcache = jax.jit(jm.prefill)(params, lora, tokens[:, :-1], idx)
    jcache = jax_pad_cache(jcache, 4)
    want, jnew = jax.jit(jd.decode_step)(params, lora, jcache,
                                         tokens[:, -1:], idx)
    _, cache = model.prefill(port_lora, t_tok[:, :-1], t_idx)
    padded = model.pad_cache(cache, 4)
    # the padded scales have zero rows, as JAX's pad_cache gives them
    g = model.cfg.layer_kinds.index("global")
    assert padded["layers"][g]["k_scale"].shape[1] == tokens.shape[1] + 3
    assert not padded["layers"][g]["k_scale"][:, -4:].any()
    got, new = model.decode_step(port_lora, padded, t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4
    assert int(new["pos"]) == tokens.shape[1]
    assert new["layers"][g]["k"].dtype == torch.int8
    # JAX's padded cache, bridged, decodes to the same logits
    got, _ = model.decode_step(
        port_lora, bridge.cache_to_torch(jax.tree.map(np.asarray, jcache)),
        t_tok[:, -1:], t_idx)
    assert _rel(got, want) < 2e-4


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen1.5-4b"])
def test_int8_decode_close_to_unquantized(pairs, arch):
    # the port of test_int8_kv_decode_close_to_fp: the same weights with
    # and without kv_quant, decode after pad_cache(prefill, 4)
    model, port_lora = pairs(arch)[4:]
    model_fp = Model(model.cfg, device="cpu")
    model_fp.load_state_dict(model.state_dict())
    tokens = torch.from_numpy(_tokens(seed=1)).long()
    idx = torch.tensor([0, 1], dtype=torch.int32)
    out = []
    for m in (model_fp, model):
        _, cache = m.prefill(port_lora, tokens[:, :-1], idx)
        logits, new = m.decode_step(port_lora, m.pad_cache(cache, 4),
                                    tokens[:, -1:], idx)
        out.append(logits)
    kv = new["layers"][0]
    assert kv["k"].dtype == torch.int8 and "k_scale" in kv
    assert _rel(out[1], out[0]) < 2e-2


@pytest.mark.parametrize("arch,cache_len", [
    ("phi4-mini-3.8b", CACHE_LEN),
    # reduced gemma3 (window 16): int8 global caches end at step 20 while
    # the local layers' 16-row buffers (f32) wrap at step 16
    ("gemma3-1b", 20)])
def test_executor_chain_matches_jax_executor(pairs, arch, cache_len):
    _, jd, params, lora, model, port_lora = pairs(arch)
    max_batch, n_running = 8, 5
    ex = TorchExecutor(model, port_lora, max_batch=max_batch,
                       cache_len=cache_len, device="cpu")
    decode = jax.jit(jd.decode_step)
    jcache = jd.init_cache(max_batch, cache_len)
    tokens = jnp.zeros((max_batch, 1), jnp.int32)
    rng = np.random.default_rng(max_batch)
    for step in range(cache_len + 4):
        adapters = rng.integers(0, 9, n_running)
        running = [Request(uid=i, adapter=int(a), arrival=0.0, prompt_len=4,
                           output_len=4) for i, a in enumerate(adapters)]
        ex.step(StepPlan(admitted=[], preempted=[], cold_loads=[],
                         running=running), n_waiting=0)
        idx = np.zeros(max_batch, np.int32)
        idx[:n_running] = adapters % 4
        want, jcache = decode(params, lora, jcache, tokens, jnp.asarray(idx))
        assert _rel(ex.last_logits.numpy(), want) < 2e-4, f"step {step}"
    assert int(ex.cache["pos"]) == int(jcache["pos"]) == cache_len + 4
    # every row of the int8 caches and their scales was written, none past
    # their end; the same keys and dtypes as the JAX cache's
    got = bridge.cache_to_numpy(ex.cache, model.cfg)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jcache))
    for g, w in zip(jax.tree.leaves(got["segments"]),
                    jax.tree.leaves(jcache["segments"])):
        assert g.dtype == w.dtype and g.shape == w.shape
    for c in ex.cache["layers"]:
        if "k_scale" in c:
            assert bool((c["k_scale"] > 0).all() and (c["v_scale"] > 0).all())

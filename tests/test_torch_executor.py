"""The port's decode step with its position on the device, held against the
JAX package on the CPU.

``TorchExecutor`` (eager on the CPU, with the plain kernels) runs
``cache_len + 4`` engine steps, crossing the cache's end, against the JAX
executor's chain of jitted ``decode_step`` calls on the same weights: the
logits within a relative error of 2e-4 (test_consistency.py:39) at every
step, reduced phi4-mini, reduced gemma3 (whose local layers' rolling
buffers wrap), reduced olmoe (MoE layers) and reduced recurrentgemma
(rglru states beside a wrapping rolling buffer) in float32.  Also: ``pos`` as a 0-d tensor that
``decode_step`` advances in place, the cache write against the JAX
package's at positions inside and outside the cache, and the launch-count
helper that graph replays count through.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models.attention import decode_update_cache as jax_update  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced as port_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import CacheSlot, decode_update_cache  # noqa: E402
from repro_torch.serving.executor import TorchExecutor  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.scheduler import StepPlan  # noqa: E402

CACHE_LEN = 8


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / (np.max(np.abs(want)) + 1e-9))


def _build(arch):
    """(JAX decode model, params, lora, port model, port lora) on the same
    float32 weights of reduced ``arch``, 4 adapters of rank 4."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jd = JaxModel(cfg, ShardingPlan(mode="decode"))
    key = jax.random.PRNGKey(5)
    params, lora = jd.init(key), jd.init_lora(key, 4, 4)
    model = Model(dataclasses.replace(port_reduced(arch), dtype="float32"),
                  device="cpu")
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    return jd, params, lora, model, bridge.lora_to_torch(
        jax.tree.map(np.asarray, lora))


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _build(arch)
        return built[arch]
    return get


@pytest.fixture(scope="module")
def pair(pairs):
    return pairs("phi4-mini-3.8b")


@pytest.mark.parametrize("arch,max_batch,n_running,cache_len", [
    pytest.param("phi4-mini-3.8b", 8, 5, CACHE_LEN, id="8-5"),
    pytest.param("phi4-mini-3.8b", 4, 4, CACHE_LEN, id="4-4"),
    # reduced gemma3 (window 16): at cache_len 20 the local layers' 16-row
    # buffers wrap at step 16 and the global caches end at step 20; at
    # cache_len 8 the buffers have 8 rows and wrap where the caches end
    pytest.param("gemma3-1b", 8, 5, 20, id="gemma3-8-5-20"),
    pytest.param("gemma3-1b", 4, 4, CACHE_LEN, id="gemma3-4-4-8"),
    # reduced olmoe: every layer's FFN the MoE (T 8, dropless)
    pytest.param("olmoe-1b-7b", 8, 5, CACHE_LEN, id="olmoe-8-5-8"),
    # reduced recurrentgemma (window 16): rglru states beside a rolling
    # buffer that wraps at step 16; the port's lora_count is 4, as the
    # JAX side's ids below assume (the JAX executor's own is 1)
    pytest.param("recurrentgemma-9b", 8, 5, 20, id="recurrentgemma-8-5-20"),
])
def test_executor_steps_match_jax_executor_chain(pairs, arch, max_batch,
                                                 n_running, cache_len):
    jd, params, lora, model, port_lora = pairs(arch)
    ex = TorchExecutor(model, port_lora, max_batch=max_batch,
                       cache_len=cache_len, device="cpu")
    # the JAX executor's sequence (executor.py:117-140): a jitted step on
    # its cache, the warmup's output discarded, the zero token every step
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
    # every row of the cache was written, none past a global cache's end
    got = bridge.cache_to_numpy(ex.cache, model.cfg)
    for g, w in zip(jax.tree.leaves(got["segments"]),
                    jax.tree.leaves(jcache["segments"])):
        assert _rel(g, w) < 2e-4


def test_decode_step_advances_device_pos_in_place(pair):
    model, port_lora = pair[3], pair[4]
    cache = model.init_cache(2, 4)
    assert cache["pos"].shape == () and cache["pos"].dtype == torch.int32
    assert cache["pos"].device == model.device
    tokens = torch.zeros((2, 1), dtype=torch.long)
    idx = torch.tensor([1, -1], dtype=torch.int32)
    pos = cache["pos"]
    for step in range(6):
        assert int(cache["pos"]) == step
        _, out = model.decode_step(port_lora, cache, tokens, idx)
        assert out is cache and cache["pos"] is pos
    assert int(pos) == 6
    # a padded prefill cache gets a position of its own
    _, pre = model.prefill(port_lora, torch.zeros((2, 3), dtype=torch.long),
                           idx)
    assert pre["pos"].shape == () and pre["pos"].dtype == torch.int32
    padded = model.pad_cache(pre, 2)
    model.decode_step(port_lora, padded, tokens, idx)
    assert int(padded["pos"]) == 4 and int(pre["pos"]) == 3


@pytest.mark.parametrize("pos", [-1, 0, 3, CACHE_LEN - 1, CACHE_LEN,
                                 CACHE_LEN + 5])
def test_cache_write_matches_jax(pos):
    rng = np.random.default_rng(pos + 2)
    cache = rng.standard_normal((2, CACHE_LEN, 3, 4)).astype(np.float32)
    new = rng.standard_normal((2, 3, 4)).astype(np.float32)
    want = jax_update(jnp.asarray(cache), jnp.asarray(new),
                      jnp.asarray(pos, jnp.int32), 0, CACHE_LEN)
    got = torch.from_numpy(cache.copy())
    slot = CacheSlot.at(torch.tensor(pos, dtype=torch.int32), CACHE_LEN)
    decode_update_cache(got, torch.from_numpy(new), slot)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert slot.length.dtype == torch.int32
    assert int(slot.length) == min(pos + 1, CACHE_LEN)


def test_add_launches_counts_replays():
    saved = ops.launch_counts()
    try:
        ops.reset_launches()
        per_step = {"bgmv": 64, "flash_decode": 32}
        ops.add_launches(per_step)
        ops.add_launches(per_step, 3)
        assert ops.launch_counts() == {"bgmv": 256, "sgmv": 0,
                                       "flash_decode": 128,
                                       "flash_decode_lse": 0,
                                       "flash_decode_lora": 0}
        ops.add_launches(per_step, -4)
        assert set(ops.launch_counts().values()) == {0}
        with pytest.raises(KeyError):
            ops.add_launches({"gemm": 1})
    finally:
        ops.reset_launches()
        ops.add_launches(saved)

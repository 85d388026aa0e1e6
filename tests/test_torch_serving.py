"""The port's serving layer: the copied engine against the original, the
torch executor against the JAX decode step (reduced phi4-mini, reduced
olmoe, and reduced phi4-mini and gemma3 on an int8 KV cache), and
end-to-end runs on CPU."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced  # noqa: E402
from repro.core import workload as jax_workload  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced as port_reduced  # noqa: E402
from repro_torch.core import workload  # noqa: E402
from repro_torch.launch.serve import build_parser, serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.executor import StepTiming, TorchExecutor  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.scheduler import StepPlan  # noqa: E402


class StubExecutor:
    """Deterministic step times from the plan alone."""

    def step(self, plan, n_waiting):
        return StepTiming(sched=1e-4 + 2e-6 * n_waiting,
                          load=0.002 * len(plan.cold_loads),
                          model=0.02 + 3e-4 * len(plan.running)
                          + 5e-6 * plan.prefill_tokens)


@pytest.mark.parametrize("dataset,policy", [("small", "fcfs"),
                                            ("sharegpt", "fcfs"),
                                            ("medium", "adapter-fair"),
                                            ("small", "adapter-cluster")])
def test_copied_engine_matches_reference(dataset, policy):
    def run(wl, engine_cls, cfg_cls):
        pool = wl.make_adapter_pool(12, [8, 16], [0.4, 0.2])
        reqs = wl.generate_requests(wl.WorkloadSpec(
            adapters=pool, dataset=dataset, horizon=40.0, seed=5))
        engine = engine_cls(cfg_cls(kv_capacity_tokens=6000,
                                    adapter_slots=4, sched_policy=policy),
                            StubExecutor())
        return reqs, engine.run(reqs, horizon=40.0)

    ref_reqs, want = run(jax_workload, JaxServingEngine, JaxEngineConfig)
    reqs, got = run(workload, ServingEngine, EngineConfig)
    assert [dataclasses.astuple(r) for r in reqs] == \
        [dataclasses.astuple(r) for r in ref_reqs]
    assert want.n_finished > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_executor_step_matches_jax_decode_step():
    _executor_step_matches_jax_decode_step("phi4-mini-3.8b")


def test_moe_executor_step_matches_jax_decode_step():
    _executor_step_matches_jax_decode_step("olmoe-1b-7b")


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma3-1b"])
def test_int8_cache_executor_step_matches_jax_decode_step(arch):
    # Model(kv_quant=True) against ShardingPlan(kv_quant=True): int8 global
    # caches (gemma3's local layers in the model's dtype)
    _executor_step_matches_jax_decode_step(arch, kv_quant=True)


def _executor_step_matches_jax_decode_step(arch, kv_quant=False):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jd = JaxModel(cfg, ShardingPlan(mode="decode", kv_quant=kv_quant))
    key = jax.random.PRNGKey(2)
    params, lora = jd.init(key), jd.init_lora(key, 4, 4)
    adapters = [5, 2, 7, 0, 3]
    # JaxExecutor.step: adapter % lora_count over a zero-padded batch of 8
    idx = np.zeros(8, np.int32)
    idx[:len(adapters)] = np.asarray(adapters) % 4
    want, _ = jd.decode_step(params, lora, jd.init_cache(8, 32),
                             np.zeros((8, 1), np.int32), idx)

    port_cfg = dataclasses.replace(port_reduced(arch), dtype="float32")
    model = Model(port_cfg, device="cpu", kv_quant=kv_quant)
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    ex = TorchExecutor(model, bridge.lora_to_torch(
        jax.tree.map(np.asarray, lora)), max_batch=8, cache_len=32,
        device="cpu")
    assert ex.lora_count() == 4
    running = [Request(uid=i, adapter=a, arrival=0.0, prompt_len=4,
                       output_len=4) for i, a in enumerate(adapters)]
    timing = ex.step(StepPlan(admitted=[], preempted=[], cold_loads=[7],
                              running=running), n_waiting=0)
    assert timing.load == pytest.approx(0.002) and timing.model > 0
    got = ex.last_logits.numpy()
    want = np.asarray(want)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-4
    assert int(ex.cache["pos"]) == 1
    if kv_quant:
        g = model.cfg.layer_kinds.index("global")
        assert ex.cache["layers"][g]["k"].dtype == torch.int8


def test_engine_with_torch_executor_serves_on_cpu():
    # run to completion: the engine's clock advances by measured step
    # times, so a horizon would make the finished count depend on the
    # machine's speed
    model = Model(port_reduced("phi4-mini-3.8b"), device="cpu")
    ex = TorchExecutor(model, model.init_lora(4, 8), max_batch=8,
                       cache_len=64, device="cpu")
    reqs = workload.generate_requests(workload.WorkloadSpec(
        adapters=workload.make_adapter_pool(6, [8], [0.5]), dataset="small",
        horizon=3.0))
    engine = ServingEngine(EngineConfig(kv_capacity_tokens=4096,
                                        adapter_slots=4), ex)
    metrics = engine.run(reqs)
    assert len(reqs) > 0 and metrics.n_finished == len(reqs)
    assert bool(torch.isfinite(ex.last_logits).all())


def test_serve_launcher_runs_on_cpu():
    args = build_parser().parse_args(["--horizon", "2", "--adapters", "4"])
    metrics, ex = serve(port_reduced("phi4-mini-3.8b"), args, device="cpu")
    assert metrics.duration > 0
    assert ex.last_logits.shape == (8, 512)
    assert bool(torch.isfinite(ex.last_logits).all())


def test_serve_launcher_serves_gemma3_on_cpu():
    # ``--arch gemma3-1b``: the reduced configuration main() serves, its
    # local layers on 16-row rolling buffers beside 512-row global caches
    args = build_parser().parse_args(["--arch", "gemma3-1b", "--horizon",
                                      "2", "--adapters", "4"])
    metrics, ex = serve(port_reduced(args.arch), args, device="cpu")
    assert metrics.duration > 0
    rows = {tuple(c)[0]: c[tuple(c)[0]].shape[1] for c in ex.cache["layers"]}
    assert rows == {"k_loc": 16, "k": 512}
    assert int(ex.cache["pos"]) > 0
    assert ex.last_logits.shape == (8, 512)
    assert bool(torch.isfinite(ex.last_logits).all())


def test_serve_launcher_serves_int8_cache_on_cpu():
    # serve(..., kv_quant=True), a keyword only: the JAX launcher has no
    # int8 flag, so the CLI has none either
    args = build_parser().parse_args(["--horizon", "2", "--adapters", "4"])
    assert not hasattr(args, "kv_quant")
    metrics, ex = serve(port_reduced("phi4-mini-3.8b"), args, device="cpu",
                        kv_quant=True)
    assert metrics.duration > 0
    assert ex.model.kv_quant
    kv = ex.cache["layers"][0]
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].shape == (8, 512, 2)
    assert bool(kv["k_scale"][:, 0].all())   # the first step was written
    assert ex.last_logits.shape == (8, 512)
    assert bool(torch.isfinite(ex.last_logits).all())


def test_serve_launcher_serves_olmoe_on_cpu():
    # ``--arch olmoe-1b-7b``: reduced olmoe, every layer's FFN 8 experts,
    # top-2 (T 8 a step, dropless)
    args = build_parser().parse_args(["--arch", "olmoe-1b-7b", "--horizon",
                                      "2", "--adapters", "4"])
    metrics, ex = serve(port_reduced(args.arch), args, device="cpu")
    assert metrics.duration > 0
    assert all(hasattr(blk, "moe") for blk in ex.model.layers)
    assert int(ex.cache["pos"]) > 0
    assert ex.last_logits.shape == (8, 512)
    assert bool(torch.isfinite(ex.last_logits).all())


def test_serve_launcher_serves_recurrentgemma_on_cpu():
    # ``--arch recurrentgemma-9b``: reduced recurrentgemma, rglru layers on
    # conv and lru states beside a local layer's 16-row rolling buffer;
    # each request on its own adapter (lora_count 4)
    args = build_parser().parse_args(["--arch", "recurrentgemma-9b",
                                      "--horizon", "2", "--adapters", "4"])
    metrics, ex = serve(port_reduced(args.arch), args, device="cpu")
    assert metrics.duration > 0 and ex.lora_count() == args.slots
    assert [sorted(c) for c in ex.cache["layers"]][:3] == [
        ["conv", "lru"], ["conv", "lru"], ["k_loc", "v_loc"]]
    assert ex.cache["layers"][2]["k_loc"].shape[1] == 16
    assert int(ex.cache["pos"]) > 0
    assert bool(ex.cache["layers"][0]["lru"].any())
    assert ex.last_logits.shape == (8, 512)
    assert bool(torch.isfinite(ex.last_logits).all())

"""The port's struct-of-arrays ``FastTwin``, its object-mode ``DigitalTwin``
at the JAX signature and its placement sweep (``fast=True`` by default),
against the JAX package's and against each other, on the CPU.

Every case builds its inputs on each side from that side's own modules
(estimators, adapter pool, workload spec, request stream) with the same
arguments; the port's copies are plain Python and NumPy like the
originals, so each side sees the same numbers.  Held as
``tests/test_fast_twin.py`` holds the two JAX twins: equal on every field
of ``TWIN_EXACT_FIELDS``, mean ITL to 1e-9 relative (the fast twin
telescopes the per-token gaps that the object-mode twin averages).  The
cases are the single-node ones of ``tests/test_fast_twin.py:61-156``, the
shared-prefix cache (``tests/test_prefix_cache.py:205``), a capped running
set (``tests/test_sched_policy.py:220``) and S-LoRA's dynamic slots.

One case, ``cold_loads_summed``, is held to the JAX object-mode twin and
not to the JAX ``FastTwin``: there a step's cold-load latencies summed by
a running ``+=`` (the JAX copy) and by ``sum()`` (the object-mode twin;
compensated from Python 3.12) part in the last bit, and the clock keeps
the difference.  The port's ``FastTwin`` sums them by ``sum()``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.serving.metrics import TWIN_EXACT_FIELDS  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.serving.policy import SCHED_POLICIES  # noqa: E402

from test_torch_twin import _fits, _same, _surfaces  # noqa: E402

POLICIES = sorted(SCHED_POLICIES)


def _est(c, kv_base=120000.0, kv_slope=-60.0):
    """Hand-built Eq. (1) fits (tests/test_fast_twin.py:27-36)."""
    return c.FittedEstimators(
        sched=np.array([4e-4, 8e-6, 4e-6, 2.5e-5]),
        model=np.array([2.4e-2, 2.2e-4, 6.5e-6]),
        adapters=np.array([1.06, 0.004]),
        load=np.array([8e-3, 1.1e-3]),
        load_disk_mult=1.7,
        memmax=np.array([kv_base, kv_slope]))


def _case(c, name):
    """(estimators, twin keywords, spec, slots, requests, simulate
    keywords) of case ``name``, built from core module ``c``."""
    est, twin, requests, sim = _est(c), {"mode": "mean"}, None, {}
    if name == "uniform":
        pool = c.make_adapter_pool(24, [8, 16, 32], [0.15])
        spec, slots = c.WorkloadSpec(pool, "medium", 80.0, 3), 8
    elif name == "skewed_sharegpt":
        pool = c.make_adapter_pool(32, [8, 16, 32], [1.6, 0.4, 0.1, 0.025])
        spec, slots = c.WorkloadSpec(pool, "sharegpt", 80.0, 11), 6
    elif name == "drifting_full":
        pool = c.make_adapter_pool(16, [8, 16], [0.05])
        phases = c.rotating_hot_phases(pool, 60.0, n_phases=3,
                                       hot_fraction=0.25, hot_rate=1.0,
                                       cold_rate=0.02)
        requests = c.generate_drifting_requests(pool, "medium", 60.0, phases,
                                                seed=5)
        spec, slots, twin = c.WorkloadSpec(pool, "medium", 60.0, 5), 4, \
            {"mode": "full"}
    elif name == "full_exact_stream":
        pool = c.make_adapter_pool(20, [8, 16], [0.2, 0.1])
        spec, slots, twin = c.WorkloadSpec(pool, "sharegpt", 70.0, 9), 5, \
            {"mode": "full"}
        requests = c.generate_requests(spec)
    elif name == "slot_pressure":
        pool = c.make_adapter_pool(48, [8, 16, 32], [0.05])
        spec, slots = c.WorkloadSpec(pool, "medium", 120.0, 7), 4
    elif name == "preemption":
        est = _est(c, kv_base=5000.0, kv_slope=-5.0)
        pool = c.make_adapter_pool(12, [8, 16], [0.5, 0.3])
        spec, slots = c.WorkloadSpec(pool, "sharegpt", 90.0, 5), 6
    elif name.startswith("policy_"):
        policy = name.split("_")[1]
        if name.endswith("_preemption"):
            est = _est(c, kv_base=5000.0, kv_slope=-5.0)
            pool = c.make_adapter_pool(12, [8, 16], [0.5, 0.3])
            spec, slots = c.WorkloadSpec(pool, "sharegpt", 60.0, 5), 6
            twin = {"mode": "mean", "sched_policy": policy}
        else:
            pool = c.make_adapter_pool(24, [8, 16, 32],
                                       [1.2, 0.3, 0.08, 0.02])
            spec, slots = c.WorkloadSpec(pool, "sharegpt", 70.0, 13), 4
            requests = c.generate_requests(spec)
            twin = {"mode": "full", "sched_policy": policy}
    elif name == "prefix_cache":
        est = _est(c, kv_base=4000.0, kv_slope=-30.0)
        pool = c.make_adapter_pool(8, [8, 16], [0.5, 0.25])
        spec = c.WorkloadSpec(pool, "medium", 40.0, 13, prefix_share=0.8,
                              prefix_len=160)
        requests, slots = c.generate_requests(spec), 3
        twin = {"mode": "full", "prefix_cache": True}
    elif name == "max_running_32":
        pool = c.make_adapter_pool(24, [8, 16], [0.05])
        phases = c.rotating_hot_phases(pool, 60.0, n_phases=2,
                                       hot_fraction=0.2, hot_rate=1.8,
                                       cold_rate=0.05)
        requests = c.generate_drifting_requests(pool, "medium", 60.0, phases,
                                                seed=3)
        spec, slots = c.WorkloadSpec(pool, "medium", 60.0, 3), 3
        twin = {"mode": "full", "max_running": 32,
                "sched_policy": "adapter-fair"}
    elif name == "cold_loads_summed":
        # phase 7's sweep point N 16, G 4 on a measured surface whose
        # decode steps are short beside adapter loads: a step there loads
        # ranks 16, 8 and 32 at once, and the two ways of summing their
        # latencies give clocks one ulp apart
        est = _fits()[0 if c is core else 1][2]
        surface = c.MeasuredStepTimes(
            decode=np.array([1.912891307763394e-05, 1.9741365231431525e-08,
                             5.439981304035021e-11, 4.4059121499748525e-11]),
            prefill_per_token=7.729256326094218e-10,
            adapters=np.array([1.0, 3.637038490501321e-05]))
        pool = c.make_adapter_pool(16, [8, 16, 32], [3.2])
        spec, slots = c.WorkloadSpec(pool, "small", 60.0, 0), 4
        twin = {"mode": "mean", "measured_step_times": surface}
    elif name == "dynamic_slots":
        pool = c.make_adapter_pool(16, [8, 16, 32], [0.3, 0.1])
        spec, slots = c.WorkloadSpec(pool, "sharegpt", 60.0, 4), 0
        sim = {"dynamic_slots": True, "horizon": 45.0}
    else:
        raise KeyError(name)
    return est, twin, spec, slots, requests, sim


CASES = (["uniform", "skewed_sharegpt", "drifting_full", "full_exact_stream",
          "slot_pressure", "preemption"]
         + [f"policy_{p}" for p in POLICIES]
         + [f"policy_{p}_preemption" for p in POLICIES]
         + ["prefix_cache", "max_running_32", "dynamic_slots"])


def _run(c, twin_cls, name):
    est, twin, spec, slots, requests, sim = _case(c, name)
    return getattr(c, twin_cls)(est, **twin).simulate(
        spec, slots=slots, requests=requests, **sim).metrics


def _equal(a, b, rel=0.0):
    for f in TWIN_EXACT_FIELDS:
        assert getattr(a, f) == getattr(b, f), \
            f"{f}: {getattr(a, f)} != {getattr(b, f)}"
    assert a.itl == pytest.approx(b.itl, rel=rel, abs=1e-12)


@pytest.mark.parametrize("name", CASES)
def test_fast_twin_matches_jax_fast_twin(name):
    port, ref = _run(core, "FastTwin", name), _run(jcore, "FastTwin", name)
    assert ref.n_finished > 0
    _equal(port, ref, rel=1e-9)


@pytest.mark.parametrize("name", CASES + ["cold_loads_summed"])
def test_fast_twin_matches_port_digital_twin(name):
    fast, legacy = _run(core, "FastTwin", name), _run(core, "DigitalTwin",
                                                      name)
    _equal(fast, legacy, rel=1e-9)
    # the cases reach the paths they are named for
    if "preemption" in name:
        assert legacy.n_preemptions > 0
    if name == "slot_pressure":
        assert legacy.n_loads > 48
    if name == "prefix_cache":
        assert legacy.n_prefix_hits > 0 and legacy.prefix_tokens_saved > 0


@pytest.mark.parametrize("name", [f"policy_{p}" for p in POLICIES]
                         + ["prefix_cache", "max_running_32",
                            "dynamic_slots"])
def test_digital_twin_matches_jax(name):
    # the object-mode twin's options beyond its defaults: each scheduling
    # policy, the shared-prefix cache, a capped running set, dynamic slots
    port, ref = _run(core, "DigitalTwin", name), _run(jcore, "DigitalTwin",
                                                      name)
    assert ref.n_finished > 0
    _equal(port, ref)


def test_fast_twin_sums_cold_loads_as_the_object_twin():
    # the port's FastTwin equals the JAX object-mode twin where the JAX
    # FastTwin's running sum of cold-load latencies parts from it (the
    # case reaches that step: the two JAX twins' clocks differ)
    port = _run(core, "FastTwin", "cold_loads_summed")
    ref = _run(jcore, "DigitalTwin", "cold_loads_summed")
    _equal(port, ref, rel=1e-9)
    assert _run(jcore, "FastTwin", "cold_loads_summed").duration \
        != ref.duration


def test_full_mode_leaves_the_callers_stream_as_it_was():
    est, twin, spec, slots, requests, _ = _case(core, "full_exact_stream")
    core.FastTwin(est, **twin).simulate(spec, slots=slots, requests=requests)
    assert all(r.generated == 0 and r.finished_at is None for r in requests)


def test_drifting_requests_match_jax():
    # the drifting workload's phases and stream (with shared prefixes), and
    # the analytic prefix hit rate, equal to the JAX package's
    out = []
    for c in (core, jcore):
        pool = c.make_adapter_pool(16, [8, 16], [0.05])
        phases = c.rotating_hot_phases(pool, 60.0, n_phases=3)
        reqs = c.generate_drifting_requests(pool, "sharegpt", 60.0, phases,
                                            seed=5, prefix_share=0.5,
                                            prefix_len=32)
        spec = c.WorkloadSpec(pool, "medium", 60.0, 5, prefix_share=0.5,
                              prefix_len=32)
        out.append(([(p.start, p.rates) for p in phases],
                    [(r.uid, r.adapter, r.arrival, r.prompt_len,
                      r.output_len, r.prefix_id, r.prefix_len) for r in reqs],
                    c.expected_prefix_hit_rate(spec)))
    assert out[0] == out[1]
    assert any(r[5] is not None for r in out[0][1])


def _point_key(res):
    return (res.n_adapters, res.slots, res.throughput,
            [(p.n_adapters, p.slots, p.throughput, p.ideal, p.starved)
             for p in res.curve])


@pytest.mark.parametrize("policy", [None, "fcfs", "adapter-fair"])
def test_placement_fast_matches_object_mode(policy):
    # tests/test_fast_twin.py:276-283 (no policy) and :158-168 (the
    # policy axis): the same (N*, G*), throughput and curve on both twins
    est = _est(core)
    pool = core.make_adapter_pool(16, [8, 16], [0.3, 0.1])
    if policy is None:
        kw = dict(horizon=40.0, seed=2, n_grid=[4, 8, 16])
    else:
        kw = dict(horizon=30.0, seed=2, n_grid=[4, 16], sched_policy=policy)
    a = core.find_optimal_placement(est, pool, "medium", fast=False, **kw)
    b = core.find_optimal_placement(est, pool, "medium", fast=True, **kw)
    assert len(b.curve) >= 2 * len(kw["n_grid"])
    assert _point_key(a) == _point_key(b)


def test_placement_fast_matches_object_mode_on_a_measured_surface():
    # chip_smoke.py phase 7's measured sweep, cut to N 16: the slots that
    # N 16 sweeps include G 4, where a step's cold loads sum in the last
    # bit by the summation order
    est, twin, spec, _, _, _ = _case(core, "cold_loads_summed")
    kw = dict(horizon=spec.horizon, seed=spec.seed, n_grid=[16],
              measured_step_times=twin["measured_step_times"])
    a = core.find_optimal_placement(est, spec.adapters, spec.dataset,
                                    fast=False, **kw)
    b = core.find_optimal_placement(est, spec.adapters, spec.dataset,
                                    fast=True, **kw)
    assert (16, 4) in [(p.n_adapters, p.slots) for p in b.curve]
    assert _point_key(a) == _point_key(b)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("measured", [False, True])
def test_placement_sweep_matches_jax_sweep(measured, fast):
    # the port's sweep on each twin against the JAX sweep on the same
    # twin, with and without a measured surface (the fits of
    # tests/test_torch_twin.py)
    (_, _, p_est), (_, _, j_est) = _fits()
    p_ms, j_ms = _surfaces() if measured else (None, None)
    kw = dict(dataset="small", horizon=30.0, seed=2, fast=fast)
    port = core.find_optimal_placement(
        p_est, core.make_adapter_pool(16, [8, 16, 32], [6.4, 3.2, 1.6]),
        measured_step_times=p_ms, **kw)
    ref = jcore.find_optimal_placement(
        j_est, jcore.make_adapter_pool(16, [8, 16, 32], [6.4, 3.2, 1.6]),
        measured_step_times=j_ms, **kw)
    assert port.best is not None
    assert (port.n_adapters, port.slots) == (ref.n_adapters, ref.slots)
    assert [(p.n_adapters, p.slots, p.starved) for p in port.curve] == \
        [(p.n_adapters, p.slots, p.starved) for p in ref.curve]
    _same([p.throughput for p in port.curve],
          [p.throughput for p in ref.curve])
    _same([p.ideal for p in port.curve], [p.ideal for p in ref.curve])


def test_placement_with_shared_prefixes_matches_jax():
    # prefix_share/prefix_len give the sweep's workload shared prefixes
    # and turn on both twins' shared-prefix cache
    kw = dict(horizon=30.0, seed=2, n_grid=[4, 8], prefix_share=0.6,
              prefix_len=96)
    res = [c.find_optimal_placement(
        _est(c, kv_base=8000.0, kv_slope=-30.0),
        c.make_adapter_pool(8, [8, 16], [0.5, 0.25]), "medium", **kw)
        for c in (core, jcore)]
    assert _point_key(res[0]) == _point_key(res[1])

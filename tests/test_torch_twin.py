"""The port's Digital Twin path against the JAX package's, on identical
inputs: the measured-surface fit, the Eq. (1) fits from the synthetic
executor's rows, ``DigitalTwin.simulate`` (modes ``full`` and ``mean``,
with and without a measured surface) and ``find_optimal_placement``.

The port's copies are plain Python and NumPy like the originals, so the
results must be equal: exactly where both sides run the same float
operations in the same order, else to 1e-12 relative.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.serving import executor as jexec  # noqa: E402
from repro.serving.metrics import TWIN_EXACT_FIELDS  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.serving import executor  # noqa: E402


def _rows():
    """Kernel-benchmark rows of every kind, with noise on a planted
    surface (so the least-squares fits have residuals)."""
    rng = np.random.default_rng(0)
    rows = []
    for b in (1, 8, 32):
        for s in (256, 1024, 4096):
            for r in (8, 16, 32):
                t = 2e-5 + 1e-6 * b + 4e-10 * b * s + 3e-8 * b * r
                rows.append(dict(kind="decode", batch=b, seq=s, rank=r,
                                 t=t * rng.uniform(0.9, 1.1), cv=0.01))
    for tok in (512, 2048, 4096):
        rows.append(dict(kind="prefill", tokens=tok,
                         t=(5e-5 + 2e-8 * tok) * rng.uniform(0.9, 1.1),
                         cv=0.01))
    for a in (1, 2, 8, 32):
        rows.append(dict(kind="adapters", a_unique=a,
                         mult=1.0 + 0.01 * (a - 1) * rng.uniform(0.5, 1.5),
                         cv=0.01))
    return rows


def _surfaces():
    rows = _rows()
    return (core.fit_measured_step_times(rows, mean_seq=1792.0,
                                         mean_rank=56 / 3),
            jcore.fit_measured_step_times(rows, mean_seq=1792.0,
                                          mean_rank=56 / 3))


def _fits(slots=32, n_adapters=96):
    """(port, jax) estimators fitted from each side's synthetic executor
    and memory probe, as ``repro.core.pipeline.build_pipeline`` fits
    them."""
    ranks = {i: (8, 16, 32)[i % 3] for i in range(n_adapters)}
    out = []
    for ex_mod, c in ((executor, core), (jexec, jcore)):
        prof = ex_mod.HardwareProfile()
        ex = ex_mod.SyntheticExecutor(prof, dict(ranks), slots=slots,
                                      n_adapters=n_adapters, seed=0)
        step_rows = c.collect_benchmark(ex, slots, n_adapters, ranks)
        mem_rows = c.collect_memmax(prof, seed=0)
        out.append((step_rows, mem_rows,
                    c.fit_estimators(step_rows, mem_rows, slots,
                                     n_adapters)))
    return out


def _same(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=1e-12, atol=0)


def test_measured_fit_matches_jax():
    port, jax_side = _surfaces()
    for f in ("decode", "prefill_per_token", "adapters", "mean_seq",
              "mean_rank"):
        _same(getattr(port, f), getattr(jax_side, f))
    for r_run, pf in ((1, 0), (8, 512), (32, 0)):
        _same(port.lat_model(r_run, pf), jax_side.lat_model(r_run, pf))
    for a in (0, 1, 5):
        _same(port.lat_adapters(a), jax_side.lat_adapters(a))


def test_synthetic_rows_and_fits_match_jax():
    (p_rows, p_mem, p_est), (j_rows, j_mem, j_est) = _fits()
    assert p_rows == j_rows and p_mem == j_mem
    for f in ("sched", "model", "adapters", "load", "memmax"):
        _same(getattr(p_est, f), getattr(j_est, f))
    assert p_est.load_disk_mult == j_est.load_disk_mult
    assert p_est.measured is None


def _spec(c, seed=3, dataset="medium", horizon=60.0):
    pool = c.make_adapter_pool(24, [8, 16, 32], [0.15, 0.4])
    return c.WorkloadSpec(adapters=pool, dataset=dataset, horizon=horizon,
                          seed=seed)


def _assert_metrics_equal(a, b):
    for f in TWIN_EXACT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    _same(a.itl, b.itl)


@pytest.mark.parametrize("mode", ["full", "mean"])
@pytest.mark.parametrize("measured", [False, True])
def test_twin_simulate_matches_jax(mode, measured):
    (_, _, p_est), (_, _, j_est) = _fits()
    p_ms, j_ms = _surfaces() if measured else (None, None)
    res = []
    for c, est, ms in ((core, p_est, p_ms), (jcore, j_est, j_ms)):
        spec = _spec(c, dataset="sharegpt")
        reqs = c.generate_requests(spec) if mode == "full" else None
        res.append(c.DigitalTwin(est, mode=mode, measured_step_times=ms)
                   .simulate(spec, slots=8, requests=reqs).metrics)
    assert res[0].n_finished > 0
    _assert_metrics_equal(*res)


def test_resampled_stream_matches_jax():
    p_spec, j_spec = _spec(core, dataset="sharegpt"), _spec(
        jcore, dataset="sharegpt")
    p = core.resample_requests(p_spec, p_spec.length_stats())
    j = jcore.resample_requests(j_spec, j_spec.length_stats())
    assert [(r.uid, r.adapter, r.arrival, r.prompt_len, r.output_len)
            for r in p] == [(r.uid, r.adapter, r.arrival, r.prompt_len,
                             r.output_len) for r in j]


@pytest.mark.parametrize("twin_mode", ["full", "mean"])
def test_measured_none_is_bitwise_the_plain_twin(twin_mode):
    # tests/test_measured_step_times.py's pin, on the port's twin
    (_, _, est), _ = _fits()
    spec = _spec(core)
    reqs = core.generate_requests(spec)
    plain = core.DigitalTwin(est, mode=twin_mode).simulate(
        spec, slots=8, requests=reqs).metrics
    hooked = core.DigitalTwin(est, mode=twin_mode, measured_step_times=None
                              ).simulate(spec, slots=8, requests=reqs).metrics
    for f in TWIN_EXACT_FIELDS:
        assert getattr(plain, f) == getattr(hooked, f), f
    assert plain.itl == hooked.itl


@pytest.mark.parametrize("measured", [False, True])
def test_placement_sweep_matches_jax(measured):
    # the port's default sweep (on its FastTwin) against the JAX package's
    # FastTwin (its default) and object-mode twin: the same labels
    (_, _, p_est), (_, _, j_est) = _fits()
    p_ms, j_ms = _surfaces() if measured else (None, None)
    kw = dict(dataset="small", horizon=30.0, seed=2)
    p_pool = core.make_adapter_pool(16, [8, 16, 32], [6.4, 3.2, 1.6])
    j_pool = jcore.make_adapter_pool(16, [8, 16, 32], [6.4, 3.2, 1.6])
    port = core.find_optimal_placement(p_est, p_pool,
                                       measured_step_times=p_ms, **kw)
    for fast in (False, True):
        ref = jcore.find_optimal_placement(j_est, j_pool, fast=fast,
                                           measured_step_times=j_ms, **kw)
        assert (port.n_adapters, port.slots) == (ref.n_adapters, ref.slots)
        assert [(p.n_adapters, p.slots, p.starved) for p in port.curve] == \
            [(p.n_adapters, p.slots, p.starved) for p in ref.curve]
        _same([p.throughput for p in port.curve],
              [p.throughput for p in ref.curve])
        _same([p.ideal for p in port.curve], [p.ideal for p in ref.curve])
    assert port.best is not None

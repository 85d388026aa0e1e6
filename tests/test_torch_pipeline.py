"""The port's placement-model creation phase (paper Fig. 1) against the JAX
package's, on the CPU: the feature encoding and the scenario grid, the
interpretable models of ``MODEL_ZOO``, the twin-labelled dataset
(``label_scenarios``, serially and through ``SweepRunner``'s process
pool), the pipeline's ``recommend`` and the plan-level ``PlacementRouter``.

Each side builds its inputs from its own modules with the same arguments;
the port's copies are plain Python and NumPy like the originals.  Features
are held bitwise and the (N*, G*) labels exactly; throughput labels, model
predictions and ``recommend``'s throughput to 1e-12 relative: the port's
``FastTwin`` sums a step's cold loads by ``sum()``, the JAX one by ``+=``
(``tests/test_torch_fast_twin.py``, case ``cold_loads_summed``).  The last
cases are ports of ``tests/test_placement_and_forest.py:59-99`` onto the
port's models, the hypothesis-drawn seeds of one as parameters.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro_torch import core, serving  # noqa: E402
from repro_torch.core import sweep  # noqa: E402

from test_torch_fast_twin import _est  # noqa: E402
from test_torch_twin import _fits, _same, _surfaces  # noqa: E402

STATS = {"in_mean": 250, "in_std": 0, "out_mean": 231, "out_std": 0}
SIDES = ((core, serving), (jcore, jserving))
# the creation phase at test_system.py's size
PIPELINE = dict(n_scenarios=8, max_adapters=32, horizon=60.0)
# label_scenarios at a small size: 4 scenarios of the paper's grid (on
# the measured surface, whose short steps make each twin run longer, at
# fewer adapters and a shorter horizon)
LABEL = dict(max_adapters=32, horizon=60.0, seed=0)
LABEL_MEASURED = dict(max_adapters=12, horizon=15.0, seed=0)


def _labels_equal(port, jax_side):
    """(xs, ys) of label_scenarios: features bitwise, (N*, G*) exactly,
    throughput to 1e-12."""
    (xp, yp), (xj, yj) = port[:2], jax_side[:2]
    assert xp.shape == xj.shape and np.array_equal(xp, xj)
    assert np.array_equal(yp[:, 1:], yj[:, 1:])
    _same(yp[:, 0], yj[:, 0])
    assert np.all(np.isfinite(xp)) and np.all(np.isfinite(yp))


def _prefix_scenarios(c):
    """tests/test_prefix_cache.py:414-418, the first four shares."""
    return [c.Scenario(rates=(0.08, 0.04, 0.02), ranks=(8, 16),
                       dataset="medium", prefix_share=s, prefix_len=200)
            for s in (0.0, 0.05, 0.1, 0.15)]


@pytest.fixture(scope="module")
def fitted():
    """(port, jax) estimators fitted as build_pipeline fits them."""
    return tuple(f[2] for f in _fits())


@pytest.fixture(scope="module")
def analytic_labels(fitted):
    """Each side's serial labels of the grid's first 4 scenarios."""
    return tuple(c.label_scenarios(est, c.scenario_grid(limit=4), **LABEL)
                 for c, est in zip((core, jcore), fitted))


@pytest.fixture(scope="module")
def pipelines():
    """(port, jax) creation phases at test_system.py's size."""
    return tuple(c.build_pipeline(**PIPELINE) for c in (core, jcore))


# --------------------------------------------------------------------- #
# features and the scenario grid
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("rates,ranks,stats,policy,hit", [
    ([0.1, 0.2], [8, 16], STATS, "fcfs", 0.0),
    ([3.2, 0.025, 0.4, 0.4], [8, 16, 32, 32],
     {"in_mean": 811.5, "in_std": 403.25, "out_mean": 177.0,
      "out_std": 90.5}, "adapter-fair", 0.375),
    ([0.00625], [32], STATS, "slo-priority", 1.0),
])
def test_encode_features_bitwise(rates, ranks, stats, policy, hit):
    got, want = (c.encode_features(rates, ranks, stats, sched_policy=policy,
                                   prefix_hit_rate=hit)
                 for c in (core, jcore))
    assert got.shape == (len(core.FEATURE_NAMES),)
    assert core.FEATURE_NAMES == jcore.FEATURE_NAMES
    assert core.TARGET_NAMES == jcore.TARGET_NAMES
    assert np.array_equal(got, want)


def _fields(scenarios):
    return [(s.rates, s.ranks, s.dataset, s.sched_policy, s.prefix_share,
             s.prefix_len) for s in scenarios]


@pytest.mark.parametrize("kw", [
    {}, {"limit": 40, "seed": 0}, {"limit": 17, "seed": 5},
    {"datasets": ("small", "medium"), "n_rates": 2, "seed": 3},
    {"limit": 30, "sched_policies": ("fcfs", "adapter-fair", "slo-priority")},
], ids=["full", "default40", "seed5", "datasets", "policies"])
def test_scenario_grid_matches_jax(kw):
    got, want = (_fields(c.scenario_grid(**kw)) for c in (core, jcore))
    assert got == want and got
    assert core.PAPER_RATES == jcore.PAPER_RATES
    assert core.PAPER_RANKS == jcore.PAPER_RANKS


# --------------------------------------------------------------------- #
# the interpretable models
# --------------------------------------------------------------------- #

def _data(seed=0, n=240, f=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, f))
    y = np.stack([10 * x[:, 0] + np.where(x[:, 1] > 0.5, 5.0, 0.0),
                  np.round(20 * x[:, 2] * x[:, 3]),
                  3 * x[:, 4] + rng.normal(0, 0.1, n)], axis=1)
    return x, y


@pytest.mark.parametrize("name", sorted(core.MODEL_ZOO))
def test_model_zoo_predictions_match_jax(name):
    assert sorted(core.MODEL_ZOO) == sorted(jcore.MODEL_ZOO)
    x, y = _data()
    got, want = (c.MODEL_ZOO[name]().fit(x[:200], y[:200]).predict(x[200:])
                 for c in (core, jcore))
    assert got.shape == want.shape == (40, 3)
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_rules_and_importances_match_jax(seed):
    x, y = _data(seed)
    names, targets = [f"f{i}" for i in range(5)], ["a", "b", "c"]
    trees = [c.DecisionTree(max_depth=4, max_features=3, seed=seed).fit(x, y)
             for c in (core, jcore)]
    assert trees[0].rules(names, targets) == trees[1].rules(names, targets)
    _same(trees[0].feature_importances(), trees[1].feature_importances())
    forests = [c.RandomForest(n_trees=6, max_depth=4, max_features="sqrt",
                              seed=seed).fit(x, y) for c in (core, jcore)]
    _same(forests[0].feature_importances(), forests[1].feature_importances())
    _same(forests[0].predict(x), forests[1].predict(x))


# --------------------------------------------------------------------- #
# the twin-labelled dataset
# --------------------------------------------------------------------- #

def test_label_scenarios_analytic_matches_jax(analytic_labels):
    port, jax_side = analytic_labels
    assert port[0].shape == (4, len(core.FEATURE_NAMES))
    assert np.all(port[1] > 0)     # each scenario has a placement
    _labels_equal(port, jax_side)
    for rp, rj in zip(port[2], jax_side[2]):
        assert [(p.n_adapters, p.slots, p.starved) for p in rp.curve] == \
            [(p.n_adapters, p.slots, p.starved) for p in rj.curve]


def test_label_scenarios_measured_matches_jax(fitted):
    # the estimators with kernel-measured Lat_model / Lat_adapters terms
    # (``with_measured``): what the card's surface labels
    out = []
    for c, est, surface in zip((core, jcore), fitted, _surfaces()):
        out.append(c.label_scenarios(est.with_measured(surface),
                                     c.scenario_grid(limit=4, seed=1),
                                     **LABEL_MEASURED))
    assert np.all(out[0][1] > 0)
    _labels_equal(*out)


def test_label_scenarios_prefix_share_matches_jax():
    # shared-prefix scenarios (tests/test_prefix_cache.py:423): the
    # prefix-hit-rate feature and the twin's prefix cache
    out = [c.label_scenarios(_est(c, 5000.0, -30.0), _prefix_scenarios(c),
                             max_adapters=6, horizon=25.0, seed=2)
           for c in (core, jcore)]
    _labels_equal(*out)
    hit = core.FEATURE_NAMES.index("prefix_hit_rate")
    assert out[0][0][0, hit] == 0.0 and np.all(out[0][0][1:, hit] > 0)


@pytest.mark.parametrize("n_workers", [0, 2, 3])
def test_sweep_runner_labels_equal_serial_and_jax(fitted, analytic_labels,
                                                  n_workers):
    runner = core.SweepRunner(fitted[0], n_workers=n_workers)
    got = core.label_scenarios(fitted[0], core.scenario_grid(limit=4),
                               runner=runner, **LABEL)
    serial, jax_serial = analytic_labels
    assert np.array_equal(got[0], serial[0])
    assert np.array_equal(got[1], serial[1])
    _labels_equal(got, jax_serial)


def test_sweep_task_fields_and_cluster_tasks_raise(fitted):
    import dataclasses
    assert [f.name for f in dataclasses.fields(core.SweepTask)] == \
        [f.name for f in dataclasses.fields(jsweep.SweepTask)]
    pool = tuple(core.make_adapter_pool(4, [8], [0.1]))
    task = core.SweepTask(pool=pool, dataset="small", horizon=10.0, seed=0,
                          n_replicas=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        sweep.run_task(fitted[0], task)
    res = sweep.run_task(fitted[0], dataclasses.replace(task, n_replicas=0))
    want = jsweep.run_task(fitted[1], jsweep.SweepTask(
        pool=tuple(jcore.make_adapter_pool(4, [8], [0.1])), dataset="small",
        horizon=10.0, seed=0))
    assert (res.n_adapters, res.slots) == (want.n_adapters, want.slots)
    _same(res.throughput, want.throughput)


# --------------------------------------------------------------------- #
# the pipeline and the router
# --------------------------------------------------------------------- #

def test_build_pipeline_matches_jax(pipelines):
    port, jax_side = pipelines
    assert port.model_name == jax_side.model_name == "forest"
    assert sorted(port.fit_report) == sorted(jax_side.fit_report)
    assert len(port.fit_report) == len(core.TARGET_NAMES)
    _same([port.fit_report[k] for k in sorted(port.fit_report)],
          [jax_side.fit_report[k] for k in sorted(port.fit_report)])
    # estimators exist and are sane (tests/test_system.py)
    assert port.est.lat_model(8) > port.est.lat_model(1) > 0
    assert port.est.lat_adapters(8) > 1.0


@pytest.mark.parametrize("rates,ranks,policy", [
    ([0.2, 0.1], [8, 16], "fcfs"),
    ([3.2] * 32, [8, 16, 32] * 10 + [8, 16], "fcfs"),
    ([0.4, 0.05, 0.025, 1.6], [32, 8, 8, 16], "adapter-fair"),
])
def test_recommend_matches_jax(pipelines, rates, ranks, policy):
    got, want = (p.recommend(rates, ranks, STATS, sched_policy=policy)
                 for p in pipelines)
    assert (got["served_adapters"], got["adapter_slots"]) == \
        (want["served_adapters"], want["adapter_slots"])
    _same(got["throughput"], want["throughput"])
    assert got["served_adapters"] >= 1 and got["adapter_slots"] >= 1
    assert got["throughput"] > 0
    assert got["inference_ms"] < 50.0      # paper: ~0.12 ms


def _plan_fields(state):
    return ([(p.replica, [a.uid for a in p.adapters], p.slots, p.alive,
              p.straggler) for p in state.plans],
            sorted(state.assignment.items()))


def test_placement_router_matches_jax(pipelines):
    out = []
    for (c, s), pipe in zip(SIDES, pipelines):
        r = s.PlacementRouter(pipe, n_replicas=2)
        pool = c.make_adapter_pool(20, [8, 16], [0.2, 0.1])
        state = r.plan(pool, STATS)
        assert sum(len(p.adapters) for p in state.plans) == 20
        planned = _plan_fields(state)
        predicted = [p.predicted_throughput for p in state.plans]
        routes = [r.route(a.uid) for a in pool]
        slow = r.observe_itl({0: 0.02, 1: 0.09})
        failed = _plan_fields(r.report_failure(0, pool, STATS))
        out.append((planned, predicted, routes, slow, failed))
    (pp, pt, pr, ps, pf), (jp, jt, jr, js, jf) = out
    assert (pp, pr, ps, pf) == (jp, jr, js, jf)
    _same(pt, jt)


# --------------------------------------------------------------------- #
# tests/test_placement_and_forest.py:59-99 on the port's models
# --------------------------------------------------------------------- #

def test_tree_beats_linear_on_stepwise_target():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (400, 3))
    y = np.where(x[:, 0] > 0, 10.0, -10.0) + \
        np.where(x[:, 1] > 0.5, 5.0, 0.0)
    tree = core.DecisionTree(max_depth=4).fit(x[:300], y[:300])
    lin = core.LinearRegression().fit(x[:300], y[:300])
    err_t = np.mean((tree.predict(x[300:])[:, 0] - y[300:]) ** 2)
    err_l = np.mean((lin.predict(x[300:]) - y[300:]) ** 2)
    assert err_t < err_l * 0.5


def test_forest_multioutput_and_rules():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (300, 4))
    y = np.stack([x[:, 0] * 3, (x[:, 1] > 0.5).astype(float)], axis=1)
    rf = core.RandomForest(n_trees=5, max_depth=4).fit(x, y)
    pred = rf.predict(x)
    assert pred.shape == (300, 2)
    assert np.corrcoef(pred[:, 0], y[:, 0])[0, 1] > 0.8
    tree = core.DecisionTree(max_depth=3).fit(x, y)
    rules = tree.rules(feature_names=list("abcd"),
                       target_names=["t1", "t2"])
    assert rules and all("THEN" in r for r in rules)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 99, 256, 511, 640, 999, 1000])
def test_tree_predicts_constant_exactly(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (50, 2))
    y = np.full(50, 7.5)
    tree = core.DecisionTree(max_depth=3).fit(x, y)
    np.testing.assert_allclose(tree.predict(x)[:, 0], 7.5)


def test_feature_encoding_shape():
    f = core.encode_features([0.1, 0.2], [8, 16], STATS)
    assert f.shape == (len(core.FEATURE_NAMES),)

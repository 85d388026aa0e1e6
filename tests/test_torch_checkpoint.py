"""The port's checkpoints, fault-tolerant loop and train launcher against
the JAX package, on the CPU, on reduced phi4-mini with the JAX weights
carried over by ``bridge``.

* Ports of tests/test_training_and_ft.py:72-124 (retention and a bitwise
  round trip in f32 and bf16, the crash-and-resume loop, the restore onto
  an explicit device and into a freshly built model), with their numbers.
* The snapshot: an async save followed by an in-place change restores the
  values before the change; a ``.tmp`` or uncommitted step is invisible.
* The format both ways, bit for bit, bf16 leaves included: what the JAX
  manager writes the port's reads, and the reverse; the two manifests'
  keys, files, shapes and dtype names are equal.
* The loop's crash-and-resume run against the JAX ``FaultTolerantLoop``'s
  on the same weights and batches: the parameters and the AdamW moments
  after 12 steps within ``GRAD_TOL`` (test_torch_training.py:54; the
  gradients agree to it each step, so ``ADAM_TOL``, the update's on equal
  gradients, does not apply; worst seen 1.0e-6, 1.6e-6 and 1.0e-6), and
  bit for bit an uninterrupted port run; the straggler report equal to
  the JAX loop's on a scripted clock.
* ``launch.train.train`` on the CPU saves, resumes (``resumed from step
  N``) and ends where an uninterrupted run ends; without CUDA it raises
  unless it is given the CPU.
"""
import dataclasses
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.launch import fault_tolerance as jft  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training import make_train_step as jax_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, copy_into  # noqa: E402
from repro_torch.checkpoint import manager as port_manager  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import fault_tolerance as ft  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import (AdamWConfig, TrainConfig,  # noqa: E402
                                  adamw_init, init_train_state,
                                  make_train_step)
from repro_torch.training.train_lib import trainable  # noqa: E402

ARCH = "phi4-mini-3.8b"
KEY = jax.random.PRNGKey(0)
GRAD_TOL = 2e-4                      # test_torch_training.py:54
DTYPES = ("float32", "bfloat16")


def _build(dtype="float32"):
    """(JAX train model, its params, the port's model on those weights)."""
    cfg = dataclasses.replace(jax_reduced(ARCH), dtype=dtype)
    jm = JaxModel(cfg, ShardingPlan(mode="train"))
    params = jm.init(KEY)
    model = Model(dataclasses.replace(get_reduced(ARCH), dtype=dtype),
                  device="cpu")
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    return jm, params, model


def _tcfg():
    return TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5))


def _pipe(cfg):
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=8))


def _state(model, tcfg):
    return {"params": trainable(model), "opt": init_train_state(model, tcfg)}


def _leaves(tree):
    return port_manager._flatten(tree)


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def _snapshot(tree):
    return {k: v.detach().clone() for k, v in _leaves(tree).items()}


# --------------------------------------------------------------------------- #
# ports of tests/test_training_and_ft.py:72-124
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoint_roundtrip_and_retention(dtype, tmp_path):
    _, _, model = _build(dtype)
    tcfg = _tcfg()
    state = _state(model, tcfg)
    # one step first, so the moments are not zeros
    state["opt"] = make_train_step(model, tcfg)(
        state["opt"], _pipe(model.cfg).batch_at(0))[0]
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, state, {"s": s})
    assert mgr.steps() == [20, 30]           # retention
    restored = mgr.restore(state)
    _assert_trees_equal(restored, state)
    assert restored["params"]["embed.embed"].dtype == getattr(torch, dtype)
    assert mgr.metadata() == {"s": 30}


def _init_fn(state):
    """Reset ``state`` (the model's parameters, the AdamW state) in place
    to its values now, and return it."""
    saved = _snapshot(state)

    def init_fn():
        copy_into(state, saved)
        return state
    return init_fn


def _port_step(step_fn):
    def one(state, batch):
        opt, _ = step_fn(state["opt"], batch)
        return {"params": state["params"], "opt": opt}
    return one


def test_ft_loop_crash_and_resume(tmp_path):
    jm, params, model = _build()
    tcfg = _tcfg()
    pipe = _pipe(model.cfg)
    state = _state(model, tcfg)
    init_fn = _init_fn(state)
    start = _snapshot(state)
    loop = ft.FaultTolerantLoop(
        ft.FTConfig(str(tmp_path / "a"), checkpoint_every=5), state)
    got = loop.run_with_restarts(init_fn, _port_step(make_train_step(
        model, tcfg)), pipe.batch_at, n_steps=12, failure_at=8)
    assert loop.report.restarts == 1
    assert loop.report.resumed_from == 5       # restarted from step 5
    assert int(got["opt"]["step"]) == 12
    assert loop.report.steps_run == 8 + 7
    final = _snapshot(got)

    # the same 12 steps without a crash, from the same state: bit for bit
    copy_into(state, start)
    plain = ft.FaultTolerantLoop(
        ft.FTConfig(str(tmp_path / "b"), checkpoint_every=5), state)
    want = plain.run_with_restarts(init_fn, _port_step(make_train_step(
        model, tcfg)), pipe.batch_at, n_steps=12)
    assert plain.report.restarts == 0 and plain.report.resumed_from is None
    _assert_trees_equal(final, want)

    # the JAX loop's crash and resume on the same weights and batches
    jt = JaxTrainConfig(optimizer=JaxAdamWConfig(lr=3e-3, warmup_steps=5))
    jstep = jax.jit(jax_train_step(jm, jt))

    def jax_init():
        return {"params": params, "opt": jax_adamw_init(params, jt.optimizer)}

    def jax_one(state, batch):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        p, o, _ = jstep(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}
    jloop = jft.FaultTolerantLoop(
        jft.FTConfig(str(tmp_path / "jax"), checkpoint_every=5), jax_init())
    jstate = jloop.run_with_restarts(jax_init, jax_one, pipe.batch_at,
                                     n_steps=12, failure_at=8)
    assert (jloop.report.restarts, jloop.report.resumed_from,
            jloop.report.steps_run) == (1, 5, 15)
    assert int(jstate["opt"]["step"]) == 12
    for key, want_tree in (("params", jstate["params"]),
                           ("opt/m", jstate["opt"]["m"]),
                           ("opt/v", jstate["opt"]["v"])):
        tree = {n: final[f"{key}/{n}"] for n in got["params"]}
        worst, path = _worst(bridge.export_tree(model, lambda n, p: tree[n]),
                             want_tree)
        assert worst <= GRAD_TOL, (key, path, worst)


def _worst(got_tree, want_tree):
    """The largest ||got - want||_2 / ||want||_2 over the leaves."""
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    got = jax.tree.leaves(got_tree)
    assert len(got) == len(want)
    worst = (0.0, "")
    for (path, w), g in zip(want, got):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        diff = np.linalg.norm(g - w)
        rel = 0.0 if diff == 0 else diff / max(np.linalg.norm(w), 1e-30)
        worst = max(worst, (rel, jax.tree_util.keystr(path)))
    return worst


def test_elastic_restore_resharding(tmp_path):
    """Restore onto an explicit device, and into a freshly built model."""
    _, _, model = _build()
    params = trainable(model)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": params})
    restored = mgr.restore({"params": params}, device=torch.device("cpu"))
    for name, t in restored["params"].items():
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert t.data_ptr() != params[name].data_ptr()
        assert torch.equal(t, params[name])
    fresh = Model(model.cfg, device="cpu", seed=1)
    assert not torch.equal(trainable(fresh)["embed.embed"],
                           params["embed.embed"])
    copy_into({"params": trainable(fresh)}, restored)
    tokens = torch.from_numpy(_pipe(model.cfg).batch_at(0)["tokens"][:2])
    with torch.no_grad():
        assert torch.equal(fresh.train_loss({"tokens": tokens}),
                           model.train_loss({"tokens": tokens}))


# --------------------------------------------------------------------------- #
# the snapshot and the commit
# --------------------------------------------------------------------------- #

def test_async_save_keeps_the_values_before_an_in_place_change(
        tmp_path, monkeypatch):
    _, _, model = _build("bfloat16")
    params = trainable(model)
    before = _snapshot({"params": params})
    changed = threading.Event()
    real_save = port_manager.np.save

    def late_save(*args, **kw):           # the writer waits for the change
        assert changed.wait(timeout=60)
        return real_save(*args, **kw)
    monkeypatch.setattr(port_manager.np, "save", late_save)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"params": params})
    with torch.no_grad():
        for p in params.values():
            p.mul_(2).add_(1)
    changed.set()
    mgr.wait()
    restored = mgr.restore({"params": params})
    _assert_trees_equal(restored, {
        "params": {k.split("/", 1)[1]: v for k, v in before.items()}})


def test_uncommitted_steps_are_invisible(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, tree)
    mgr.save(9, {"w": tree["w"] + 1})
    os.remove(tmp_path / "step_00000009" / "_COMMITTED")
    os.rename(tmp_path / "step_00000009", tmp_path / "step_00000012.tmp")
    mgr.save(7, {"w": tree["w"] + 2})
    os.remove(tmp_path / "step_00000007" / "_COMMITTED")
    assert mgr.steps() == [5]
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(tree)["w"], tree["w"])


# --------------------------------------------------------------------------- #
# the format, both ways
# --------------------------------------------------------------------------- #

def _jax_state(jm, params):
    """A JAX bf16 train state with moments that are not zeros."""
    jt = JaxTrainConfig(optimizer=JaxAdamWConfig(lr=3e-3, warmup_steps=5))
    opt = jax_adamw_init(params, jt.optimizer)
    batch = {k: jnp.asarray(v) for k, v in _pipe(jm.cfg).batch_at(0).items()}
    p, o, _ = jax.jit(jax_train_step(jm, jt))(params, opt, batch)
    return {"params": p, "opt": o}


def _np_equal(got, want):
    got = jax.tree.map(np.asarray, got)
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jm, params, model = _build("bfloat16")
    jstate = _jax_state(jm, params)
    JaxManager(str(tmp_path), async_save=False).save(4, jstate)
    restored = CheckpointManager(str(tmp_path)).restore(jstate)
    assert restored["params"]["embed"]["embed"].dtype == torch.bfloat16
    _np_equal(bridge.to_numpy(restored), jstate)
    # into the port's model and AdamW state, by parameter name
    opt = adamw_init(trainable(model), AdamWConfig())
    copy_into({"params": trainable(model), "opt": opt}, {
        "params": bridge.import_tree(restored["params"]),
        "opt": {"step": restored["opt"]["step"],
                "m": bridge.import_tree(restored["opt"]["m"]),
                "v": bridge.import_tree(restored["opt"]["v"])}})
    assert int(opt["step"]) == 1
    _np_equal(bridge.export_params(model), jstate["params"])
    _np_equal(bridge.export_tree(model, lambda n, p: opt["m"][n]),
              jstate["opt"]["m"])


def test_port_checkpoint_restores_into_jax(tmp_path):
    jm, params, model = _build("bfloat16")
    jstate = _jax_state(jm, params)
    tree = bridge.to_torch(jax.tree.map(np.asarray, jstate))
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        4, tree, {"from": "port"})
    jmgr = JaxManager(str(tmp_path / "port"))
    _np_equal(jmgr.restore(jstate), jstate)
    assert jmgr.metadata() == {"from": "port"}
    # the same tree written by the JAX manager: the same manifest and files
    JaxManager(str(tmp_path / "jax"), async_save=False).save(
        4, jstate, {"from": "port"})
    dirs = [tmp_path / side / "step_00000004" for side in ("port", "jax")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    for name in os.listdir(dirs[0]):
        if name.endswith(".npy"):
            a, b = (np.load(d / name) for d in dirs)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


# --------------------------------------------------------------------------- #
# the straggler watchdog
# --------------------------------------------------------------------------- #

def _scripted_clock(durations):
    """perf_counter: step i starts at 64 i and lasts durations[i] (binary
    fractions, so each difference is exact)."""
    ticks = iter([t for i, d in enumerate(durations)
                  for t in (64.0 * i, 64.0 * i + d)])
    return types.SimpleNamespace(perf_counter=lambda: next(ticks))


def test_stragglers_match_jax(tmp_path, monkeypatch):
    durations = [1.0] * 6 + [3.5, 1.0, 2.75, 1.0, 9.0, 1.0, 1.0, 3.125, 1.0]
    n = len(durations)
    monkeypatch.setattr(ft, "time", _scripted_clock(durations))
    loop = ft.FaultTolerantLoop(ft.FTConfig(str(tmp_path / "port"),
                                            checkpoint_every=100),
                                {"w": torch.zeros(2)})
    loop.run({"w": torch.zeros(2)}, lambda s, b: s, lambda i: None, n)
    monkeypatch.setattr(jft, "time", _scripted_clock(durations))
    jloop = jft.FaultTolerantLoop(jft.FTConfig(str(tmp_path / "jax"),
                                               checkpoint_every=100),
                                  {"w": jnp.zeros(2)})
    jloop.run({"w": jnp.zeros(2)}, lambda s, b: s, lambda i: None, n)
    assert loop.report.stragglers == jloop.report.stragglers == [6, 10, 13]
    assert loop.report.step_times == jloop.report.step_times == durations


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #

def _args(directory, steps):
    return launch_train.build_parser().parse_args([
        "--reduced", "--steps", str(steps), "--batch", "2", "--seq", "16",
        "--checkpoint-every", "2", "--checkpoint-dir", str(directory)])


def test_train_launcher_saves_and_resumes(tmp_path, capsys):
    cfg = get_reduced(ARCH)
    launch_train.train(cfg, _args(tmp_path / "run", 4), device="cpu")
    out = capsys.readouterr().out
    assert "resumed" not in out and "done: 4 steps" in out
    assert CheckpointManager(str(tmp_path / "run")).steps() == [2, 4]
    state = launch_train.train(cfg, _args(tmp_path / "run", 6),
                               device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 6 steps" in out
    assert int(state["opt"]["step"]) == 6
    # the resumed run ends where one run of 6 steps ends
    want = launch_train.train(cfg, _args(tmp_path / "once", 6),
                              device="cpu")
    _assert_trees_equal(state, want)


def test_train_launcher_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(get_reduced(ARCH), _args(tmp_path, 2))
    assert not os.path.exists(tmp_path / "step_00000002")

"""The port's training under a train plan against the JAX package's, on
gloo ranks (ROADMAP.md item 11c).

(1) Each collective's adjoint in each use it has in the model
(``all_gather`` whose whole the ranks consume alike, and one each rank
consumes its own way; the aux loss every rank computes alike beside it,
``scale_grad``; ``reduce_scatter``; ``shift`` once and twice;
``gather_whole`` over two axes, over a flattened pair and over ``data``
alone; width-TP's ``copy`` in and all-reduce out; ``WidthShards.piece``
and ``relayout`` both ways) on the 4 ranks of a (2, 2) mesh in f64, each
rank's gradients to single-process autograd of the unsharded function at
rel 1e-6 (max |d| / max |g|); an all-reduce max refuses a gradient.
(2) ``ring_attention`` and ``local_attention`` (window 16 over slices of
8) on 4 sequence ranks: the gradients of each rank's q, k and v slices to
the unsharded attention's at rel 2e-5.
(3)-(5) The reduced configs in f32 on PRNGKey(2) weights through
``bridge.py``, tokens (4, 33), the (2, 4) mesh (``case_train`` and
``case_grad``, tests/sharded_cases.py:44-86): the JAX side is one
subprocess on 8 host devices (``tests/sharded_body_jax.py``, kind
``train``) that computes every planned loss, gradient and step, the
port's one spawn of 8 ranks (``tests/torch_dist_ranks.py::case_train``);
both run once a session, shared by the xdist workers through a file lock.
(3) The planned loss of gemma3-1b, olmoe-1b-7b, mamba2-2.7b,
recurrentgemma-9b and phi4-mini within rel 1e-5 of JAX's planned loss,
and within JAX's own 5e-4 (5e-3 for MoE) of JAX's unplanned loss.
(4) phi4-mini's and mamba2's gradients, each leaf gathered whole, against
JAX's planned ``jax.grad``: the worst leaf's max |d| / max |g| below 5e-3
(JAX's own limit) and ||d||_2 / ||g||_2 at most 2e-4.  (5) One
``TrainStep``, and one with 2 microbatches: phi4-mini's gradient norm
equal to the port's unplanned step's (rel 1e-5) and every rank's updated
pieces within rel 2e-4 of the same pieces of that step; olmoe's loss,
norm and parameters after the step against JAX's planned step (its aux
loss is estimated per data shard).  (6) Every architecture builds under
the (2, 4) train plan and its planned loss (internvl2 with 12 image
embeddings across the first sequence slice's end) equals the port's loss
without a plan; int8 experts still refuse ``train_loss``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from filelock import FileLock  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from tests import torch_dist_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 240.0   # seconds a spawn's ranks may take
BODY = Path(__file__).resolve().parent / "sharded_body_jax.py"
LOSS_ARCHS = ("gemma3_1b", "olmoe_1b_7b", "mamba2_2p7b", "recurrentgemma_9b",
              "phi4_mini_3p8b")
GRAD_ARCHS = ("phi4_mini_3p8b", "mamba2_2p7b")
STEPS = (("phi4_mini_3p8b", 1, "port"), ("phi4_mini_3p8b", 2, "port"),
         ("olmoe_1b_7b", 1, "jax"), ("olmoe_1b_7b", 2, "jax"))
ADJOINTS = ("all_gather-slice", "all_gather-sum", "scale_grad-aux",
            "reduce_scatter", "shift", "copy-all_reduce", "piece-relayout",
            "gather_whole-('data', 'model')-None",
            "gather_whole-(('data', 'model'), None)-None",
            "gather_whole-('data', 'model')-('data',)")


def _shared(tmp_path_factory, name, make):
    """``make(directory)``, once a session: under xdist the first worker
    to ask computes it under a file lock in the session's temporary root
    and the others read its pickle."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return make(tmp_path_factory.mktemp(name))
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        out = make(tmp_path_factory.mktemp(name))
        path.write_bytes(pickle.dumps(out))
        return out


def _jax_train(workdir):
    inp = {"kind": "train", "mesh": (2, 4), "archs": list(LOSS_ARCHS),
           "grads": list(GRAD_ARCHS),
           "steps": [(a, mb) for a, mb, vs in STEPS if vs == "jax"]}
    src, dst = workdir / "train_in.pkl", workdir / "train_out.pkl"
    src.write_bytes(pickle.dumps(inp))
    proc = subprocess.run(
        [sys.executable, str(BODY), str(src), str(dst)], capture_output=True,
        text=True, timeout=2 * SPAWN_TIMEOUT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return pickle.loads(dst.read_bytes())


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    return _shared(tmp_path_factory, "train_plan_jax", _jax_train)


@pytest.fixture(scope="module")
def port_train(tmp_path_factory, jax_train):
    def make(workdir):
        inp = {"archs": list(LOSS_ARCHS), "grads": list(GRAD_ARCHS),
               "steps": list(STEPS),
               "jax": {a: {"params": jax_train[a]["params"],
                           "tokens": jax_train[a]["tokens"]}
                       for a in LOSS_ARCHS}}
        return ranks.spawn("train", 8, inp, workdir, SPAWN_TIMEOUT)
    return _shared(tmp_path_factory, "train_plan_port", make)


@pytest.fixture(scope="module")
def adjoints(tmp_path_factory):
    def make(workdir):
        rng = np.random.default_rng(31)

        def normal(*shape, dtype=np.float64):
            return rng.standard_normal(shape).astype(dtype)
        f32 = np.float32
        inp = {"x": normal(8, 6), "w": normal(8, 6), "c": normal(4, 8, 6),
               "w1": normal(6, 8), "w2": normal(8, 6),
               "q": normal(2, 32, 4, 16, dtype=f32),
               "k": normal(2, 32, 2, 16, dtype=f32),
               "v": normal(2, 32, 2, 16, dtype=f32),
               "dout": normal(2, 32, 4, 16, dtype=f32)}
        return ranks.spawn("adjoints", 4, inp, workdir, SPAWN_TIMEOUT)
    return _shared(tmp_path_factory, "train_plan_adjoints", make)


def _rel(got, want):
    """||got - want||_2 / ||want||_2 in f64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _max_rel(got, want):
    """max |got - want| / max |want| (+ 1e-6), the measure of
    ``case_grad``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def _rank0(outs):
    return next(o for o in outs if o["rank"] == 0)


# --------------------------------------------------------------------------- #
# (1), (2) the adjoints
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ADJOINTS)
def test_collective_adjoint_matches_autograd(adjoints, case):
    for r in adjoints:
        assert r[case] <= 1e-6, (case, r[case])


def test_all_reduce_max_refuses_a_gradient(adjoints):
    assert all(r["max_raises"] for r in adjoints)


@pytest.mark.parametrize("window,shifts", [(0, 6), (16, 4)],
                         ids=["ring", "local-16"])
def test_sequence_attention_gradients_match_unsharded(adjoints, window,
                                                      shifts):
    # ring: 3 shifts forward, 3 reverse shifts back; local (window 16 over
    # slices of 8): 2 and 2
    for r in adjoints:
        assert r[f"attention-{window}"] <= 2e-5
        assert r[f"attention-{window}-collectives"]["shift"] == shifts


# --------------------------------------------------------------------------- #
# (3) the loss, (4) the gradients
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_planned_loss_matches_jax(jax_train, port_train, arch):
    want = jax_train[arch]
    tol = 5e-3 if arch == "olmoe_1b_7b" else 5e-4
    assert abs(want["loss"] - want["loss_unplanned"]) < tol
    for r in port_train:
        got = r[arch]["loss"]
        assert abs(got - want["loss"]) <= 1e-5 * abs(want["loss"]), \
            (got, want["loss"])
        assert abs(got - want["loss_unplanned"]) < tol
        c = r[arch]["forward"]
        if arch in ("mamba2_2p7b", "recurrentgemma_9b"):   # width-TP
            assert c["shift"] == 0 and c["all_reduce"] > 1
        else:   # the ring, and the FSDP weights gathered whole
            assert c["shift"] > 0 and c["weight_gather"] > 0
        # each gathered weight's reduce-scatter in backward
        assert r[arch]["backward"]["reduce_scatter"] >= c["weight_gather"]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_planned_grads_match_jax(jax_train, port_train, arch):
    want = bridge.named_leaves(jax_train[arch]["grads"])
    got = _rank0(port_train)[arch]["grads"]
    assert set(got) == set(want)
    worst = max((_max_rel(g, want[n]), n) for n, g in got.items())
    assert worst[0] < 5e-3, worst
    worst = max((_rel(g, want[n]), n) for n, g in got.items())
    assert worst[0] <= 2e-4, worst


# --------------------------------------------------------------------------- #
# (5) the step
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("microbatches", [1, 2])
def test_planned_step_updates_pieces_as_the_unplanned_step(port_train,
                                                           microbatches):
    for r in port_train:
        o = r["steps"][("phi4_mini_3p8b", microbatches)]
        whole = o["whole"]
        assert abs(o["grad_norm"] - whole["grad_norm"]) <= \
            1e-5 * whole["grad_norm"]
        assert abs(o["loss"] - whole["loss"]) <= 1e-5 * abs(whole["loss"])
        assert o["worst"] <= 2e-4


@pytest.mark.parametrize("microbatches", [1, 2])
def test_planned_moe_step_matches_jax(jax_train, port_train, microbatches):
    want = jax_train["steps"][("olmoe_1b_7b", microbatches)]
    for r in port_train:
        o = r["steps"][("olmoe_1b_7b", microbatches)]
        for key in ("loss", "grad_norm"):
            assert abs(o[key] - want[key]) <= 1e-5 * abs(want[key]), key
    params = bridge.named_leaves(want["params"])
    got = _rank0(port_train)["steps"][("olmoe_1b_7b", microbatches)]["params"]
    worst = max((_rel(p, params[n]), n) for n, p in got.items())
    assert worst[0] <= 2e-4, worst


# --------------------------------------------------------------------------- #
# (6) every architecture
# --------------------------------------------------------------------------- #

def test_every_architecture_trains_under_a_train_plan(tmp_path):
    outs = ranks.spawn("build", 8, {"archs": list(ARCH_IDS),
                                    "kind": "train"}, tmp_path,
                       SPAWN_TIMEOUT)
    for r in outs:
        assert set(r) == set(ARCH_IDS)
        for arch, (width, cache, got, want, int8_refused) in r.items():
            state = arch.startswith(("mamba2", "recurrentgemma"))
            assert (width, cache) == ((4 if state else 1), 1)
            assert np.isfinite(got)
            moe = arch.startswith(("olmoe", "moonshot"))
            # an MoE's aux loss is estimated per data shard, as in JAX
            assert abs(got - want) <= (5e-3 if moe else 1e-5 * abs(want)), \
                (arch, got, want)
            assert int8_refused is (True if moe else None)


# --------------------------------------------------------------------------- #
# (7) plan.remat: each layer recomputed in backward exactly when it is set
# --------------------------------------------------------------------------- #

REMAT_ARCHS = ("phi4_mini_3p8b", "mamba2_2p7b")


@pytest.fixture(scope="module")
def remat_ranks(tmp_path_factory):
    def make(workdir):
        tokens = np.random.default_rng(7).integers(0, 512, (4, 33))
        return ranks.spawn("remat", 4, {"archs": list(REMAT_ARCHS),
                                        "tokens": tokens}, workdir,
                           SPAWN_TIMEOUT)
    return _shared(tmp_path_factory, "train_plan_remat", make)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_on_ranks_bitwise_equal_without(remat_ranks, arch):
    for r in remat_ranks:
        off, on = r[arch][False], r[arch][True]
        assert np.array_equal(off["loss"], on["loss"])
        assert set(off["grads"]) == set(on["grads"])
        for name, g in on["grads"].items():
            assert np.array_equal(g, off["grads"][name]), name


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_on_ranks_gathers_layer_weights_again(remat_ranks, arch):
    n_layers = 2     # the reduced configs'
    for r in remat_ranks:
        off, on = r[arch][False], r[arch][True]
        # the checkpointed layers, and only with remat
        assert (off["checkpoints"], on["checkpoints"]) == (0, n_layers)
        assert off["forward"] == on["forward"]
        # the forward's gathers: the layers' and those of the embedding
        # and unembedding, outside the layers
        outside = off["outside_gathers"]
        assert on["outside_gathers"] == outside > 0
        layer_gathers = off["forward"]["weight_gather"] - outside
        assert layer_gathers > 0
        # without remat each weight is gathered once, in the forward;
        # with it every layer's weights exactly once again, in the
        # recompute, and those outside the layers not again
        assert off["backward"]["weight_gather"] == 0
        assert on["backward"]["weight_gather"] == layer_gathers


@pytest.mark.parametrize("remat", [False, True])
def test_remat_unplanned_uses_checkpoint_and_changes_nothing(remat,
                                                             monkeypatch):
    """Unplanned, ``remat`` against its opposite: checkpoint called once
    a layer exactly when set, the loss and gradients bitwise alike."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import Model, transformer
    from repro_torch.models.sharding import make_plan
    from repro_torch.training import init_train_state
    cfg = dataclasses.replace(get_reduced("gemma3_1b"), dtype="float32")
    tokens = torch.from_numpy(
        np.random.default_rng(8).integers(0, 512, (2, 33)))
    got = {}
    for flag in (remat, not remat):
        calls = []

        def counted(*args, _inner=transformer.checkpoint, **kwargs):
            calls.append(1)
            return _inner(*args, **kwargs)
        monkeypatch.setattr(transformer, "checkpoint", counted)
        model = Model(cfg, device="cpu", seed=0,
                      plan=make_plan(cfg, None, "train", remat=flag))
        assert model.plan is None and model.remat is flag
        init_train_state(model)
        loss = model.train_loss({"tokens": tokens})
        loss.backward()
        monkeypatch.undo()
        got[flag] = (loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()}, len(calls))
    for flag, (_, _, n_calls) in got.items():
        assert n_calls == (cfg.n_layers if flag else 0), flag
    loss, grads, _ = got[remat]
    other_loss, other_grads, _ = got[not remat]
    assert torch.equal(loss, other_loss)
    assert set(grads) == set(other_grads)
    for name, g in grads.items():
        assert torch.equal(g, other_grads[name]), name

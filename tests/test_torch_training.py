"""The port's training step against the JAX package, on the CPU, on bridged
weights and identical numpy batches.

* ``Model.train_loss`` and its gradients against ``jax.value_and_grad`` of
  the JAX ``train_loss`` (``ShardingPlan(mode="train")``), for each of the
  ten architectures the port builds, reduced, f32, on a ``TokenPipeline``
  batch (internvl2 with its image embeddings): the loss within a relative
  error of 1e-5, each gradient leaf within ||port - jax||_2 / ||jax||_2 <=
  2e-4 (test_consistency.py:39's tolerance).  Worst seen: loss 1.5e-7
  (musicgen), a leaf 2.9e-6 (gemma3's wq).  The same with the loss taken
  over several chunks (``max_logit_bytes`` made small on both sides; tied
  and untied embeddings, a logit softcap), and olmoe's aux loss alone.
* AdamW on the same gradients (the JAX ones) against ``adamw_update`` over
  three steps: bf16 and f32 parameters, ``grad_clip`` on and off,
  ``warmup_steps`` 0 and 5, ``master_weights``: parameters, m and v within
  1e-6 (the same norm as above), lr and the gradient norm too.
* ``make_train_step`` with 1 and 2 microbatches against the JAX step: the
  loss, gradient norm and lr, the (f32 mean of the) gradients AdamW got,
  and the parameters after the step.
* Ports of three JAX tests (tests/test_training_and_ft.py:35-69), the
  copied data pipeline bit for bit the JAX one, the serving entry points
  unchanged once the parameters require gradients, and ``train_loss``
  refusing int8 experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training import adamw_update as jax_adamw_update  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import Model, layers  # noqa: E402
from repro_torch.training import (AdamWConfig, TrainConfig,  # noqa: E402
                                  adamw_init, adamw_update, global_norm,
                                  init_train_state, make_train_step)
from repro_torch.training.train_lib import trainable  # noqa: E402

KEY = jax.random.PRNGKey(1)
LOSS_TOL, GRAD_TOL, ADAM_TOL = 1e-5, 2e-4, 1e-6


def _build(arch, dtype="float32", **change):
    """(JAX train model, its params, the port's model on the same
    weights) of reduced ``arch``."""
    cfg = dataclasses.replace(jax_reduced(arch), dtype=dtype, **change)
    jm = JaxModel(cfg, ShardingPlan(mode="train"))
    params = jm.init(KEY)
    model = Model(dataclasses.replace(get_reduced(arch), dtype=dtype,
                                      **change), device="cpu")
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    return jm, params, model


def _batch(cfg, seq_len=32, global_batch=2, step=0):
    """A numpy ``TokenPipeline`` batch, with image embeddings for a VLM."""
    return TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, n_image_tokens=cfg.n_image_tokens,
        d_model=cfg.d_model if cfg.n_image_tokens else 0)).batch_at(step)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(got, want):
    """||got - want||_2 / ||want||_2 in f64 (0 when both are 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(got - want)
    return 0.0 if diff == 0 else diff / max(np.linalg.norm(want), 1e-30)


def _worst(got_tree, want_tree):
    """(largest leaf ``_rel``, its path) over two trees of one structure."""
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    got = jax.tree.leaves(got_tree)
    assert len(got) == len(want)
    worst = (0.0, "")
    for (path, w), g in zip(want, got):
        assert np.shape(g) == np.shape(w), jax.tree_util.keystr(path)
        worst = max(worst, (_rel(g, w), jax.tree_util.keystr(path)))
    return worst


def _grads(model):
    """The port's gradients in the JAX params' layout."""
    return bridge.export_tree(
        model, lambda name, p: p.grad if p.grad is not None
        else torch.zeros_like(p))


def _loss_and_grads(jm, params, model, batch):
    want, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(
        params, _jnp(batch))
    init_train_state(model)
    loss = model.train_loss(batch)
    loss.backward()
    return float(loss.detach()), float(want), _grads(model), jgrads


# --------------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    jm, params, model = _build(arch)
    got, want, grads, jgrads = _loss_and_grads(
        jm, params, model, _batch(jm.cfg))
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    worst, path = _worst(grads, jgrads)
    assert worst <= GRAD_TOL, (path, worst)


class _SmallLogitsJaxModel(JaxModel):
    """The JAX model with ``_chunked_ce``'s budget made small."""
    max_logit_bytes = 2 ** 28

    def _chunked_ce(self, params, x, labels, max_logit_bytes=2 ** 28):
        return super()._chunked_ce(params, x, labels,
                                   max_logit_bytes=self.max_logit_bytes)


@pytest.mark.parametrize("arch,change", [
    ("phi4-mini-3.8b", {}),                         # untied unembedding
    ("gemma3-1b", {"logit_softcap": 30.0}),         # tied, softcapped
])
def test_chunked_loss_over_several_chunks_matches_jax(arch, change):
    # B 2, T 32, V_pad 512: a budget of 2 * 8 * 512 * 4 bytes gives chunks
    # of 8 positions, 4 of them, on both sides
    budget = 2 * 8 * 512 * 4
    jm0, params, model = _build(arch, **change)
    jm = _SmallLogitsJaxModel(jm0.cfg, jm0.plan)
    jm.max_logit_bytes = budget
    batch = _batch(jm.cfg)
    want, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(
        params, _jnp(batch))
    init_train_state(model)
    calls = []
    ce, chunked = model._ce, model._chunked_ce
    model._ce = lambda x, labels: calls.append(x.shape) or ce(x, labels)
    model._chunked_ce = lambda x, labels: chunked(x, labels, budget)
    loss = model.train_loss(batch)
    assert calls == [(2, 8, jm.cfg.d_model)] * 4
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= LOSS_TOL * abs(float(want))
    # one chunk gives the same loss to f32 rounding
    model._chunked_ce = chunked
    with torch.no_grad():
        whole = model.train_loss(batch)
    assert abs(float(whole) - loss) <= LOSS_TOL * abs(loss)
    worst, path = _worst(_grads(model), jgrads)
    assert worst <= GRAD_TOL, (path, worst)


def test_moe_aux_loss_matches_jax():
    # olmoe: the aux loss summed over the layers, and the loss less the
    # chunked cross entropy, 0.01 * aux / n_layers, on both sides
    jm, params, model = _build("olmoe-1b-7b")
    batch = _batch(jm.cfg)
    tokens = jnp.asarray(batch["tokens"])
    x = jm._embed_in(params, tokens[:, :-1])
    x, _, jaux = jm._run_segments(params, None, None, x, None)
    x = jlayers.apply_norm(jm.cfg.norm, params["final_norm"], x)
    jterm = float(jm.train_loss(params, _jnp(batch))) - float(
        jm._chunked_ce(params, x, tokens[:, 1:]))
    t = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        x, aux = model.train_trunk(t[:, :-1])
        term = float(model.train_loss(batch)) - float(
            model._chunked_ce(x, t[:, 1:]))
    assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) <= LOSS_TOL * float(jaux)
    want = 0.01 * float(aux) / jm.cfg.n_layers
    # the differences of two losses near 7: within a few of their ulps
    assert abs(term - want) <= 2e-6 and abs(jterm - want) <= 2e-6
    assert TrainConfig().aux_weight == JaxTrainConfig().aux_weight == 0.01


@pytest.mark.parametrize("masked", [None, "some", "none"])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random((3, 5)) < 0.5) if masked == "some" \
            else np.zeros((3, 5), bool)
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1)


def test_train_loss_refuses_int8_experts():
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32")
    model = Model(cfg, device="cpu", expert_quant=True)
    with pytest.raises(ValueError, match="int8"):
        model.train_loss(_batch(cfg))
    # the int8 leaves are left out of the trainable parameters
    assert all(p.is_floating_point() for p in trainable(model).values())


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #

ADAM_CASES = [
    pytest.param(dt, clip, warm, False, id=f"{dt}-clip{clip}-warmup{warm}")
    for dt in ("float32", "bfloat16") for clip in (1.0, 0.0)
    for warm in (0, 5)] + [
    pytest.param(dt, 1.0, 5, True, id=f"{dt}-master")
    for dt in ("float32", "bfloat16")]


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX gradients of reduced phi4-mini's loss (f32), and its
    params."""
    jm, params, _ = _build("phi4-mini-3.8b")
    _, grads = jax.jit(jax.value_and_grad(jm.train_loss))(
        params, _jnp(_batch(jm.cfg)))
    return grads


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_bf16_rounds_within(got, want_f32, lr):
    """Each bf16 parameter a rounding of a value within ADAM_TOL of the JAX
    update's f32 result (``want_f32``, before the cast), relative to the
    update's terms (the value and the step ``lr``): within half a bf16
    ulp of it plus that.  Where the JAX result sits at a rounding midpoint
    the two sides may round apart, by more than one ulp of a result that
    cancels to near 0."""
    for g, wf in zip(jax.tree.leaves(_f32(got)),
                     jax.tree.leaves(_f32(want_f32))):
        g, wf = g.astype(np.float64), wf.astype(np.float64)
        top = np.maximum(np.abs(g), np.abs(wf))
        half_ulp = np.exp2(np.floor(np.log2(np.maximum(top, 1e-38))) - 8)
        assert (np.abs(g - wf) <= half_ulp + ADAM_TOL * (np.abs(wf) + lr)
                ).all()


@pytest.mark.parametrize("dtype,clip,warmup,master", ADAM_CASES)
def test_adamw_matches_jax(jax_grads, dtype, clip, warmup, master):
    # three steps on the same gradients scaled by 1, 10 and 0.1: the
    # global norm below, above and around grad_clip.  After each step the
    # parameters, m and v (and the masters) are held to ADAM_TOL; the
    # global norm sums in another order on each side, so with clipping a
    # bf16 parameter may round the other way where its f32 value sits at a
    # rounding midpoint (``_assert_bf16_rounds_within``), and the port's
    # parameters are set to the JAX ones before the next step
    jcfg = JaxAdamWConfig(lr=1e-2, grad_clip=clip, warmup_steps=warmup,
                          master_weights=master)
    cfg = AdamWConfig(lr=1e-2, grad_clip=clip, warmup_steps=warmup,
                      master_weights=master)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _, params, model = _build("phi4-mini-3.8b", dtype=dtype)
    jstate = jax_adamw_init(params, jcfg)
    tparams = trainable(model)
    state = adamw_init(tparams, cfg)
    for scale in (1.0, 10.0, 0.1):
        jg = jax.tree.map(lambda g: (g * scale).astype(dtype), jax_grads)
        grads = bridge.import_tree(jax.tree.map(np.asarray, jg))
        assert grads.keys() == tparams.keys()
        # the JAX update on f32 copies of the parameters: its f32 result
        # before the cast (the masters, with master_weights)
        shadow, _, _ = jax_adamw_update(
            jax.tree.map(lambda a: a.astype(jnp.float32), params), jg,
            jstate, jcfg)
        params, jstate, jinfo = jax_adamw_update(params, jg, jstate, jcfg)
        _, state, info = adamw_update(tparams, grads, state, cfg)
        assert float(info["lr"]) == float(jinfo["lr"])
        assert abs(float(info["grad_norm"]) - float(jinfo["grad_norm"])) \
            <= ADAM_TOL * float(jinfo["grad_norm"])
        assert int(state["step"]) == int(jstate["step"])
        moments = [(bridge.export_tree(model, lambda n, p: state[k][n]),
                    jstate[k]) for k in ("m", "v", "master") if k in state]
        for got, want in moments:
            worst, path = _worst(got, want)
            assert worst <= ADAM_TOL, (path, worst)
        got = bridge.export_params(model)
        if dtype == "float32":
            worst, path = _worst(got, params)
            assert worst <= ADAM_TOL, (path, worst)
        else:
            _assert_bf16_rounds_within(got, shadow, float(jinfo["lr"]))
            # most of them equal
            same = sum(int((a == b).sum()) for a, b in zip(
                jax.tree.leaves(_f32(got)), jax.tree.leaves(_f32(params))))
            assert same >= 0.999 * sum(a.size for a in jax.tree.leaves(got))
        bridge.load_params(model, jax.tree.map(np.asarray, params))
    assert int(state["step"]) == 3


def test_global_norm_matches_jax(jax_grads):
    from repro.training.optimizer import global_norm as jax_global_norm
    grads = bridge.import_tree(jax.tree.map(np.asarray, jax_grads))
    want = float(jax_global_norm(jax_grads))
    assert abs(float(global_norm(grads.values())) - want) <= ADAM_TOL * want


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,microbatches", [
    ("phi4-mini-3.8b", 1), ("phi4-mini-3.8b", 2), ("olmoe-1b-7b", 2),
    ("internvl2-2b", 2)])
def test_train_step_matches_jax(arch, microbatches):
    # one step on a batch of 4: loss, gradient norm and lr, the gradients
    # AdamW got (with 2 microbatches the f32 mean of the two halves'), and
    # the parameters after the step
    jm, params, model = _build(arch)
    jt = JaxTrainConfig(optimizer=JaxAdamWConfig(lr=1e-3, warmup_steps=2),
                        microbatches=microbatches)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2),
                       microbatches=microbatches)
    batch = _batch(jm.cfg, global_batch=4)
    jbatch = _jnp(batch)
    new_params, _, jinfo = jax.jit(jax_make_train_step(jm, jt))(
        params, jax_adamw_init(params, jt.optimizer), jbatch)
    # the gradients the JAX step hands AdamW (train_lib.py:34-49)
    vg = jax.jit(jax.value_and_grad(jm.train_loss))
    parts = [vg(params, jax.tree.map(lambda x, i=i: x.reshape(
        microbatches, -1, *x.shape[1:])[i], jbatch))[1]
        for i in range(microbatches)]
    jgrads = (parts[0] if microbatches == 1 else jax.tree.map(
        lambda *g: sum(x.astype(jnp.float32) for x in g) / microbatches,
        *parts))

    step = make_train_step(model, tcfg)
    opt = init_train_state(model, tcfg)
    opt, info = step(opt, batch)
    for key in ("loss", "grad_norm", "lr"):
        got, want = float(info[key]), float(jinfo[key])
        assert abs(got - want) <= LOSS_TOL * abs(want), (key, got, want)
    assert all(g.dtype == (torch.float32 if microbatches > 1 else p.dtype)
               for g, p in zip(step.grads.values(), trainable(model).values()))
    worst, path = _worst(bridge.export_tree(
        model, lambda n, p: step.grads[n]), jgrads)
    assert worst <= GRAD_TOL, (path, worst)
    worst, path = _worst(bridge.export_params(model), new_params)
    assert worst <= GRAD_TOL, (path, worst)
    assert int(opt["step"]) == 1


def test_loss_decreases():
    # tests/test_training_and_ft.py:35-44 on the port: reduced phi4-mini in
    # its own dtype, 25 steps
    cfg = get_reduced("phi4-mini-3.8b")
    model = Model(cfg, device="cpu", seed=0)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=8))
    opt = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    losses = []
    for i in range(25):
        opt, info = step(opt, pipe.batch_at(i))
        losses.append(float(info["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_adamw_weight_decay_shrinks_params():
    # tests/test_training_and_ft.py:47-54 on the port
    p = {"w": torch.ones((4, 4))}
    g = {"w": torch.zeros((4, 4))}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                      grad_clip=0.0)
    st_ = adamw_init(p, cfg)
    p2, _, _ = adamw_update(p, g, st_, cfg)
    assert float(p2["w"][0, 0]) < 1.0


def test_data_pipeline_seekable_and_sharded():
    # tests/test_training_and_ft.py:57-69 on the port's copy
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8)
    p = TokenPipeline(cfg)
    a = p.batch_at(5)["tokens"]
    b = p.batch_at(5)["tokens"]
    np.testing.assert_array_equal(a, b)          # deterministic
    c = p.batch_at(6)["tokens"]
    assert not np.array_equal(a, c)
    s0 = TokenPipeline(cfg, shard=(0, 2)).batch_at(3)["tokens"]
    s1 = TokenPipeline(cfg, shard=(1, 2)).batch_at(3)["tokens"]
    assert s0.shape == (4, 17)
    assert not np.array_equal(s0, s1)            # different shard data
    assert (a < 128).all() and (a >= 0).all()


@pytest.mark.parametrize("seed,shards,images", [
    (0, 1, 0), (3, 2, 0), (7, 4, 0), (1, 2, 5)])
def test_pipeline_copy_equals_jax_bitwise(seed, shards, images):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed,
              n_image_tokens=images, d_model=16 if images else 0)
    assert dataclasses.asdict(DataConfig(**kw)) == \
        dataclasses.asdict(JaxDataConfig(**kw))
    for shard in range(shards):
        port = TokenPipeline(DataConfig(**kw), shard=(shard, shards))
        ref = JaxTokenPipeline(JaxDataConfig(**kw), shard=(shard, shards))
        for step in (0, 1, 17):
            got, want = port.batch_at(step), ref.batch_at(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()
        for got, want, _ in zip(port, ref, range(3)):
            assert got["tokens"].tobytes() == want["tokens"].tobytes()


# --------------------------------------------------------------------------- #
# serving once the parameters require gradients
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "recurrentgemma-9b"])
def test_serving_unchanged_after_init_train_state(arch):
    cfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    jp = JaxModel(cfg, ShardingPlan(mode="prefill"))
    jd = JaxModel(cfg, ShardingPlan(mode="decode"))
    params, lora = jp.init(KEY), jp.init_lora(KEY, 4, 4)
    model = Model(dataclasses.replace(get_reduced(arch), dtype="float32"),
                  device="cpu")
    bridge.load_params(model, jax.tree.map(np.asarray, params))
    tlora = bridge.lora_to_torch(jax.tree.map(np.asarray, lora))
    init_train_state(model)
    assert all(p.requires_grad for p in trainable(model).values())
    # a prompt of 20, past recurrentgemma's window of 16 (a shorter one
    # meets the JAX rolling cache's eviction, ROADMAP.md queue 3)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32)
    ids = np.asarray([1, 2], np.int32)
    want, jcache = jp.prefill(params, lora, jnp.asarray(tokens[:, :-1]),
                              jnp.asarray(ids))
    got, cache = model.prefill(tlora, torch.from_numpy(tokens[:, :-1]),
                               torch.from_numpy(ids))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4 * float(
                                   np.abs(want).max()))
    from repro.models.transformer import pad_cache as jax_pad_cache
    want, _ = jd.decode_step(params, lora, jax_pad_cache(jcache, 2),
                             jnp.asarray(tokens[:, -1:]), jnp.asarray(ids))
    got, _ = model.decode_step(tlora, model.pad_cache(cache, 2),
                               torch.from_numpy(tokens[:, -1:]),
                               torch.from_numpy(ids))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4 * float(
                                   np.abs(want).max()))

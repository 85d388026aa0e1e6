"""The port's dry-run cells against the JAX package's, on the CPU.

* ``SHAPES`` and ``applicable_shapes`` are the JAX package's for every
  architecture (``long_500k`` for gemma3-1b, mamba2-2.7b and
  recurrentgemma-9b only).
* ``input_specs`` gives, for every (architecture x applicable shape),
  ``meta`` tensors of the JAX ``ShapeDtypeStruct``s' shapes and dtypes.
* ``model_flops_for`` is the JAX function's on every cell (relative
  1e-12), and a port of tests/test_dryrun_units.py:69; ``cell_id`` is the
  JAX one.
* For every (architecture x applicable shape x production mesh (16, 16)
  and (2, 16, 16)), ``build_step(..., device="meta")`` gives each of the
  port's parameters the shape of its JAX counterpart (``bridge.
  named_leaves`` of the JAX bundle's ``jax.eval_shape`` tree), every
  tensor on ``meta``, and ``cell_bytes`` one device's bytes by argument
  group (params, optimizer state, LoRA, cache, inputs) equal to the JAX
  bundle's, which are read from its own ``NamedSharding``s on an
  ``AbstractMesh`` (``shard_shape``; the JAX LoRA placeholder of a layer
  without attention, which the port has not, left out).
* A reduced cell of each kind (phi4-mini and gemma3, ``ShapeConfig("t",
  64, 4, kind)``, no mesh, f32) run through the port's ``bundle.fn`` on
  the JAX weights (``bridge``) and on inputs, LoRA banks and a cache from
  one numpy seed, against the JAX bundle's ``fn``: the prefill's and the
  decode step's logits within a relative error of 2e-4
  (tests/test_consistency.py:39), the train step's loss within 1e-5 and
  its gradient norm and updated parameters within 2e-4
  (tests/test_torch_training.py's tolerances).

About 25 s alone (most of it the reduced cells' JAX compiles).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.configs.shapes import input_specs as jax_input_specs  # noqa: E402
from repro.launch.roofline import model_flops_for as jax_flops  # noqa: E402
from repro.launch.steps import build_step as jax_build_step  # noqa: E402
from repro.launch.steps import cell_id as jax_cell_id  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models.config import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.models.config import \
    applicable_shapes as jax_applicable  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.configs import input_specs  # noqa: E402
from repro_torch.configs.shapes import (DRYRUN_ADAPTER_SLOTS,  # noqa: E402
                                        DRYRUN_LORA_RANK)
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.roofline import model_flops_for  # noqa: E402
from repro_torch.launch.steps import (ARG_GROUPS, build_step,  # noqa: E402
                                      cell_bytes, cell_id)
from repro_torch.models import SHAPES, ShapeConfig, applicable_shapes  # noqa: E402

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(arch, s.name) for arch in ARCH_IDS
         for s in applicable_shapes(get_config(arch))]
LONG_ARCHS = {"gemma3_1b", "mamba2_2p7b", "recurrentgemma_9b"}
# the JAX bundle's arguments by group, in its argument order
JAX_GROUPS = {"train": ("params", "opt", "inputs"),
              "prefill": ("params", "lora", "inputs", "inputs", "inputs"),
              "decode": ("params", "lora", "cache", "inputs", "inputs")}
LOGIT_TOL, LOSS_TOL, GRAD_TOL = 2e-4, 1e-5, 2e-4


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


# --------------------------------------------------------------------------- #
# shapes, stand-ins, FLOPs, cell ids
# --------------------------------------------------------------------------- #

def test_shapes_equal_jax():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JAX_SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_shapes_equal_jax(arch):
    got = [dataclasses.asdict(s) for s in applicable_shapes(get_config(arch))]
    want = [dataclasses.asdict(s)
            for s in jax_applicable(jax_config(arch))]
    assert got == want
    assert ("long_500k" in {s["name"] for s in got}) == (arch in LONG_ARCHS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_jax(arch, shape):
    got = input_specs(get_config(arch), SHAPES[shape])
    want = jax_input_specs(jax_config(arch), JAX_SHAPES[shape])
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype(t)) == \
            (tuple(want[name].shape), str(want[name].dtype)), name


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    got = model_flops_for(get_config(arch), SHAPES[shape])
    want = jax_flops(jax_config(arch), JAX_SHAPES[shape])
    assert got > 0
    assert abs(got - want) <= 1e-12 * want


def test_model_flops_positive_and_ordered():
    # tests/test_dryrun_units.py:69 on the port
    cfg = get_config("internlm2_20b")
    f_train = model_flops_for(cfg, SHAPES["train_4k"])
    f_dec = model_flops_for(cfg, SHAPES["decode_32k"])
    assert f_train > f_dec > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cell_id_equals_jax(multi_pod):
    for arch, shape in CELLS:
        assert cell_id(arch, shape, multi_pod) == \
            jax_cell_id(arch, shape, multi_pod)
    assert cell_id("gemma3_1b", "long_500k", multi_pod) == \
        f"gemma3_1b:long_500k:{'pod2' if multi_pod else 'pod1'}"


# --------------------------------------------------------------------------- #
# the cells on the production meshes: parameter shapes and per-device bytes
# --------------------------------------------------------------------------- #

class _Shape:
    """A JAX leaf's shape; indexing it (``bridge``'s unstacking of a
    segment's layers) drops the stack axis."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __getitem__(self, r):
        return _Shape(self.shape[1:])


def _jax_bytes(bundle):
    """One device's bytes of the JAX bundle's arguments by group, each
    leaf's piece read from its own ``NamedSharding``; the LoRA
    placeholder ``{"_": ...}`` of a layer without attention left out."""
    out = dict.fromkeys(ARG_GROUPS, 0)
    for group, arg, sh in zip(JAX_GROUPS[bundle.meta["kind"]], bundle.args,
                              bundle.in_shardings):
        leaves = jax.tree_util.tree_leaves_with_path(arg)
        shardings = jax.tree.leaves(
            sh, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(shardings)
        for (path, x), ns in zip(leaves, shardings):
            if group == "lora" and \
                    getattr(path[-1], "key", None) == bridge.NO_BANK:
                continue
            out[group] += math.prod(ns.shard_shape(x.shape)) \
                * x.dtype.itemsize
    out["total"] = sum(out[g] for g in ARG_GROUPS)
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_meta_cell_equals_jax(arch, shape, mesh_key):
    dims, names = MESHES[mesh_key]
    got = build_step(get_config(arch), SHAPES[shape],
                     MeshShape(dims, names))
    want = jax_build_step(jax_config(arch), JAX_SHAPES[shape],
                          AbstractMesh(dims, names))
    assert got.meta["kind"] == want.meta["kind"] == SHAPES[shape].kind
    assert got.donate == want.donate_argnums
    # nothing allocated: every argument and parameter on meta
    tensors = _tensors(got.args) + list(got.model.parameters())
    assert tensors and all(t.device.type == "meta" for t in tensors)
    # every parameter the shape of its JAX counterpart
    named = bridge.named_leaves(jax.tree.map(lambda x: _Shape(x.shape),
                                             want.args[0]))
    params = dict(got.model.named_parameters())
    assert set(params) == set(named)
    for name, p in params.items():
        assert tuple(p.shape) == named[name].shape, name
    # one device's bytes, by argument group
    assert cell_bytes(got) == _jax_bytes(want)


def test_cell_bytes_without_a_mesh_are_the_whole():
    b = build_step(get_config("gemma3_1b"), SHAPES["decode_32k"], None)
    whole = sum(t.numel() * t.element_size() for t in _tensors(b.args))
    got = cell_bytes(b)
    assert got["total"] == whole and got["opt"] == 0
    # the paper's LoRA setting: 32 slots of rank 16 on q and v
    a_q = b.args[1]["layers"][0]["a_q"]
    assert a_q.shape[0] == DRYRUN_ADAPTER_SLOTS
    assert a_q.shape[2] == DRYRUN_LORA_RANK


# --------------------------------------------------------------------------- #
# reduced cells run as the JAX bundle runs
# --------------------------------------------------------------------------- #

REDUCED = [(arch, kind) for arch in ("phi4_mini_3p8b", "gemma3_1b")
           for kind in ("prefill", "decode", "train")]


def _rel_max(got, want) -> float:
    """max |got - want| / max |want| (tests/test_consistency.py:37-38)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.linalg.norm(got - want)
    return 0.0 if diff == 0 else diff / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("arch,kind", REDUCED)
def test_reduced_cell_runs_as_the_jax_bundle(arch, kind):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    pcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jb = jax_build_step(jcfg, JaxShapeConfig("t", 64, 4, kind), None)
    pb = build_step(pcfg, ShapeConfig("t", 64, 4, kind), None,
                    device="cpu")
    assert all(t.device.type == "cpu" for t in _tensors(pb.args))
    params = jb.model.init(jax.random.PRNGKey(0))
    bridge.load_params(pb.model, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    b, s = 4, 64

    if kind == "train":
        tokens = rng.integers(0, jcfg.vocab_size, (b, s + 1), dtype=np.int32)
        new_params, _, jinfo = jax.jit(jb.fn)(
            params, jax_adamw_init(params, JaxAdamWConfig()),
            {"tokens": jnp.asarray(tokens)})
        got_params, opt, info = pb.fn(pb.args[0], pb.args[1],
                                      {"tokens": torch.from_numpy(tokens)})
        assert got_params is pb.args[0] and int(opt["step"]) == 1
        loss, want = float(info["loss"]), float(jinfo["loss"])
        assert abs(loss - want) <= LOSS_TOL * abs(want), (loss, want)
        norm, want = float(info["grad_norm"]), float(jinfo["grad_norm"])
        assert abs(norm - want) <= GRAD_TOL * abs(want), (norm, want)
        worst = max(_rel(bridge.array(got_params[name].detach()), leaf)
                    for name, leaf in bridge.named_leaves(
                        jax.tree.map(np.asarray, new_params)).items())
        assert worst <= GRAD_TOL
        return

    lora = jb.model.init_lora(jax.random.PRNGKey(1), DRYRUN_ADAPTER_SLOTS,
                              DRYRUN_LORA_RANK)
    plora = bridge.lora_to_torch(jax.tree.map(np.asarray, lora))
    ids = rng.integers(-1, DRYRUN_ADAPTER_SLOTS, (b,), dtype=np.int32)
    if kind == "prefill":
        tokens = rng.integers(0, jcfg.vocab_size, (b, s), dtype=np.int32)
        want, _ = jax.jit(jb.fn)(params, lora, jnp.asarray(tokens),
                                 jnp.asarray(ids))
        got, cache = pb.fn(pb.args[0], plora, torch.from_numpy(tokens),
                           torch.from_numpy(ids))
        assert int(cache["pos"]) == s
    else:
        # the cache's every leaf from one numpy seed, 16 short of its end
        zero = jax.tree.map(np.asarray, jb.model.init_cache(b, s))
        cache = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(x.dtype), zero)
        cache["pos"] = np.asarray(s - 16, np.int32)
        tokens = rng.integers(0, jcfg.vocab_size, (b, 1), dtype=np.int32)
        want, _ = jax.jit(jb.fn)(params, lora, cache, jnp.asarray(tokens),
                                 jnp.asarray(ids))
        pcache = bridge.cache_to_torch(cache)
        assert [set(c) for c in pcache["layers"]] == \
            [set(c) for c in pb.args[2]["layers"]]
        got, out = pb.fn(pb.args[0], plora, pcache, torch.from_numpy(tokens),
                         torch.from_numpy(ids))
        assert out is pcache and int(out["pos"]) == s - 15
    assert tuple(got.shape) == tuple(want.shape)
    rel = _rel_max(got.numpy(), want)
    assert rel < LOGIT_TOL, rel

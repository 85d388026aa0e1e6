"""The port's sharding plan against the JAX package's, in one process.

``repro_torch.models.sharding``: ``make_plan`` gives the JAX plan's fields
for every kind, mesh shape and global batch, and ``param_spec`` /
``cache_spec`` give, for every leaf of every reduced architecture, of
phi4-mini-3.8b and gemma3-1b at their published shapes and of two reduced
variants whose mixer specs disagree on a mesh (mamba2 with 4 heads of 32,
recurrentgemma with an RG-LRU width of 48; the JAX side through
``jax.eval_shape``: nothing is allocated), the JAX ``PartitionSpec`` less
the stack axis of the JAX package's per-segment stacks, on a (2, 4), a
(1, 8), a (1, 3) and a (2, 16, 16) mesh (``MeshShape`` and JAX's
``AbstractMesh``): the experts, the mixers and their states among them.  Also ``shard_tensor`` (the pieces tile the whole),
``CacheSlot.shard``, flash-decode's log-sum-exp on the CPU (its plain
versions against ``torch.logsumexp`` of the masked f32 scores, length 0
among the lengths) and ``attention.combine_shards`` over slices of one
cache against the whole cache's attention.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs import get_config, get_reduced  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.models import Model as JaxModel, ShardingPlan as JaxPlan  # noqa: E402
from repro.models import make_plan as jax_make_plan  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_reduced as port_reduced  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.attention import (CacheSlot, combine_shards,  # noqa: E402
                                          quantize_kv)
from repro_torch.models.transformer import ATTENTION_KINDS  # noqa: E402
from repro_torch.models.sharding import (ShardingPlan, local_shape,  # noqa: E402
                                         make_plan, shard_tensor)

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "1x3": ((1, 3), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")
GLOBAL_BATCHES = (1, 4, 64)
# reduced architectures whose mixer's leaves are cut apart on a mesh: on
# 1x8 mamba2's d_inner 128 divides and its 4 heads do not; on 1x3
# recurrentgemma's width 48 divides and its 16 gate blocks do not
VARIANTS = {"mamba2-hd32": ("mamba2_2p7b", {"ssm_head_dim": 32}),
            "recurrentgemma-w48": ("recurrentgemma_9b", {"lru_width": 48})}
# every reduced architecture, two at their published shapes, the variants
CONFIGS = [("reduced", a) for a in ARCH_IDS] + \
    [("published", "phi4_mini_3p8b"), ("published", "gemma3_1b")] + \
    [("variant", v) for v in VARIANTS]


def _configs(which, arch):
    if which == "variant":
        arch, over = VARIANTS[arch]
        return (dataclasses.replace(get_reduced(arch), **over),
                dataclasses.replace(port_reduced(arch), **over))
    get_j, get_p = ((get_reduced, port_reduced) if which == "reduced"
                    else (get_config, port_config))
    return get_j(arch), get_p(arch)


class _Leaf:
    """A JAX leaf's shape and spec; indexing it (``bridge``'s unstacking
    of a segment's layers) drops the stack axis from the shape and marks
    it stacked."""

    def __init__(self, shape, spec, stacked=False):
        self.shape, self.spec, self.stacked = tuple(shape), spec, stacked

    def __getitem__(self, r):
        return _Leaf(self.shape[1:], self.spec, True)

    def want(self):
        """The JAX spec as the port states it: less the stack axis."""
        spec = tuple(self.spec)
        return spec[1:] if self.stacked else spec


def _leaf_tree(shapes, specs):
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    spec_leaves = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    assert len(leaves) == len(spec_leaves)
    return jax.tree_util.tree_unflatten(
        treedef, [_Leaf(x.shape, s) for x, s in zip(leaves, spec_leaves)])


def _plans(jcfg, pcfg, mesh_key):
    shape, names = MESHES[mesh_key]
    for kind in KINDS:
        for gb in GLOBAL_BATCHES:
            yield (kind, gb,
                   jax_make_plan(jcfg, AbstractMesh(shape, names), kind,
                                 global_batch=gb, kv_quant=True),
                   make_plan(pcfg, MeshShape(shape, names), kind,
                             global_batch=gb, kv_quant=True))


def _fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if f.name != "mesh"}


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("which,arch", CONFIGS)
def test_param_specs_equal_jax_less_the_stack_axis(which, arch, mesh_key):
    jcfg, pcfg = _configs(which, arch)
    quant = bool(jcfg.n_experts)   # int8 experts and their scales too
    jm = JaxModel(jcfg, JaxPlan(expert_quant=quant))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    lora = jax.eval_shape(lambda k: jm.init_lora(k, 4, 8),
                          jax.random.PRNGKey(0))
    n = 0
    for kind, gb, jplan, pplan in _plans(jcfg, pcfg, mesh_key):
        assert _fields(pplan) == _fields(jplan), (kind, gb)
        named = bridge.named_leaves(
            _leaf_tree(params, jplan.param_specs(params)))
        got = pplan.param_specs(named)
        assert set(got) == set(named)
        for name, leaf in named.items():
            assert got[name] == leaf.want(), (kind, gb, name, leaf.shape)
            n += 1
        # LoRA banks: replicated, under the port's per-layer names
        banks = bridge._unstack(
            _leaf_tree(lora, jplan.param_specs(lora))["segments"])
        for i, layer in enumerate(banks):
            for name, leaf in layer.items():
                if name == bridge.NO_BANK:
                    # a layer without attention: the port has no bank
                    # there (its init_lora gives {}).  The JAX
                    # placeholder (1,) keeps its spec off its stack axis;
                    # a train plan over a data axis of size 1 would cut
                    # the port's lone (1,) leaf over it: not compared
                    assert pcfg.layer_kinds[i] not in ATTENTION_KINDS
                    if kind == "train" and jplan.mesh.shape["data"] == 1:
                        continue
                assert pplan.param_spec(("layers", str(i), name),
                                        leaf.shape) == leaf.want()
    assert n > 0


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("which,arch", CONFIGS)
def test_cache_specs_equal_jax_less_the_stack_axis(which, arch, mesh_key):
    jcfg, pcfg = _configs(which, arch)
    for kv_quant in (False, True):
        jm = JaxModel(jcfg, JaxPlan(kv_quant=kv_quant))
        cache = jax.eval_shape(lambda: jm.init_cache(64, 512))
        for kind, gb, jplan, pplan in _plans(jcfg, pcfg, mesh_key):
            tree = _leaf_tree(cache, jplan.cache_specs(cache))
            port_tree = {"pos": tree["pos"],
                         "layers": bridge._unstack(tree["segments"])}
            got = pplan.cache_specs(port_tree)
            assert got["pos"] == () == tuple(tree["pos"].spec)
            assert len(got["layers"]) == pcfg.n_layers
            for specs, layer in zip(got["layers"], port_tree["layers"]):
                assert set(specs) == set(layer)
                for name, leaf in layer.items():
                    assert specs[name] == leaf.want(), (kind, gb, name)


@pytest.mark.parametrize("variant,mesh_key,cut,whole", [
    ("mamba2-hd32", "1x8", ("ssd.w_x", "ssd.w_z", "ssd.w_out", "ssd.conv_x"),
     ("ssd.w_dt",)),
    ("recurrentgemma-w48", "1x3", ("rglru.w_x", "rglru.w_gate",
                                   "rglru.w_out", "rglru.conv_w"),
     ("rglru.w_a", "rglru.w_i")),
])
def test_variants_cut_a_mixer_apart_in_the_jax_package(variant, mesh_key,
                                                       cut, whole):
    # the disagreement the sharded decode's tests decode through, as the
    # JAX package's decode plan states it (and so the port's, above)
    jcfg, _ = _configs("variant", variant)
    shape, names = MESHES[mesh_key]
    plan = jax_make_plan(jcfg, AbstractMesh(shape, names), "decode",
                         global_batch=2)
    params = jax.eval_shape(JaxModel(jcfg, JaxPlan()).init,
                            jax.random.PRNGKey(0))
    named = bridge.named_leaves(
        _leaf_tree(params, plan.param_specs(params)))
    for name in cut:
        assert "model" in named[f"layers.0.{name}"].want()
    for name in whole:
        assert set(named[f"layers.0.{name}"].want()) == {None}
    cache = jax.eval_shape(lambda: JaxModel(jcfg, JaxPlan()).init_cache(2,
                                                                        32))
    states = bridge._unstack(_leaf_tree(
        cache, plan.cache_specs(cache))["segments"])[0]
    state = "ssm" if "ssd.w_dt" in whole else "lru"
    assert ("model" in states[state].want()) == (state == "lru")


def test_decode_plans_shard_as_the_jax_package_says():
    cfg = port_reduced("phi4-mini-3.8b")
    mesh = MeshShape((2, 4), ("data", "model"))
    plan = make_plan(cfg, mesh, "decode", global_batch=4)
    assert (plan.batch_axes, plan.width_axis, plan.cache_seq_axes) == \
        (("data",), "model", ("model",))
    assert (plan.n_width, plan.n_cache, plan.dp()) == (4, 4, ("data",))
    one = make_plan(cfg, mesh, "decode", global_batch=1)
    assert (one.batch_axes, one.cache_seq_axes, one.n_cache, one.dp()) == \
        ((), ("data", "model"), 8, None)
    # without a mesh: the one-device plan of the kind, every spec whole
    bare = make_plan(cfg, None, "decode", kv_quant=True)
    assert bare.mesh is None and bare.kv_quant and bare.n_cache == 1
    assert bare.param_spec(("layers", "0", "wq"), (64, 64)) == (None, None)
    # a width that does not divide stays whole
    assert plan.param_spec(("layers", "0", "wk"), (64, 6)) == (None, None)
    assert plan.param_spec(("layers", "0", "wk"), (64, 8)) == (None, "model")


class _Coords:
    """A mesh's names, sizes and one rank's coordinates (a DeviceMesh's
    ``get_local_rank``), without processes."""

    def __init__(self, shape, names, coords):
        self.shape, self.mesh_dim_names = shape, names
        self._coords = dict(zip(names, coords))

    def get_local_rank(self, name):
        return self._coords[name]


def test_shard_tensor_pieces_tile_the_whole():
    full = torch.arange(4 * 16 * 6, dtype=torch.float32).reshape(4, 16, 6)
    shape, names = (2, 4), ("data", "model")
    spec = ("data", ("data", "model"), None)
    pieces = {}
    for d in range(2):
        for m in range(4):
            plan = ShardingPlan(mesh=_Coords(shape, names, (d, m)))
            piece = shard_tensor(full, spec, plan)
            assert piece.shape == local_shape(full.shape, spec, plan) \
                == (2, 2, 6)
            assert piece.is_contiguous()
            pieces[d, m] = piece
    # (data, model) orders data first: piece (d, m) holds rows d*4 + m
    for (d, m), piece in pieces.items():
        i = d * 4 + m
        assert torch.equal(piece, full[2 * d:2 * d + 2, 2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="does not divide"):
        shard_tensor(full[:, :15], spec, ShardingPlan(
            mesh=_Coords(shape, names, (0, 0))))


@pytest.mark.parametrize("pos", [0, 7, 8, 30, 40])
def test_cache_slot_of_a_slice(pos):
    s_loc, n = 8, 4
    p = torch.tensor(pos, dtype=torch.int32)
    for my in range(n):
        slot = CacheSlot.shard(p, s_loc, my)
        local = pos - my * s_loc
        assert bool(slot.live) == (0 <= local < s_loc)
        assert int(slot.length) == min(max(local + 1, 0), s_loc)
        assert int(slot.index) == min(max(local, 0), s_loc - 1)
    # slice 0 of one slice is the whole cache's slot
    whole = CacheSlot.at(p, s_loc)
    one = CacheSlot.shard(p, s_loc, 0)
    assert (int(one.index), bool(one.live), int(one.length)) == \
        (int(whole.index), bool(whole.live), int(whole.length))


def _inputs(seed, b=3, s=40, h=8, kv=2, d=32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return t(b, h, d), t(b, s, kv, d), t(b, s, kv, d)


def _masked_scores(q, k, lengths, k_scale=None):
    """(B, H, S) f32 scaled scores, -inf past each row's length."""
    bsz, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    sc = torch.einsum("bkgd,bskd->bkgs", q.reshape(bsz, kv, h // kv, d),
                      k.float()) / math.sqrt(d)
    if k_scale is not None:
        sc = sc * k_scale.float().permute(0, 2, 1)[:, :, None]
    mask = torch.arange(s)[None, :] < lengths[:, None]
    return sc.masked_fill(~mask[:, None, None], -math.inf).reshape(bsz, h, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_plain_is_logsumexp_of_the_masked_scores(dtype):
    q, k, v = (t.to(dtype) for t in _inputs(0))
    lengths = torch.tensor([0, 1, 33], dtype=torch.int32)
    out, lse = fd.flash_decode_plain(q, k, v, lengths, return_lse=True)
    assert lse.shape == (3, 8) and lse.dtype == out.dtype == torch.float32
    want = torch.logsumexp(_masked_scores(q.float(), k, lengths), -1)
    assert torch.isneginf(lse[0]).all()                 # length 0: -inf
    torch.testing.assert_close(lse[1:], want[1:], rtol=2e-6, atol=2e-6)
    # the output before its cast: cast, the plain output bit for bit
    assert torch.equal(out.to(dtype), fd.flash_decode_plain(q, k, v,
                                                            lengths))
    assert not out[0].any()                              # and out 0


@pytest.mark.parametrize("exact_dot", [False, True])
def test_int8_lse_plain_is_logsumexp_of_the_masked_scores(exact_dot):
    q, k, v = _inputs(1)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    lengths = torch.tensor([17, 0, 40], dtype=torch.int32)
    out, lse = fd.flash_decode_int8_plain(q, kq, vq, lengths, ks, vs,
                                          exact_dot=exact_dot,
                                          return_lse=True)
    want = torch.logsumexp(_masked_scores(q, kq, lengths, ks), -1)
    assert torch.isneginf(lse[1]).all()
    torch.testing.assert_close(lse[[0, 2]], want[[0, 2]], rtol=2e-6,
                               atol=2e-6)
    assert torch.equal(out, fd.flash_decode_int8_plain(
        q, kq, vq, lengths, ks, vs, exact_dot=exact_dot))
    # the wrapper's CPU route returns the same pair
    got = fd.flash_decode_lse(q, kq, vq, lengths, ks, vs)
    assert torch.equal(got[1], fd.flash_decode_int8_plain(
        q, kq, vq, lengths, ks, vs, return_lse=True)[1])


@pytest.mark.parametrize("n", [1, 2, 5])
def test_combine_shards_of_slices_is_the_whole_attention(n):
    # pos 17 over 40 rows in n slices: the slices past it hold no live row
    q, k, v = _inputs(2, s=40)
    pos = 17
    whole = fd.flash_decode_plain(q, k, v, pos + 1)
    s_loc = 40 // n
    outs, lses = [], []
    for my in range(n):
        slot = CacheSlot.shard(torch.tensor(pos, dtype=torch.int32), s_loc,
                               my)
        o, lse = fd.flash_decode_lse(q, k[:, my * s_loc:(my + 1) * s_loc],
                                     v[:, my * s_loc:(my + 1) * s_loc],
                                     slot.length)
        outs.append(o)
        lses.append(lse)
    stack = {"max": lambda t: t.amax(0, keepdim=True),
             "sum": lambda t: t.sum(0, keepdim=True)}
    got = combine_shards(torch.stack(outs), torch.stack(lses),
                         lambda t, op: stack[op](t))[0]
    torch.testing.assert_close(got, whole, rtol=2e-5, atol=2e-5)
    if n == 1:
        assert torch.equal(got, whole)   # one slice: out itself

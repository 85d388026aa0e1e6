"""Sharding plans of the port (counterpart of ``repro.models.sharding``).

The same rules, line for line: ``ShardingPlan`` turns each parameter and
cache leaf into a spec on a named mesh, and ``make_plan`` sets up the
baseline plan of each step kind (train, prefill, decode).  In decode the
batch goes to ``data``, the weights are column- or row-sharded over
``model`` (resident TP) and the KV cache is sequence-sharded over
``model``, or over ``(data, model)`` when ``global_batch`` is 1.

What differs from the JAX package:

* a spec is a tuple with one entry per dimension, each ``None``, an axis
  name or a tuple of two or more axis names (a ``PartitionSpec``'s
  entries: a one-axis tuple is its name), and a scalar's is ``()``;
* the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or
  ``launch.mesh.MeshShape`` (names and sizes only, for specs without
  processes, as the JAX package's ``AbstractMesh``), or None; the plan
  reads only its ``mesh_dim_names`` and ``shape``;
* the port keeps one tensor per layer where the JAX package stacks a
  segment's layers on a leading axis: a port spec is the JAX spec without
  that axis, under the port's parameter names (``layers.3.mlp.w_up``), and
  the cache rules, written against (R, B, ...) leaves there, index the
  port's (B, ...) leaves one lower;
* ``constrain`` and ``shardings`` have no counterpart: the port places
  tensors itself (``shard_tensor``, the port's ``device_put``) and its
  training, prefill and decode run explicit collectives (``all_reduce``,
  ``all_gather``, ``reduce_scatter``, ``shift``, the port's ``ppermute``,
  and ``gather_whole``) over the mesh's process groups
  (``ShardingPlan.group``), each with its adjoint under autograd where
  jax.grad transposes the program; where pjit lays out a mixer from its
  leaves' specs, the port moves activations between a rank's piece and
  the whole itself (``WidthShards``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

#: collectives issued by ``all_reduce``, ``all_gather``,
#: ``reduce_scatter``, ``shift`` and ``gather_whole`` (a weight gathered
#: whole, counted apart from the activations' gathers);
#: ``reset_collectives`` zeroes them
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
               "shift": 0, "weight_gather": 0}

#: the operand bytes of those collectives, a rank's, by the kinds of the
#: JAX dry-run's HLO parser (``collective_bytes``, roofline.py:49-75): an
#: all-reduce's and a reduce-scatter's whole input, an all-gather's piece
#: (weight gathers too), a shift's tensor ("collective-permute"); the
#: port issues no all-to-all
COLLECTIVE_BYTES = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                    "all-to-all": 0, "collective-permute": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0
    for kind in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[kind] = 0


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _spec(entries) -> tuple:
    """A spec from its entries, a one-axis tuple as its name (as a
    ``PartitionSpec`` holds it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any = None                       # DeviceMesh | MeshShape | None
    batch_axes: Tuple[str, ...] = ()       # activation batch dim
    seq_axis: str = ""                     # activation seq dim (train/prefill)
    width_axis: str = ""                   # TP width axis (ssm/hybrid, serve)
    fsdp_axes: Tuple[str, ...] = ()        # weight-shard axes (train)
    cache_seq_axes: Tuple[str, ...] = ()   # KV-cache seq dim (serve)
    kv_quant: bool = False                 # int8 KV cache (beyond-paper)
    expert_quant: bool = False             # weight-only int8 experts (serve)
    attn_batch_shard: bool = False         # reshard attn batch over seq axis
    remat: bool = False
    unroll: bool = False                   # analysis mode: unroll inner loops
    mode: str = "train"                    # train | prefill | decode

    # ------------------------------------------------------------------ #
    def axis_size(self, *names: str) -> int:
        if self.mesh is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        n = 1
        for name in names:
            if name:
                n *= sizes[name]
        return n

    @property
    def n_seq(self) -> int:
        return self.axis_size(self.seq_axis)

    @property
    def n_width(self) -> int:
        return self.axis_size(self.width_axis)

    @property
    def n_cache(self) -> int:
        return self.axis_size(*self.cache_seq_axes)

    def _fits(self, dim: int, axes) -> bool:
        axes = axes if isinstance(axes, tuple) else (axes,)
        return dim % max(self.axis_size(*axes), 1) == 0

    # ------------------------------------------------------------------ #
    def dp(self):
        return self.batch_axes if self.batch_axes else None

    def cuts_width(self, spec) -> bool:
        """Whether ``spec`` cuts a dimension over the width axis."""
        return bool(self.width_axis) and any(
            self.width_axis in _axes(e) for e in spec if e is not None)

    # ------------------------------------------------------------------ #
    # parameter specs
    # ------------------------------------------------------------------ #
    _COL = ("w_gate", "w_up", "w_z", "w_x", "w_dt", "wq", "wk", "wv",
            "unembed", "w_gate_in")
    _ROW = ("w_down", "w_out", "wo")
    _SMALL = ("router", "scale", "bias", "a_log", "dt_bias", "d_skip",
              "a_param", "w_bc", "conv_bc", "bq", "bk", "bv")

    def param_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]):
        """The spec of the parameter at ``path`` (its name split on ".":
        ``("layers", "3", "mlp", "w_up")``) of (unstacked) ``shape``."""
        name = path[-1]
        is_expert = "moe" in path
        is_lora = "lora" in path or name.startswith(("a_", "b_")) and \
            name in ("a_q", "b_q", "a_v", "b_v")
        nd = len(shape)
        none = [None] * nd

        if is_lora:
            return _spec(none)
        if name in self._SMALL and not is_expert:
            return _spec(none)

        w = self.width_axis or None

        if is_expert and name in ("w_gate", "w_up", "w_down", "router",
                                  "w_gate_scale", "w_up_scale",
                                  "w_down_scale"):
            if name == "router":
                return _spec(none)
            if name.endswith("_scale"):     # (E, 1, ff): E over EP axis
                spec = list(none)
                ep = (self.width_axis or self.seq_axis) or None
                if ep and self._fits(shape[nd - 3], ep):
                    spec[nd - 3] = ep
                return _spec(spec)
            # (E, d, ff) / (E, ff, d): experts over EP axis
            spec = list(none)
            ep = (self.width_axis or self.seq_axis) or None
            e_dim = nd - 3
            if ep and self._fits(shape[e_dim], ep):
                spec[e_dim] = ep
            if self.fsdp_axes:
                ff_dim = nd - 1 if name != "w_down" else nd - 2
                if spec[ff_dim] is None and self._fits(shape[ff_dim], "data"):
                    spec[ff_dim] = "data"
            return _spec(spec)

        spec = list(none)
        if name in ("w_a", "w_i"):  # (nb, wb, wb) block-diagonal gates
            if w and self._fits(shape[nd - 3], w):
                spec[nd - 3] = w
            return _spec(spec)
        if name in ("conv_x", "conv_w"):
            if w and self._fits(shape[nd - 1], w):
                spec[nd - 1] = w
            return _spec(spec)
        if name == "embed":
            if self.mode == "train" and self.fsdp_axes and \
                    self._fits(shape[0], self.fsdp_axes):
                return _spec((self.fsdp_axes, None))
            return _spec(none)

        if w and name in self._COL and self._fits(shape[nd - 1], w):
            spec[nd - 1] = w
        elif w and name in self._ROW and self._fits(shape[nd - 2], w):
            spec[nd - 2] = w

        if self.mode == "train" and self.fsdp_axes:
            # FSDP: shard the largest still-unsharded dim
            cands = sorted(range(max(nd - 2, 0), nd),
                           key=lambda i: -shape[i])
            for i in cands:
                if spec[i] is None and self._fits(shape[i], self.fsdp_axes):
                    spec[i] = self.fsdp_axes
                    break
        return _spec(spec)

    def param_specs(self, params) -> Dict[str, tuple]:
        """{name: spec} of ``params``, a mapping of dotted parameter names
        to anything with a ``shape`` (``dict(model.named_parameters())``
        of an unsharded model, or ``bridge.import_tree``'s output)."""
        return {name: self.param_spec(tuple(name.split(".")),
                                      tuple(t.shape))
                for name, t in params.items()}

    # ------------------------------------------------------------------ #
    # cache specs
    # ------------------------------------------------------------------ #
    def cache_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]):
        """The spec of the cache leaf at ``path`` (its name last) of shape
        ``shape``: the JAX rules with the layer axis R gone."""
        name = path[-1]
        nd = len(shape)
        if name == "pos":
            return ()
        dp = self.dp()
        w = self.width_axis or None
        cache_seq = self.cache_seq_axes if self.cache_seq_axes else None
        if name in ("k", "v"):             # (B, S, KV, D) global layers
            return _spec((dp, cache_seq, None, None))
        if name in ("k_scale", "v_scale"):  # (B, S, KV) int8-KV scales
            return _spec((dp, cache_seq, None))
        if name in ("k_loc", "v_loc"):     # (B, W, KV, D) rolling
            return _spec((dp, None, None, None))
        if name in ("conv_x", "conv"):     # (B, cw-1, C@width)
            sp = [None] * nd
            sp[0] = dp
            if w and shape[-1] % max(self.axis_size(w), 1) == 0:
                sp[-1] = w
            return _spec(sp)
        if name == "conv_bc":
            return _spec((dp, None, None))
        if name == "ssm":                  # (B, H@width, p, n)
            sp = [dp, None, None, None]
            if w and shape[1] % max(self.axis_size(w), 1) == 0:
                sp[1] = w
            return _spec(sp)
        if name == "lru":                  # (B, W@width)
            sp = [dp, None]
            if w and shape[1] % max(self.axis_size(w), 1) == 0:
                sp[1] = w
            return _spec(sp)
        return _spec([None] * nd)

    def cache_specs(self, cache):
        """The port's cache tree ({"pos", "layers": [{name: leaf}]}) with
        each leaf replaced by its spec."""
        return {"pos": (),
                "layers": [{name: self.cache_spec((str(i), name),
                                                  tuple(t.shape))
                            for name, t in layer.items()}
                           for i, layer in enumerate(cache["layers"])]}

    # ------------------------------------------------------------------ #
    # this rank on a DeviceMesh (no counterpart: pjit places for JAX)
    # ------------------------------------------------------------------ #
    def coordinate(self, entry) -> int:
        """This rank's index along a spec entry (an axis or a tuple of
        axes, the first the most significant, as a ``PartitionSpec``
        orders them)."""
        sizes = mesh_sizes(self.mesh)
        i = 0
        for a in _axes(entry):
            i = i * sizes[a] + self.mesh.get_local_rank(a)
        return i

    def group(self, entry):
        """The process group over a spec entry's axes (one axis, or a tuple
        flattened into one group).  Flattening makes new groups: every
        rank calls it, in the same order (``Model`` does, when it is
        built)."""
        axes = _axes(entry)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        return self.mesh[axes]._flatten("_".join(axes)).get_group()

    # ------------------------------------------------------------------ #
    # a train plan's gradients (no counterpart: pjit differentiates the
    # global program for JAX)
    # ------------------------------------------------------------------ #
    @property
    def token_axes(self) -> Tuple[str, ...]:
        """The axes whose ranks hold different tokens: the batch axes, and
        the sequence axis where there is one (never the width axis)."""
        return self.batch_axes + ((self.seq_axis,) if self.seq_axis else ())

    def grad_sum_axes(self, spec) -> Tuple[str, ...]:
        """The token axes over which a parameter of ``spec`` has its
        gradient summed after backward: those its spec does not cut.  A
        cut over an axis is either gathered at its use (the gather's
        reduce-scatter sums over it) or meets every token of the axis
        there (experts over the tokens gathered for them)."""
        cut = {a for e in spec if e is not None for a in _axes(e)}
        return tuple(a for a in self.token_axes if a not in cut)

    def replicas(self, spec) -> int:
        """The ranks that hold the same piece of a tensor of ``spec``: the
        product of the mesh's axes the spec does not cut."""
        cut = {a for e in spec if e is not None for a in _axes(e)}
        return math.prod(n for a, n in mesh_sizes(self.mesh).items()
                         if a not in cut)


class RankGroups:
    """What one rank's sharded training, prefill and decode need of its
    plan's mesh: the process groups over the width axis, over the
    expert-parallel axis (the width axis, or the sequence axis without
    one: ``_ffn``, transformer.py:367), over the cache axes, over the
    sequence axis and over the batch axes, and the rank's index along
    each; a train plan's also over its token axes and over the whole
    mesh.  Built on every rank in the same order (a group over two axes,
    such as the cache axes of a ``(data, model)`` plan, is a flattened
    mesh, a new group)."""

    def __init__(self, plan: ShardingPlan):
        self.plan = plan
        self.width, self.width_index = self._on(plan.width_axis)
        self.ep, self.ep_index = self._on(plan.width_axis or plan.seq_axis)
        self.cache, self.cache_index = self._on(plan.cache_seq_axes)
        self.seq, self.seq_index = self._on(plan.seq_axis)
        self.n_seq = plan.n_seq
        self.batch, self.batch_index = self._on(plan.batch_axes)
        self.n_batch = plan.axis_size(*plan.batch_axes)
        if plan.mode == "train":
            # the loss's mean over the ranks that hold different tokens,
            # and the gradient norm's sum over every rank
            self.tokens, _ = self._on(plan.token_axes)
            self.n_tokens = plan.axis_size(*plan.token_axes)
            self.world, _ = self._on(tuple(plan.mesh.mesh_dim_names))

    def _on(self, entry):
        """(the group over a spec entry, this rank's index on it); (None, 0)
        for no axis."""
        if not entry:
            return None, 0
        return self.plan.group(entry), self.plan.coordinate(entry)


@dataclasses.dataclass(frozen=True)
class WidthShards:
    """One mixer under width tensor parallelism: the width axis's group,
    this rank's index on it, the axis's size, and the names of the
    mixer's leaves (its parameters, and its cache states prefixed
    ``cache.``) that the plan cuts over the axis.

    The JAX package decides each leaf's spec alone (``_fits``) and lets
    pjit lay the mixer's activations out to match; here an activation is
    the rank's piece or the whole along its last dimension, and
    ``relayout`` moves it from the layout of the leaf that made it to the
    layout of the leaf that reads it."""
    group: Any
    index: int
    size: int
    cut: frozenset

    def __contains__(self, name: str) -> bool:
        return name in self.cut

    def piece(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's piece of the whole ``t`` along ``dim`` (a view).
        ``t`` is held alike over the group and each rank keeps another
        piece, so under autograd the gradient of ``t`` is summed over the
        group (``copy``)."""
        n = t.shape[dim] // self.size
        return copy(t, self.group).narrow(dim, self.index * n, n)

    def enter(self, t: torch.Tensor, cut: bool) -> torch.Tensor:
        """``t``, held alike over the group, as the input of a product
        with a column-cut weight (``cut``): its gradient summed over the
        group under autograd (``copy``); a whole weight's input as it
        is."""
        return copy(t, self.group) if cut else t

    def relayout(self, t: torch.Tensor, have: bool,
                 want: bool) -> torch.Tensor:
        """``t``, the rank's piece along its last dimension if ``have``
        else the whole, as the rank's piece if ``want`` else the whole:
        gathered over the group (a whole every rank consumes alike), or
        cut (``piece``)."""
        if have == want:
            return t
        if have:
            return all_gather(t, self.group, adjoint="slice")
        return self.piece(t)

    def reduce(self, t: torch.Tensor, cut: bool) -> torch.Tensor:
        """The product of a row-cut weight (``cut``) summed over the group;
        a whole weight's as it is."""
        return all_reduce(t, "sum", self.group) if cut else t


def local_shape(shape, spec, plan: ShardingPlan) -> Tuple[int, ...]:
    """The shape of a rank's piece of a tensor of ``shape`` under
    ``spec``."""
    return tuple(n if entry is None else n // plan.axis_size(*_axes(entry))
                 for n, entry in zip(shape, spec))


def shard_cache(cache, plan: ShardingPlan):
    """This rank's piece of a whole cache ({"pos", "layers"}), cut by
    ``plan.cache_specs`` (``pos`` copied)."""
    specs = plan.cache_specs(cache)
    return {"pos": cache["pos"].clone(),
            "layers": [{name: shard_tensor(t, sp[name], plan)
                        for name, t in layer.items()}
                       for layer, sp in zip(cache["layers"],
                                            specs["layers"])]}


def shard_tensor(t: torch.Tensor, spec, plan: ShardingPlan) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``spec`` (the
    port's ``jax.device_put`` onto a ``NamedSharding``): dimension i is cut
    into ``axis_size(*spec[i])`` equal pieces and the rank keeps the one at
    its coordinate.  A copy, contiguous; a dimension that does not divide
    raises (the plan's ``_fits`` replicates those)."""
    if plan.mesh is None:
        return t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = plan.axis_size(*_axes(entry))
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide over {entry} ({n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, plan.coordinate(entry) * size, size)
    return t.clone(memory_format=torch.contiguous_format)


# --------------------------------------------------------------------------- #
# collectives, each with its adjoint under autograd
# --------------------------------------------------------------------------- #
#
# The convention of a planned loss: it is the same scalar on every rank, and
# each rank backpropagates from it.  A tensor that every rank of a group
# holds alike and consumes alike then gets the same, whole gradient on each
# of them; one that each rank consumes differently gets on each rank the
# part of the gradient its own consumption makes, and the parts are summed
# where the tensor is reduced back.  Which adjoint a collective takes so
# depends on how its output is consumed, and each call site says so
# (``all_gather``'s ``adjoint``; ``copy`` where a tensor held alike enters
# a computation that differs by rank).  Under ``no_grad``, or on a tensor
# that needs no gradient, each function runs its forward alone, as it did
# before it had an adjoint.  The backward's collectives are counted in
# ``COLLECTIVES`` under the key of the collective they issue (a weight
# gather's reduce-scatters under "reduce_scatter"), and their operand bytes
# in ``COLLECTIVE_BYTES`` under its kind.
#
# On ``meta`` (one rank of a mesh whose process group moves nothing, the
# dry-run's, ``launch.mesh.meta_mesh``) each collective asks the group only
# its size and the rank's index, and gives a ``meta`` result of the shape
# the collective gives, its tensors made by the same aten ops: the
# sends, receives and reductions are left out.

def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _operand(kind: str, t: torch.Tensor) -> None:
    COLLECTIVE_BYTES[kind] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, group, op=None) -> None:
    """``t`` reduced over ``group`` in place (a sum by default)."""
    import torch.distributed as dist
    _operand("all-reduce", t)
    if not t.is_meta:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=group)


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    t = t.contiguous()
    _operand("all-gather", t)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    if not t.is_meta:
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    _operand("reduce-scatter", t)
    parts = [p.contiguous() for p in
             t.chunk(dist.get_world_size(group), dim=dim)]
    out = torch.empty_like(parts[0])
    if not t.is_meta:
        dist.reduce_scatter(out, parts, group=group)
    return out


def _send(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """``t`` sent to group index i + ``step`` and the one of i - ``step``
    received (indices mod n)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    t = t.contiguous()
    _operand("collective-permute", t)
    out = torch.empty_like(t)
    if t.is_meta:
        return out
    ops = [dist.P2POp(dist.isend, t,
                      dist.get_global_rank(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (i - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose result every rank consumes alike: the
    gradient passes through (Megatron's "reduce")."""

    @staticmethod
    def forward(ctx, t, group):
        COLLECTIVES["all_reduce"] += 1
        out = t.clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """A tensor held alike over the group, about to be consumed
    differently by each rank: the identity forward, its gradients summed
    over the group backward (Megatron's "copy")."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["all_reduce"] += 1
        g = g.clone()
        _all_reduce(g, ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, factor):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        COLLECTIVES["reduce_scatter"] += 1
        return _scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["all_gather"] += 1
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, adjoint, key):
        import torch.distributed as dist
        ctx.group, ctx.dim, ctx.adjoint = group, dim, adjoint
        ctx.n = t.shape[dim]
        ctx.index = dist.get_group_rank(group, dist.get_rank())
        COLLECTIVES[key] += 1
        return _gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.adjoint == "slice":
            return (g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(),
                    None, None, None, None)
        COLLECTIVES["reduce_scatter"] += 1
        return _scatter(g, ctx.group, ctx.dim), None, None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        COLLECTIVES["shift"] += 1
        return _send(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["shift"] += 1
        return _send(g, ctx.group, -1), None


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced over ``group`` ("sum" or "max"); counted.  Without a
    gradient in reach, in place.  Under autograd a sum is a new tensor
    whose every rank consumes it alike (a row-cut product's partial sums,
    ``WidthShards.reduce`` and ``_Planned._down``; the loss's mean): its
    gradient passes through unchanged.  A max has no gradient: a tensor
    that needs one raises ``ValueError``."""
    import torch.distributed as dist
    if _needs_grad(t):
        if op != "sum":
            raise ValueError(f"all_reduce {op!r} has no gradient: reduce a "
                             "tensor that does not require one")
        return _AllReduceSum.apply(t, group)
    COLLECTIVES["all_reduce"] += 1
    _all_reduce(t, group, {"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op])
    return t


def copy(t: torch.Tensor, group) -> torch.Tensor:
    """``t``, held alike on every rank of ``group``, where each rank goes
    on to consume it differently (the input of a column-cut product, a
    replicated tensor cut into the rank's piece): the identity, and under
    autograd its gradients summed over the group (one all-reduce, counted
    in backward).  ``t`` itself without a gradient in reach, and over a
    group of one (whose sum is the gradient: autograd then sums ``t``'s
    gradients in the order it does without a plan)."""
    import torch.distributed as dist
    if not _needs_grad(t) or dist.get_world_size(group) == 1:
        return t
    return _Copy.apply(t, group)


def scale_grad(t: torch.Tensor, factor: float) -> torch.Tensor:
    """``t``, its gradient multiplied by ``factor`` under autograd: a value
    computed alike on the ``n`` ranks of a group whose gradient reaches
    its inputs through adjoints that sum over the group (an all-gather's
    reduce-scatter) is backpropagated by each rank at 1 / n."""
    if factor == 1 or not _needs_grad(t):
        return t
    return _ScaleGrad.apply(t, factor)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over ``group``, cut along ``dim`` into the group's
    pieces in rank order, and this rank's piece (``psum_scatter(...,
    tiled=True)``); counted.  Its adjoint is the all-gather of the
    pieces' gradients."""
    if _needs_grad(t):
        return _ReduceScatter.apply(t, group, dim)
    COLLECTIVES["reduce_scatter"] += 1
    return _scatter(t, group, dim)


def all_gather(t: torch.Tensor, group, dim: int = -1,
               adjoint: str = "") -> torch.Tensor:
    """The group's pieces of ``t`` concatenated along ``dim`` in rank
    order; counted.  Under autograd ``adjoint`` names how the ranks
    consume the whole: "slice" where every rank consumes it alike (its
    gradient is then the same whole on each, and the rank keeps its
    piece's), "sum" where each consumes it differently (the pieces'
    gradients are reduce-scattered); a tensor that needs a gradient
    without one raises ``ValueError``."""
    if _needs_grad(t):
        if adjoint not in ("slice", "sum"):
            raise ValueError("all_gather under autograd: name the adjoint, "
                             "'slice' (the ranks consume the whole alike) "
                             "or 'sum' (each consumes it differently)")
        return _AllGather.apply(t, group, dim, adjoint, "all_gather")
    COLLECTIVES["all_gather"] += 1
    return _gather(t, group, dim)


def shift(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` sent to the next rank of ``group`` (index i to (i + 1) % n)
    and the previous rank's received, ``jax.lax.ppermute`` over the ring
    ``[(i, (i + 1) % n)]``: one send and one receive batched
    (``batch_isend_irecv``, which gloo and NCCL both take); counted.  A
    group of one returns ``t``.  Its adjoint is the reverse shift, i + 1
    to i."""
    import torch.distributed as dist
    if dist.get_world_size(group) == 1:
        return t
    if _needs_grad(t):
        return _Shift.apply(t, group)
    COLLECTIVES["shift"] += 1
    return _send(t, group, 1)


def _gathered(spec, axes):
    """The (dimension, entry) pairs of ``spec`` that ``gather_whole``
    gathers: every cut one, or with ``axes`` those cut over some of
    ``axes`` only."""
    return [(dim, entry) for dim, entry in enumerate(spec)
            if entry is not None
            and (axes is None or set(_axes(entry)) <= set(axes))]


def gather_whole(t: torch.Tensor, spec, plan: ShardingPlan,
                 axes=None) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's piece under ``spec``
    (``shard_tensor``'s inverse): each cut dimension all-gathered over its
    entry's group, in rank order; with ``axes`` only the dimensions cut
    over some of those axes (an FSDP gather that keeps a width or expert
    cut); ``t`` itself where nothing is gathered.  Counted as
    ``weight_gather``, one a gathered dimension.  The ranks consume a
    gathered weight differently (each with its own tokens), so its adjoint
    is a reduce-scatter for each gathered dimension, in reverse order: the
    rank's piece gets the whole gradient of its piece."""
    for dim, entry in _gathered(spec, axes):
        group = plan.group(entry)
        if _needs_grad(t):
            t = _AllGather.apply(t, group, dim, "sum", "weight_gather")
        else:
            COLLECTIVES["weight_gather"] += 1
            t = _gather(t, group, dim)
    return t


# --------------------------------------------------------------------------- #
# canonical plans
# --------------------------------------------------------------------------- #

def make_plan(cfg, mesh, kind: str, *, unroll: bool = False,
              remat: bool = False, global_batch: int = 1,
              kv_quant: bool = False) -> ShardingPlan:
    """Baseline plan for (family, step kind)."""
    if mesh is None:
        return ShardingPlan(mode="train" if kind == "train" else kind,
                            unroll=unroll, remat=remat, kv_quant=kv_quant)
    axes = mesh_sizes(mesh)
    has_pod = "pod" in axes
    # ssm/hybrid keep full seq (recurrence) and use width-TP everywhere
    width_tp_family = cfg.family in ("ssm", "hybrid")

    batch_axes: Tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    n_batch = math.prod(axes[a] for a in batch_axes)
    if global_batch % max(n_batch, 1) != 0 or global_batch < n_batch:
        batch_axes = ("data",) if global_batch % axes.get("data", 1) == 0 \
            and global_batch >= axes.get("data", 1) else ()

    if kind == "train":
        return ShardingPlan(
            mesh=mesh, batch_axes=batch_axes,
            seq_axis="" if width_tp_family else "model",
            width_axis="model" if width_tp_family else "",
            fsdp_axes=("data",) if width_tp_family else ("data", "model"),
            remat=remat, unroll=unroll, mode="train")
    if kind == "prefill":
        return ShardingPlan(
            mesh=mesh, batch_axes=batch_axes,
            seq_axis="" if width_tp_family else "model",
            width_axis="model",
            cache_seq_axes=("model",), kv_quant=kv_quant,
            unroll=unroll, mode="prefill")
    # decode
    cache_axes: Tuple[str, ...] = ("model",)
    if not batch_axes:  # global_batch=1 (long_500k): seq over data too
        cache_axes = ("data", "model")
    return ShardingPlan(
        mesh=mesh, batch_axes=batch_axes,
        seq_axis="", width_axis="model",
        cache_seq_axes=cache_axes, kv_quant=kv_quant,
        unroll=unroll, mode="decode")


"""Roofline terms of a dry-run cell on the H100 (counterpart of
``repro.launch.roofline``).

Terms per (arch x shape x mesh), all per chip:
    compute    = FLOPs / peak_FLOPs          (989 TFLOP/s dense bf16)
    memory     = bytes / HBM_bw              (3.35 TB/s HBM3)
    collective = collective_bytes / link_bw  (450 GB/s NVLink 4, one way)

The JAX package reads the FLOPs and bytes from XLA's ``cost_analysis`` of
the compiled cell and the collectives from its HLO text.  The port has
neither: ``cost_of_step`` runs the step on the ``meta`` device, as one
rank of the mesh (``launch.mesh.meta_mesh``), under one dispatch mode
that sees every aten op the eager step issues, and counts

* FLOPs: every product, by ``torch.utils.flop_counter``'s formulas, plus
  each hand-written kernel's own count (``kernels.cost``);
* bytes: each aten op's inputs read and outputs written once (views and
  allocations move nothing; a gather reads from its source only what it
  writes, an in-place scatter writes into its target only what it reads),
  plus the kernels' counts: eager's traffic, an upper bound on what XLA's
  fused count would be (an op on no ``meta`` tensor is the host's, such
  as a mesh's coordinates, and is not counted);
* collective bytes: the operand bytes of each collective the port issues
  (``sharding.COLLECTIVE_BYTES``), the kinds of the JAX parser plus
  "total";

and, while the step runs, the bytes it holds live beyond its arguments
(every new storage from its allocation until the last tensor on it is
freed), whose peak stands in for the temporaries of XLA's
``memory_analysis``.

Eager counting sees every layer, so a full-depth count is direct; the
probes at two depths and ``CellCost.extrapolate`` are kept, as the JAX
dry-run's, and agree with it exactly (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column:
PEAK_FLOPS = 989e12          # dense BF16 tensor-core FLOP/s (1979 sparse)
HBM_BW = 3.35e12             # HBM3, B/s
# NVLink 4: 900 GB/s a GPU, both directions over its 18 links.  The JAX
# term divides a chip's collective operand bytes by one ICI link's rate:
# on a torus a ring collective over one axis runs over that axis's links.
# An H100 reaches every peer through the NVSwitch fabric on all 18 links
# at once, so the pipe a chip's operand leaves by is its whole egress, one
# direction: 450 GB/s (a ring sends each byte one way and receives one).
LINK_BW = 450e9              # B/s a GPU, one direction
#: peak FLOP/s by the operands' dtype (data sheet: FP32 67 TFLOP/s)
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12}

#: the collective kinds of the JAX parser (roofline.py:40-41)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass
class CellCost:
    flops: float                 # per chip
    bytes_accessed: float        # per chip
    coll: Dict[str, int]         # per chip, by kind

    def extrapolate(self, other: "CellCost", extra_repeats: int
                    ) -> "CellCost":
        """self = 1-repeat probe, other = 2-repeat probe."""
        d_flops = other.flops - self.flops
        d_bytes = other.bytes_accessed - self.bytes_accessed
        coll = {k: int(self.coll.get(k, 0) + extra_repeats
                       * (other.coll.get(k, 0) - self.coll.get(k, 0)))
                for k in set(self.coll) | set(other.coll)}
        return CellCost(self.flops + extra_repeats * d_flops,
                        self.bytes_accessed + extra_repeats * d_bytes,
                        coll)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float           # 6ND / 2ND analytical, global
    hlo_flops_global: float
    bottleneck: str = ""
    useful_ratio: float = 0.0

    @staticmethod
    def from_cost(cost: CellCost, n_chips: int, model_flops: float
                  ) -> "RooflineTerms":
        c = cost.flops / PEAK_FLOPS
        m = cost.bytes_accessed / HBM_BW
        t = cost.coll.get("total", 0) / LINK_BW
        terms = RooflineTerms(
            compute_s=c, memory_s=m, collective_s=t,
            model_flops=model_flops,
            hlo_flops_global=cost.flops * n_chips)
        terms.bottleneck = max(
            (("compute", c), ("memory", m), ("collective", t)),
            key=lambda kv: kv[1])[0]
        terms.useful_ratio = (model_flops / terms.hlo_flops_global
                              if terms.hlo_flops_global else 0.0)
        return terms

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the roofline-limited step: the score
        §Perf optimizes.  = (model_flops/chips/peak) / step_time."""
        if self.step_time_s == 0:
            return 0.0
        n_chips = self.hlo_flops_global / max(self.compute_s * PEAK_FLOPS, 1)
        ideal = self.model_flops / max(n_chips, 1) / PEAK_FLOPS
        return ideal / self.step_time_s


# --------------------------------------------------------------------------- #
# the count of one step on meta
# --------------------------------------------------------------------------- #

_aten = torch.ops.aten
#: ops that allocate or relabel and move no data
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.resize_, _aten.set_, _aten.lift_fresh}
#: ops that read from their first argument only the elements they write
_GATHERS = {_aten.embedding, _aten.index, _aten.index_select, _aten.gather}
#: in-place ops that write into their first argument only the elements
#: they read from the others
_SCATTERS = {_aten.index_put_, _aten.index_copy_, _aten.index_add_,
             _aten.scatter_, _aten.scatter_add_}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCount(TorchDispatchMode):
    """The dispatch mode ``cost_of_step`` runs a step under: FLOPs and
    bytes of every aten op (the rules of the module's docstring), and
    the bytes held live by the storages the step makes (``live``,
    ``peak``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}   # new storage -> its bytes

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _track(self, inputs, out) -> None:
        """Count each output storage that none of the op's inputs holds
        (not a view, not written in place) as live until it is freed."""
        held = {t.untyped_storage()._cdata for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._storages:
                continue
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key).atexit = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = _tensors((args, kwargs))
        if not any(t.is_meta for t in inputs + _tensors(out)):
            return out      # the host's (a mesh's coordinates): not counted
        packet = func.overloadpacket
        if packet in self._formulas:
            # ``mm``/``bmm``'s ``out_dtype`` overload: its formula reads the
            # operands' shapes only
            operands = args[:2] if func._overloadname == "dtype" else args
            self.flops += int(self._formulas[packet](*operands, **kwargs,
                                                     out_val=out))
        if not func.is_view and packet not in _NO_TRAFFIC:
            outs = _tensors(out)
            if packet in _GATHERS:
                moved = sum(_nbytes(t) for t in inputs[1:]) \
                    + 2 * sum(_nbytes(t) for t in outs)
            elif packet in _SCATTERS:
                moved = 2 * sum(_nbytes(t) for t in inputs[1:])
            else:
                moved = sum(_nbytes(t) for t in inputs + outs)
            self.bytes += moved
        self._track(inputs, out)
        return out


def cost_of_step(fn, *args, memory=None) -> CellCost:
    """``fn(*args)`` run once on ``meta`` tensors and counted
    (the counterpart of ``cost_from_compiled``): the FLOPs, the bytes
    moved and the collectives' operand bytes by kind of one rank's step
    (the module's docstring).

    ``memory``, a dict, receives what the step holds: ``peak_bytes``, the
    most bytes live at once in storages the step made; ``output_bytes``,
    the bytes of its outputs' distinct storages; ``output_new_bytes``,
    those the step made (not an argument's, updated in place); and the
    kernels' calls by name (``kernel_calls``)."""
    from ..kernels import cost as kernel_cost
    from ..models import sharding
    before = dict(sharding.COLLECTIVE_BYTES)
    count = StepCount()
    with kernel_cost.counting() as kernels, count:
        out = fn(*args)
    coll = {k: sharding.COLLECTIVE_BYTES[k] - before[k]
            for k in COLLECTIVE_KINDS}
    coll["total"] = sum(coll.values())
    if memory is not None:
        seen = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
        memory.update(
            peak_bytes=count.peak, output_bytes=sum(seen.values()),
            output_new_bytes=sum(n for k, n in seen.items()
                                 if k in count._storages),
            kernel_calls=dict(kernels.calls))
    return CellCost(count.flops + kernels.flops,
                    count.bytes + kernels.bytes, coll)


def model_flops_for(cfg, shape) -> float:
    """Analytical useful FLOPs for the cell (6ND train, 2ND inference;
    MoE counts active experts only; + attention quadratic term)."""
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention score/value FLOPs
    hd, nq = cfg.resolved_head_dim, cfg.n_heads
    kinds = cfg.layer_kinds
    for k in kinds:
        if k == "global":
            if shape.kind == "decode":
                flops += mult / 2 * 2 * 2 * shape.global_batch * nq * hd \
                    * shape.seq_len
            else:
                flops += mult / 2 * 2 * 2 * tokens * nq * hd \
                    * shape.seq_len / 2
        elif k == "local":
            w = min(cfg.local_window, shape.seq_len)
            if shape.kind == "decode":
                flops += mult / 2 * 2 * 2 * shape.global_batch * nq * hd * w
            else:
                flops += mult / 2 * 2 * 2 * tokens * nq * hd * w
    return flops

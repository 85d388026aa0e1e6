"""Checkpoints with atomic commits, async writes, retention and restore onto
any device (counterpart of ``repro.checkpoint.manager``).

The JAX package's on-disk format, so either package restores what the
other saved: ``<dir>/step_<n:08d>/`` holds one ``.npy`` per leaf of a
nested dict/list/tuple of tensors, named by its path (``a__b__c.npy``),
and ``manifest.json`` (``step``, the caller's ``metadata``, and each
leaf's file, shape and dtype name).  A bf16 leaf is written as its raw
bits (``uint16``) under the dtype name ``"bfloat16"`` and read back
through ``int16`` as ``torch.bfloat16``: no ``ml_dtypes`` is needed on
either way.  A step is written into ``step_<n>.tmp``, gets a
``_COMMITTED`` sentinel and is renamed into place, so a save cut midway
is invisible to ``steps`` and ``latest_step``; the last ``keep`` steps are
kept.

``save`` copies every leaf to host memory before it returns (the port's
train step then updates the parameters and the AdamW moments in place);
only the files are written in the background.  ``timings`` records each
save's step, its snapshot's seconds (the caller waits for it) and its
write's (read them after ``wait``).  ``restore`` returns new
tensors on the device asked for, the counterpart of the JAX package's
restore onto new shardings at one device; ``copy_into`` writes a restored
tree into live tensors (a model's parameters, an AdamW state) in place.

A planned state (a train plan's pieces, ``Model(cfg, plan=...)``) is saved
whole and restored onto any plan, the JAX package's elastic restore:
``save(..., specs=, plan=)`` gathers each leaf whole by its spec
(``training.train_lib.train_state_specs`` gives a train state's) on the
main thread, leaf by leaf, and rank 0 alone copies it to host memory and
writes the files, the manifest, the sentinel and the rename; the files are
those of an unplanned save of the whole state.  ``restore(..., specs=,
plan=)`` reads the whole leaves and gives each rank its piece under that
plan (``shard_tensor``), on a mesh other than the saving one or, with no
plan, the whole.  Under a plan every rank calls ``save``, ``restore`` and
``latest_step`` together: the gathers and rank 0's answers are collectives.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import COLLECTIVES, _axes, mesh_sizes, shard_tensor

_NATIVE = set("bool int8 int16 int32 int64 uint8 uint16 uint32 uint64 "
              "float16 float32 float64".split())


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten_into(skeleton, flat, prefix=()):
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in skeleton.items()}
    if isinstance(skeleton, tuple):
        return tuple(_unflatten_into(v, flat, prefix + (str(i),))
                     for i, v in enumerate(skeleton))
    if isinstance(skeleton, list):
        return [_unflatten_into(v, flat, prefix + (str(i),))
                for i, v in enumerate(skeleton)]
    return flat["/".join(prefix)]


def _leaf_specs(tree, specs, prefix=()):
    """{path: spec} of each leaf of ``tree``, its spec at the same path of
    ``specs`` (a spec is a tuple, so the walk follows ``tree``)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaf_specs(tree[k], specs[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_specs(v, specs[i], prefix + (str(i),)))
        return out
    return {"/".join(prefix): specs}


def _planned(plan) -> bool:
    return plan is not None and plan.mesh is not None


def _from_rank0(fn):
    """``fn()`` of rank 0 on every rank (a broadcast over the default
    group)."""
    import torch.distributed as dist
    box = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@torch.no_grad()
def _whole_on_host(t: torch.Tensor, spec, plan, writer: bool
                   ) -> Optional[torch.Tensor]:
    """The whole tensor of which ``t`` is this rank's piece under ``spec``,
    a contiguous host copy on the ``writer`` (None on the other ranks).

    The ranks whose place on every axis the spec leaves whole is rank 0's
    gather the pieces over the group of the axes it cuts (in the mesh's
    order: one flattened group, made on every rank) into one buffer of the
    whole's size, counted as ``weight_gather``; the other ranks take no
    part.  The writer copies the buffer to the host and lays the pieces
    out there, so a rank's device holds at most one whole leaf beyond its
    state."""
    import torch.distributed as dist
    t = t.detach()
    sizes = mesh_sizes(plan.mesh)
    cut = {a for e in spec if e is not None for a in _axes(e)}
    axes: Tuple[str, ...] = tuple(a for a in plan.mesh.mesh_dim_names
                                  if a in cut)
    if not axes:
        return t.to("cpu", copy=True) if writer else None
    group = plan.group(axes)
    if any(plan.mesh.get_local_rank(a) for a in sizes if a not in cut):
        return None
    piece = t.contiguous()
    k = math.prod(sizes[a] for a in axes)
    buf = torch.empty((k * piece.shape[0],) + tuple(piece.shape[1:]),
                      dtype=piece.dtype, device=piece.device)
    dist.all_gather_into_tensor(buf, piece, group=group)
    COLLECTIVES["weight_gather"] += 1
    if not writer:
        return None
    whole_shape = tuple(n * (1 if e is None else
                             math.prod(sizes[a] for a in _axes(e)))
                        for n, e in zip(piece.shape, spec))
    dims = [d for d, e in enumerate(spec) if e is not None]
    if k == 1 or (dims == [0] and _axes(spec[0]) == axes):
        # the group's order is the whole's: the buffer is the whole
        return buf.to("cpu", copy=True).view(whole_shape)
    pieces = buf.to("cpu").view((k,) + tuple(piece.shape))
    del buf
    whole = torch.empty(whole_shape, dtype=piece.dtype)
    for g in range(k):
        index, rest = {}, g
        for a in reversed(axes):        # g is mixed radix over ``axes``
            index[a], rest = rest % sizes[a], rest // sizes[a]
        view = whole
        for d in dims:
            c = 0
            for a in _axes(spec[d]):
                c = c * sizes[a] + index[a]
            view = view.narrow(d, c * piece.shape[d], piece.shape[d])
        view.copy_(pieces[g])
    return whole


def _host_array(t: torch.Tensor):
    """A host tensor -> (numpy array to write, the leaf's dtype name)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded array and its dtype name -> a CPU tensor, bit for bit."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype not in _NATIVE:
        raise ValueError(f"checkpoint leaf of dtype {dtype}: only bfloat16 "
                         f"and numpy's native dtypes are read")
    return torch.from_numpy(arr)


@torch.no_grad()
def copy_into(dst, src) -> None:
    """Copy each leaf of ``src`` into the tensor at the same path of
    ``dst`` in place (across devices; dtypes must agree), so that whatever
    holds ``dst``'s tensors, a model or an AdamW state, sees the values."""
    flat = _flatten(src)
    for key, t in _flatten(dst).items():
        s = flat[key]
        if s.dtype != t.dtype or s.shape != t.shape:
            raise ValueError(f"{key}: {s.dtype} {tuple(s.shape)} into "
                             f"{t.dtype} {tuple(t.shape)}")
        t.copy_(s)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.timings: List[Dict[str, float]] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        self.wait()  # join any in-flight async write before listing
        out = []
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if name.startswith("step_") and \
                    os.path.exists(os.path.join(path, "_COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self, plan=None) -> Optional[int]:
        """The newest committed step; with a plan rank 0's, on every rank
        (rank 0 joins its write first; no other rank has one to join)."""
        if _planned(plan):
            return _from_rank0(self.latest_step)
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------ #
    def wait(self) -> None:
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
            self._thread = None

    def save(self, step: int, tree: Dict[str, Any],
             metadata: Optional[dict] = None, specs=None,
             plan=None) -> None:
        """Snapshot every tensor of ``tree`` to host memory now (a copy,
        also of a CPU tensor), then write the step, in the background with
        ``async_save``.  With a plan ``tree`` holds the rank's pieces and
        ``specs`` (a tree of specs in ``tree``'s structure) their specs:
        every rank calls, each leaf is gathered whole in turn
        (``_whole_on_host``), and rank 0 alone writes."""
        t0 = time.perf_counter()
        flat = _flatten(tree)
        if _planned(plan):
            import torch.distributed as dist
            writer = dist.get_rank() == 0
            spec_of = _leaf_specs(tree, specs)
            host = {}
            for k, v in flat.items():
                whole = _whole_on_host(v, spec_of[k], plan, writer)
                if writer:
                    host[k] = _host_array(whole)
        else:
            writer = True
            host = {k: _host_array(v.detach().to("cpu", copy=True))
                    for k, v in flat.items()}
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
        if not writer:
            return
        self.wait()

        def _write():
            t0 = time.perf_counter()
            tmp = self._step_dir(step) + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "metadata": metadata or {},
                        "leaves": {}}
            for k, (arr, logical) in host.items():
                fname = k.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][k] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": logical}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()
            timing["write_s"] = time.perf_counter() - t0

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def restore(self, skeleton: Dict[str, Any], step: Optional[int] = None,
                device=None, specs=None, plan=None) -> Dict[str, Any]:
        """The step (the latest committed one by default) in ``skeleton``'s
        structure, as new tensors on ``device`` (the CPU by default).  With
        a plan each leaf is this rank's piece of the whole under its spec
        in ``specs`` (``shard_tensor``), whatever mesh saved it, and the
        step is rank 0's, read once its write is joined."""
        self.wait()
        if _planned(plan):
            step = _from_rank0(
                lambda: step if step is not None else self.latest_step())
        else:
            step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
        spec_of = _leaf_specs(skeleton, specs) if _planned(plan) else {}
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for k, info in manifest["leaves"].items():
            t = _tensor(np.load(os.path.join(d, info["file"])), info["dtype"])
            if k in spec_of:
                t = shard_tensor(t, spec_of[k], plan)
            flat[k] = t if device is None else t.to(device)
        return _unflatten_into(skeleton, flat)

    def metadata(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)["metadata"]

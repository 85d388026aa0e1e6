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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

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

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------ #
    def wait(self) -> None:
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
            self._thread = None

    def save(self, step: int, tree: Dict[str, Any],
             metadata: Optional[dict] = None) -> None:
        """Snapshot every tensor of ``tree`` to host memory now (a copy,
        also of a CPU tensor), then write the step, in the background with
        ``async_save``."""
        t0 = time.perf_counter()
        flat = _flatten(tree)
        host = {k: _host_array(v.detach().to("cpu", copy=True))
                for k, v in flat.items()}
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
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
                device=None) -> Dict[str, Any]:
        """The step (the latest committed one by default) in ``skeleton``'s
        structure, as new tensors on ``device`` (the CPU by default)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for k, info in manifest["leaves"].items():
            t = _tensor(np.load(os.path.join(d, info["file"])), info["dtype"])
            flat[k] = t if device is None else t.to(device)
        return _unflatten_into(skeleton, flat)

    def metadata(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)["metadata"]

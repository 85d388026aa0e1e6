"""Meshes of the port (counterpart of ``repro.launch.mesh``) and the process
groups under them.

All constructors are functions: importing this module starts no process
group and touches no device.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller starts first: ``init_cpu_group`` (gloo on a
``FileStore``, one process a rank: the CPU tests) or ``init_cuda_group``
(NCCL at world size 1 on an in-process ``HashStore``: one card, no store
socket).  The axis names and shapes are the JAX package's.  A mesh lies on
CUDA unless the caller asks for the CPU (``device="cpu"``); without CUDA
that raises, it never falls back to the CPU.

``MeshShape`` holds a mesh's names and sizes only, for plans whose specs
are read without processes (the JAX package's ``AbstractMesh``).
``meta_mesh`` is one rank of a mesh of any size in this one process, for
a model on the ``meta`` device: the dry-run's stand-in for XLA's
partitioning of a cell onto the production mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Tuple

import torch

from ..device import resolve_device


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, as a ``DeviceMesh`` gives them."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def init_cpu_group(rank: int, world_size: int, store_path: str) -> None:
    """Start the default process group of one of ``world_size`` CPU ranks:
    gloo, on a ``FileStore`` at ``store_path`` (a file that every rank
    names, absent or empty before the first rank starts)."""
    import torch.distributed as dist
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)


def init_cuda_group() -> None:
    """Start the default process group of one process on card 0: NCCL at
    world size 1, its store an in-process ``HashStore``."""
    import torch.distributed as dist
    resolve_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))


def _mk(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's sizes and names."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The JAX package's production mesh: 16x16 (data, model), or 2x16x16
    (pod, data, model) multi-pod."""
    return _mk(*production_shape(multi_pod), device)


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 0, device=None):
    """Small mesh for unit tests: (data, model), or (pod, data, model)."""
    if pod:
        return _mk((pod, data, model), ("pod", "data", "model"), device)
    return _mk((data, model), ("data", "model"), device)


def make_single_device_mesh(device=None):
    return _mk((1, 1), ("data", "model"), device)


@contextlib.contextmanager
def meta_mesh(shape: MeshShape):
    """Rank 0 of a mesh of ``shape`` in this process: the default process
    group is PyTorch's fake backend at the mesh's size (it forms groups
    and answers their sizes and ranks; ``sharding``'s collectives ask it
    nothing else on ``meta`` tensors), the ``DeviceMesh`` is built over
    it and yielded, and the group is destroyed on exit, whatever happens.
    A model built under a plan on this mesh with ``device="meta"`` is rank
    0's: its pieces and its collectives, nothing allocated.  Raises if a
    default process group is already running.

    The backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg``, a private module of
    PyTorch (its ``FakeStore`` is the store)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("meta_mesh: a default process group is already "
                           "running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape.shape))
    try:
        yield _mk(*shape, "cpu")
    finally:
        dist.destroy_process_group()

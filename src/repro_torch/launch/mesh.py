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
"""
from __future__ import annotations

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


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The JAX package's production mesh: 16x16 (data, model), or 2x16x16
    (pod, data, model) multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 0, device=None):
    """Small mesh for unit tests: (data, model), or (pod, data, model)."""
    if pod:
        return _mk((pod, data, model), ("pod", "data", "model"), device)
    return _mk((data, model), ("data", "model"), device)


def make_single_device_mesh(device=None):
    return _mk((1, 1), ("data", "model"), device)

"""Device meshes over the launched ``torch.distributed`` world.

Port of ``repro.launch.mesh``.  ``make_mesh_shape`` builds a
``torch.distributed.device_mesh.DeviceMesh`` of the given shape and axis
names over the world this process was launched into, and raises when the
shape's product is not the world's size (the JAX mesh takes the visible
devices; here one process drives one device).  Without a process group
it starts a one-process world itself (a ``file://`` rendezvous in the
temporary directory), so a 1-device mesh works on one card or the CPU.
``make_production_mesh`` keeps the JAX shapes, (16, 16) as
("data", "model") and (2, 16, 16) as ("pod", "data", "model"), and so
raises on fewer than 256 (512) ranks.
"""

from __future__ import annotations

import math
import os
import tempfile
import uuid
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_mesh_shape"]


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _init_world(device_type: Optional[str] = None) -> int:
    """The launched world's size, starting a one-process group (NCCL on
    the card, gloo on the CPU) when none exists.  A launcher that sets
    ``MASTER_ADDR`` (``torchrun``) gets its env rendezvous instead."""
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if _device_type(device_type) == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        path = os.path.join(tempfile.gettempdir(),
                            f"repro_torch_world_{uuid.uuid4().hex}")
        dist.init_process_group(backend, init_method=f"file://{path}",
                                world_size=1, rank=0)
    return dist.get_world_size()


def make_mesh_shape(shape: Sequence[int], axes: Sequence[str],
                    device_type: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over the launched world."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"launched world has {world}")
    _init_world(device_type)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods x
    256 as (pod=2, data=16, model=16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes, device_type)

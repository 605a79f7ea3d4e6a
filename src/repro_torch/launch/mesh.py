"""Device meshes over the launched ``torch.distributed`` world, or over a
fake world of the mesh's size.

Port of ``repro.launch.mesh``.  ``make_mesh_shape`` builds a
``torch.distributed.device_mesh.DeviceMesh`` of the given shape and axis
names over the first ``prod(shape)`` ranks of the world this process
was launched into (one process drives one device; a rank past the mesh
has no coordinate on it, as after an elastic re-mesh to fewer ranks),
and raises when the world has fewer ranks.  Without a process group it
starts a one-process world itself (NCCL on the card, gloo on the CPU; a
``file://`` rendezvous in the temporary directory), so a 1-device mesh
works on one card.  ``make_production_mesh`` keeps the JAX shapes,
(16, 16) as ("data", "model") and (2, 16, 16) as ("pod", "data",
"model").

The device follows ``kernels.backend.resolve_device``: ``None`` is the
card, and raises without one; ``"cpu"`` (gloo) and ``"meta"`` only when
asked for.  ``fake=True`` is the counterpart of the JAX dry run's forced
host devices: a fake process group of the mesh's size (no data moves,
every collective returns at once), this process its rank 0, so one
process can count or run one rank of a 256- or 512-card mesh; it
replaces any process group this process has.
"""

from __future__ import annotations

import math
import os
import tempfile
import uuid
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import resolve_device

__all__ = ["make_production_mesh", "make_mesh_shape"]

Device = Optional[Union[str, torch.device]]


def _init_world(device_type: str) -> int:
    """The launched world's size, starting a one-process group (NCCL on
    the card, gloo otherwise) when none exists.  A launcher that sets
    ``MASTER_ADDR`` (``torchrun``) gets its env rendezvous instead."""
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        path = os.path.join(tempfile.gettempdir(),
                            f"repro_torch_world_{uuid.uuid4().hex}")
        dist.init_process_group(backend, init_method=f"file://{path}",
                                world_size=1, rank=0)
    return dist.get_world_size()


def _fake_world(size: int) -> None:
    """Replace this process's process group by a fake one of ``size``
    ranks, this process being rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def make_mesh_shape(shape: Sequence[int], axes: Sequence[str],
                    device_type: Device = None, fake: bool = False):
    """A mesh of ``shape`` named ``axes`` over the launched world (or,
    with ``fake``, over a fake world of exactly its size)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    dev = resolve_device(device_type)
    kind = "cpu" if dev.type == "meta" else dev.type
    n = math.prod(shape)
    if fake:
        _fake_world(n)
    else:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n > world:
            raise ValueError(f"mesh {shape} needs {n} ranks; the launched "
                             f"world has {world}")
        _init_world(kind)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Device = None, fake: bool = False):
    """Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods x
    256 as (pod=2, data=16, model=16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes, device_type, fake)

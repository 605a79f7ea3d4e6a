"""Logical-axis sharding over a ``DeviceMesh``: one rule table,
mesh-shape-aware lowering, and the local shards a rank keeps.

Port of ``repro.dist.sharding``.  Model code names *logical* axes
("batch", "mlp", "fsdp", ...); the mesh names *physical* axes ("pod",
"data", "model").  ``LOGICAL_RULES`` maps the former to candidate lists
of the latter, and the lowering filters them against the mesh present.
A spec is a tuple with one entry per dimension: ``None``, a mesh-axis
name, or a tuple of names (the JAX ``PartitionSpec``'s entries), so the
two packages' specs compare directly.  Lowering one spec uses a mesh
axis at most once; ``guarded_spec`` also drops trailing candidates
until the dimension divides their product.

The port keeps each leaf as this rank's *local shard*, a plain tensor:
``NamedSharding.shard`` cuts it from the whole tensor (dimension ``d``
split into ``prod(sizes)`` equal blocks over the axes named for ``d``,
row-major in the order named), and a rank holds the block of its mesh
coordinate.  Dimensions a spec leaves ``None`` are replicated over the
other axes.  The collectives that move shards between layouts are
explicit (``dist.tensor_parallel``), so every hand-written kernel gets a
plain local tensor.

``mesh_scope`` sets this thread's ambient mesh (``current_mesh``); the
model code does not read it: a model built on a mesh passes its plan to
every entry point (``models.model``).  ``constrain`` is the identity
without a scope, as in JAX; under one, it checks the tensor's rank
against the named axes and returns it: the port's mesh code keeps each
activation in the layout the JAX constraint names by construction (rows
over the batch axes, the rest replicated, or logits over ``vocab``), and
the collectives GSPMD would insert there are explicit in
``dist.tensor_parallel``.

``shard_mesh`` is the key-space-sharded index's placement (DESIGN.md
§13): the port needs only the device of each shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.backend import resolve_device

__all__ = [
    "LOGICAL_RULES", "logical_to_spec", "guarded_spec", "constrain",
    "mesh_scope", "current_mesh", "named_sharding", "param_sharding",
    "NamedSharding", "place", "axis_sizes", "spec_axes", "is_axes_leaf",
    "shard_mesh",
]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# logical axis -> ordered candidate mesh axes (filtered by mesh presence)
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    # activation batch: sharded over every data-parallel axis present
    "batch": ("pod", "data"),
    # decode-time batch that may additionally fold over the model axis
    "batch_model": ("pod", "data", "model"),
    # fully-sharded parameter dim (zero-style) over the data axis
    "fsdp": ("data",),
    # tensor-parallel dims
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "d_inner": ("model",),
    # pipeline stages
    "stage": ("pipe",),
    # key-space shard of the learned-index serving layer (DESIGN.md §13)
    "shard": ("shard",),
    # replicated-by-default dims (named for documentation value)
    "embed": (),
    "seq": (),
    "kv_seq": (),
    "conv": (),
    "h": (),
    "wo": (),
}


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis sizes as a plain dict: a ``DeviceMesh`` (its
    ``mesh_dim_names`` and shape), or a stand-in whose ``shape`` is
    already such a dict (the JAX tests' fakes)."""
    if isinstance(mesh.shape, dict):
        return {k: int(v) for k, v in mesh.shape.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _lower(axes: Sequence[Optional[str]], mesh,
           shape: Optional[Sequence[int]] = None) -> Spec:
    sizes = axis_sizes(mesh)
    used: set = set()
    parts: List[Any] = []
    for i, name in enumerate(axes):
        if name is None:
            parts.append(None)
            continue
        cands = [a for a in LOGICAL_RULES.get(name, ())
                 if a in sizes and a not in used]
        if shape is not None:
            # drop trailing candidates until the dim divides their product
            while cands and shape[i] % math.prod(sizes[a] for a in cands):
                cands = cands[:-1]
        if not cands:
            parts.append(None)
            continue
        used.update(cands)
        parts.append(cands[0] if len(cands) == 1 else tuple(cands))
    return tuple(parts)


def logical_to_spec(axes: Sequence[Optional[str]], mesh) -> Spec:
    """Lower logical axis names to a spec for ``mesh``."""
    return _lower(axes, mesh)


def guarded_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh) -> Spec:
    """``logical_to_spec`` that also drops axes ``shape`` cannot divide."""
    return _lower(axes, mesh, shape=shape)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_axes_leaf(v: Any) -> bool:
    return isinstance(v, tuple) and all(
        a is None or isinstance(a, str) for a in v)


# --------------------------------------------------------------- mesh scope
_SCOPE = threading.local()


def _stack() -> list:
    if not hasattr(_SCOPE, "meshes"):
        _SCOPE.meshes = []
    return _SCOPE.meshes


@contextlib.contextmanager
def mesh_scope(mesh):
    """This thread's ambient mesh for ``constrain`` (the JAX name; the
    model takes its mesh explicitly, ``models.model``); ``None`` is a
    no-op scope."""
    if mesh is None:
        yield None
        return
    _stack().append(mesh)
    try:
        yield mesh
    finally:
        _stack().pop()


def current_mesh():
    st = _stack()
    return st[-1] if st else None


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Sharding constraint by logical axis names; identity without a
    mesh, and a check of the rank under one (see the module
    docstring)."""
    if current_mesh() is not None and x.dim() != len(axes):
        raise ValueError(f"constrain: a {x.dim()}-d tensor against "
                         f"{len(axes)} axes {axes}")
    return x


# ----------------------------------------------------------------- shardings
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each rank's block of a tensor lies.
    ``spec`` may be shorter than a tensor's rank (the rest replicated),
    as a ``PartitionSpec`` may."""
    mesh: Any
    spec: Spec

    def _entries(self, ndim: int):
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def coordinate(self) -> Dict[str, int]:
        """This rank's coordinate on every mesh axis (zeros on a rank
        outside the mesh)."""
        coord = self.mesh.get_coordinate()
        names = self.mesh.mesh_dim_names
        if coord is None:
            return {a: 0 for a in names}
        return dict(zip(names, coord))

    def splits(self, ndim: int) -> List[Tuple[int, int]]:
        """(ways, this rank's block) of every dimension."""
        sizes = axis_sizes(self.mesh)
        coord = self.coordinate()
        out = []
        for entry in self._entries(ndim):
            ways, idx = 1, 0
            for a in spec_axes(entry):
                ways *= sizes[a]
                idx = idx * sizes[a] + coord[a]
            out.append((ways, idx))
        return out

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for n, (ways, _i) in zip(shape, self.splits(len(shape))):
            if n % ways:
                raise ValueError(f"dimension {n} does not split {ways} "
                                 f"ways under {self.spec}")
            out.append(n // ways)
        return tuple(out)

    def whole_shape(self, local: Sequence[int]) -> Tuple[int, ...]:
        """The whole tensor's shape of which ``local`` is a block."""
        return tuple(n * ways for n, (ways, _i)
                     in zip(local, self.splits(len(local))))

    def offsets(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The global index of this rank's block's first element."""
        return tuple(i * (n // ways) for n, (ways, i)
                     in zip(shape, self.splits(len(shape))))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``: a copy of its own
        (a contiguous slice, say a block of a one-layer stack's second
        axis, would otherwise keep the whole tensor's storage alive), or
        ``x`` itself where nothing is split."""
        loc = self.local_shape(x.shape)
        if tuple(loc) == tuple(x.shape):
            return x
        idx = tuple(slice(o, o + n) for o, n in
                    zip(self.offsets(x.shape), loc))
        return x[idx].clone(memory_format=torch.contiguous_format)

    def replicated_over(self, ndim: int) -> Tuple[str, ...]:
        """The mesh axes no dimension is split over."""
        used = {a for e in self._entries(ndim) for a in spec_axes(e)}
        return tuple(a for a in self.mesh.mesh_dim_names if a not in used)


def named_sharding(mesh, axes: Optional[Sequence[Optional[str]]] = None
                   ) -> NamedSharding:
    """NamedSharding from logical axes (replicated when ``axes`` is
    None)."""
    return NamedSharding(mesh, () if axes is None
                         else logical_to_spec(axes, mesh))


def _map_specs(fn, specs, *trees):
    if is_axes_leaf(specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    raise TypeError(f"not a spec tree node: {specs!r}")


def param_sharding(specs, mesh, shapes=None):
    """Logical-axes spec tree (``model.param_specs()``) -> a tree of
    ``NamedSharding``.  With ``shapes`` (a tree of tensors or shapes
    alike) each leaf's spec is ``guarded_spec`` on its shape, as the JAX
    dry run places every leaf; without, ``logical_to_spec``."""
    if shapes is None:
        return _map_specs(
            lambda axes: NamedSharding(mesh, logical_to_spec(axes, mesh)),
            specs)
    return _map_specs(
        lambda axes, x: NamedSharding(mesh, guarded_spec(
            tuple(x.shape) if hasattr(x, "shape") else tuple(x), axes,
            mesh)), specs, shapes)


def place(tree, shardings):
    """Each leaf's local block (``NamedSharding.shard``) of a tree of
    whole tensors (dicts, lists and tuples, NamedTuples among them),
    ``shardings`` a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(t, s) for t, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(t, s) for t, s in zip(tree, shardings))
    return shardings.shard(tree)


def shard_mesh(n_shards: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> List[torch.device]:
    """One device per shard: shard ``s`` lives on ``cuda:(s mod
    device_count)``, so shards wrap round-robin onto the visible cards
    when there are fewer cards than shards (as the JAX package wraps its
    devices); ``device="cpu"`` puts every shard on the CPU.  ``None`` or
    ``"cuda"`` without a card raises, as every entry point of the port
    does; an explicit ``cuda:i`` keeps every shard on that card."""
    dev = resolve_device(device)
    n = max(int(n_shards), 1)
    if dev.type == "cpu":
        return [dev] * n
    if dev.index is not None:
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", s % count) for s in range(n)]

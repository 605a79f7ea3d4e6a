"""Collectives over a mesh's named axes, with their gradients, and the
count of the bytes they move.

The port's mesh code keeps local shards (``dist.sharding``) and moves
them explicitly, as Megatron-LM and ZeRO do; these are the moves:

* ``copy_to(x, axis)``: the identity forward, a sum over ``axis`` in the
  backward (a replicated activation entering a tensor-parallel region);
* ``reduce_from(x, axis)``: a sum over ``axis`` forward, the identity
  backward (row-parallel partial sums leaving it);
* ``gather(x, dim, axes, grad)``: the whole of ``dim`` from its blocks
  over ``axes``; backward ``"reduce_scatter"`` sums each block's
  gradient over the axes (an ``fsdp`` weight: every data rank saw other
  rows) or ``"slice"`` keeps this rank's block (every rank computed the
  same gradient);
* ``scatter(x, dim, axis)``: this rank's block of ``dim`` of a tensor
  every rank over ``axis`` holds whole (a slice, nothing moved); the
  backward gathers the blocks' gradients over the axis (``models.ssm``
  cuts a data rank's rows over ``model`` under ``batch_tp``, and
  ``gather(..., grad="slice")`` puts them back);
* ``exchange(x, dim, send, recv, axis)``: the all-to-all along one
  dimension, even or not (each rank sends its own sizes to each other
  rank), as ``models.ssm`` moves a flat ``d_inner`` block; its gradient
  sends the pieces back;
* ``all_reduce``, ``all_gather``: outside autograd.

A fake process group (``launch.mesh``) may leave a receive buffer as it
was, so a gather whose values index memory (``models.moe``'s expert
counts) asks for a zero-filled one (``all_gather(..., zeros=True)``);
every other receive buffer is left unfilled, as a real group overwrites
it whole.

An axis of size 1 moves nothing and calls nothing, so a (1, 1) mesh runs
exactly the ops of the meshless path.  Every call that moves data adds
its per-rank wire bytes to ``COUNTS`` under the JAX ``collective_bytes``
rule (``repro.utils.hlo``): all-reduce ``2 (s-1)/s`` of its bytes,
all-gather ``(s-1)/s`` of its result, reduce-scatter ``s-1`` times its
result, all-to-all the bytes it sends to the other ranks (``(s-1)/s`` of
its result where the pieces are even); by kind (``"all-reduce"``,
``"all-gather"``, ``"reduce-scatter"``, ``"all-to-all"``), by
``"<kind>@<axis>"``, and ``n_<kind>``.  On
``meta`` tensors (the dry run) nothing is called, only counted; under a
fake process group the calls move nothing.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["axis_size", "axis_index", "copy_to", "reduce_from", "gather",
           "scatter", "exchange", "materialize", "all_reduce", "all_gather",
           "gather_tree", "collective_counts",
           "BATCH_AXES", "COUNTS"]

# the mesh axes an activation's rows split over (``LOGICAL_RULES["batch"]``)
BATCH_AXES = ("pod", "data")

COUNTS: Dict[str, float] = collections.defaultdict(float)
_LOCK = threading.Lock()
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axis: str) -> int:
    if axis not in mesh.mesh_dim_names:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 where the mesh lacks it)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    coord = mesh.get_coordinate()
    return 0 if coord is None else int(
        coord[mesh.mesh_dim_names.index(axis)])


def _count(kind: str, axis: str, wire: float) -> None:
    with _LOCK:
        COUNTS[kind] += wire
        COUNTS[f"{kind}@{axis}"] += wire
        COUNTS[f"n_{kind}"] += 1
        COUNTS["total"] += wire


def collective_counts(reset: bool = False) -> Dict[str, float]:
    """The bytes counted since the last reset (see the module
    docstring)."""
    with _LOCK:
        out = dict(COUNTS)
        if reset:
            COUNTS.clear()
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _group(mesh, axis):
    return mesh.get_group(axis)


def _all_reduce(x: torch.Tensor, mesh, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over ``axis``, in place."""
    s = axis_size(mesh, axis)
    if s == 1:
        return x
    _count("all-reduce", axis, 2.0 * (s - 1) / s * _nbytes(x))
    if x.device.type != "meta":
        dist.all_reduce(x, op=op, group=_group(mesh, axis))
    return x


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int,
                zeros: bool = False) -> torch.Tensor:
    """The blocks of ``x`` over ``axis`` concatenated along ``dim``
    (received into a zero-filled buffer where ``zeros``)."""
    s = axis_size(mesh, axis)
    if s == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    new = torch.zeros if zeros else torch.empty
    out = new((s * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype,
              device=x.device)
    _count("all-gather", axis, (s - 1) / s * _nbytes(out))
    if x.device.type != "meta":
        _gather_into(out, src, group=_group(mesh, axis))
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                    ) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over ``axis``."""
    s = axis_size(mesh, axis)
    if s == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // s,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("reduce-scatter", axis, float(s - 1) * _nbytes(out))
    if x.device.type != "meta":
        if dist.get_backend(_group(mesh, axis)) == "gloo":
            # gloo has no reduce-scatter: a sum, then this rank's block
            dist.all_reduce(src, group=_group(mesh, axis))
            i = axis_index(mesh, axis)
            out.copy_(src[i * out.shape[0]:(i + 1) * out.shape[0]])
        else:
            _scatter_into(out, src, group=_group(mesh, axis))
    return out.movedim(0, dim)


def _exchange(x: torch.Tensor, mesh, axis: str, dim: int,
              send: Sequence[int], recv: Sequence[int]) -> torch.Tensor:
    """``x`` cut along ``dim`` into consecutive pieces of ``send[j]``
    rows, piece ``j`` sent to rank ``j`` of ``axis``; the ``recv[i]``
    rows from rank ``i`` concatenated along ``dim`` in rank order."""
    me = axis_index(mesh, axis)
    src = x.movedim(dim, 0).contiguous()
    row = _nbytes(src) // max(src.shape[0], 1)
    out = torch.empty((sum(recv),) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count("all-to-all", axis,
           float(row * (sum(send) - send[me])))
    if x.device.type != "meta":
        dist.all_to_all_single(out, src, list(recv), list(send),
                               group=_group(mesh, axis))
    return out.movedim(0, dim)


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    s = axis_size(mesh, axis)
    if s == 1:
        return x
    n = x.shape[dim] // s
    return x.narrow(dim, axis_index(mesh, axis) * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.mesh, ctx.axes, ctx.dim, ctx.grad = mesh, axes, dim, grad
        # blocks are row-major in the order of ``axes``: gather the last
        # axis first, so each outer block holds its inner blocks in order
        for a in reversed(axes):
            x = _all_gather(x, mesh, a, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = (_reduce_scatter(g, ctx.mesh, a, ctx.dim)
                 if ctx.grad == "reduce_scatter"
                 else _block(g, ctx.mesh, a, ctx.dim))
        return g, None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = mesh, axis, dim
        return _block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _all_gather(g, mesh, axis, dim), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, send, recv):
        ctx.args = mesh, axis, dim, send, recv
        return _exchange(x, mesh, axis, dim, send, recv)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, send, recv = ctx.args
        return (_exchange(g, mesh, axis, dim, recv, send), None, None, None,
                None, None)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh, axes: Axes, dim: int,
           grad: str = "reduce_scatter") -> torch.Tensor:
    """The whole of dimension ``dim`` from its blocks over ``axes``
    (row-major in their order, as ``NamedSharding`` cuts them)."""
    axes = tuple(a for a in _axes(axes) if axis_size(mesh, a) > 1)
    if not axes:
        return x
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"unknown gather gradient {grad!r}")
    return _Gather.apply(x, mesh, axes, dim, grad)


def scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` over ``axis`` (``dim`` must divide
    by the axis's size); its gradient is gathered over ``axis``."""
    s = axis_size(mesh, axis)
    if s == 1:
        return x
    if x.shape[dim] % s:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axis} of {s}")
    return _Scatter.apply(x, mesh, axis, dim)


def exchange(x: torch.Tensor, dim: int, send: Sequence[int],
             recv: Sequence[int], mesh, axis: str) -> torch.Tensor:
    """The uneven all-to-all along ``dim``: consecutive pieces of
    ``send[j]`` rows to rank ``j`` of ``axis``, the ``recv[i]`` rows of
    rank ``i`` concatenated in rank order (every rank's ``send`` must
    match the ``recv`` of the ranks it sends to).  Its gradient sends
    the pieces back."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Exchange.apply(x, mesh, axis, dim, tuple(send), tuple(recv))


def materialize(w: torch.Tensor, spec, mesh, keep: Sequence[str] = ()
                ) -> torch.Tensor:
    """The weight a rank computes with, from its local shard placed by
    ``spec``: every dimension's blocks gathered except over the axes in
    ``keep`` (a tensor-parallel split).  A block over a batch axis
    (``fsdp``) sends its gradient back summed over that axis (every rank
    there saw other rows); one over another axis keeps the rank's block
    of a gradient every rank computed alike."""
    from repro_torch.dist.sharding import spec_axes

    for d, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):
            if a not in keep:
                w = gather(w, mesh, a, d, "reduce_scatter"
                           if a in BATCH_AXES else "slice")
    return w


@torch.no_grad()
def all_reduce(x: torch.Tensor, mesh, axes: Axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over every axis of ``axes``, in place (no
    gradient)."""
    for a in _axes(axes):
        x = _all_reduce(x, mesh, a, op)
    return x


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int,
               zeros: bool = False) -> torch.Tensor:
    """The blocks of ``x`` over ``axes`` along ``dim`` (no gradient),
    received into zero-filled buffers where ``zeros``."""
    for a in reversed(_axes(axes)):
        x = _all_gather(x, mesh, a, dim, zeros)
    return x


@torch.no_grad()
def gather_tree(tree, shardings):
    """The whole tensors of a tree of local blocks (``dist.sharding.place``
    inverted; every rank of the mesh calls it), each a new tensor."""
    from repro_torch.dist.sharding import spec_axes

    if isinstance(tree, dict):
        return {k: gather_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_tree(t, s)
                            for t, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(t, s) for t, s in zip(tree, shardings))
    x = tree
    for d, e in enumerate(tuple(shardings.spec)):
        x = all_gather(x.contiguous(), shardings.mesh, spec_axes(e), d)
    return x.clone() if x is tree else x

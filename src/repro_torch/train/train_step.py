"""The train step: loss, gradients and the optimizer, with microbatching.

Port of ``repro.train.train_step``.  The gradients come from
``torch.autograd.grad`` over the leaves of the parameter tree (the JAX
tree: per-layer leaves stacked on a leading ``[n_layers, ...]`` axis),
each taken through a detached copy of the leaf so the state's tensors
never join a graph.  With ``microbatches`` m > 1 the batch splits along
its first axis into m equal slices, run one after another (activation
memory is one microbatch), and the gradients accumulate as JAX's scan
accumulates them: ``g_acc + g.astype(acc_dtype) / m`` and the loss
``l_acc + l / m``.  The optimizer applies once per step, at the
schedule's learning rate for the step before it.

The step writes the optimizer state and the parameters in place
(``make_optimizer``'s update), as the JAX trainer donates its state.

For a model built on a mesh (``build_model(..., mesh=...)``) the state's
leaves are the rank's local shards and the batch is its rows (every
array of it: ``tokens``, ``targets``, vlm ``patches``, encdec
``frames``; the microbatch cut slices each alike).  Each
``fsdp`` weight is gathered for its use and its gradient
reduce-scattered back over ``data`` inside the backward
(``tensor_parallel.materialize``); after it, every gradient is summed
over the batch axes its leaf is not split over (a replicated leaf's
gradient, and every leaf's over ``pod``), the loss and its metrics
likewise (``train_loss`` gives each rank its part of the global mean),
and the optimizer reduces over the split axes (``make_optimizer``'s
``shardings``).  The microbatch count keeps the JAX rule: at most the
rank's rows (the global batch over the data-parallel extent).  A rank's
rows are ``rank_rows``': for each microbatch i, its block of the JAX
step's global microbatch i, so the step's i-th slice of them is that
block and every microbatch groups the reference's rows (an MoE routes
each microbatch as one global set).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.train.optimizer import (AdamWConfig, make_optimizer,
                                         tree_leaves, tree_unflatten)
from repro_torch.train.schedule import ScheduleConfig, make_schedule

__all__ = ["TrainConfig", "TrainState", "make_train_step",
           "init_train_state", "loss_and_grads", "state_sharding",
           "param_shardings", "rank_rows"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: Any = dataclasses.field(default_factory=AdamWConfig)
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    microbatches: int = 1
    # gradient-accumulation dtype; bf16 halves the accumulator footprint
    accum_dtype: str = "float32"


class TrainState(NamedTuple):
    """(params, optimizer state, step): the JAX ``TrainState``, flattened
    in that order; ``step`` is an i32 scalar tensor on the parameters'
    device."""
    params: Any
    opt: Any
    step: torch.Tensor


def init_train_state(model, generator: torch.Generator,
                     tcfg: TrainConfig) -> TrainState:
    """The whole state (on a mesh too: ``state_sharding`` places it)."""
    params = model.init(generator)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    dev = tree_leaves(params)[0].device
    return TrainState(params, opt_init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def param_shardings(model):
    """The parameters' ``NamedSharding`` tree of a model on a mesh (None
    without one)."""
    return None if model.plan is None else model.plan.shardings


def state_sharding(model, state: TrainState) -> TrainState:
    """The ``NamedSharding`` tree of a whole train state on the model's
    mesh: parameters by ``param_specs``, the optimizer state by
    ``opt_state_sharding``, ``step`` replicated."""
    from repro_torch.dist.sharding import NamedSharding
    from repro_torch.train.optimizer import opt_state_sharding

    psh = param_shardings(model)
    return TrainState(psh, opt_state_sharding(state.opt, psh, state.params),
                      NamedSharding(model.mesh, ()))


def loss_and_grads(model, params, batch):
    """(loss, metrics, gradient leaves in ``tree_leaves`` order; zeros
    for a leaf the loss does not reach)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = model.train_loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def rank_rows(n: int, mesh, microbatches: int = 1) -> np.ndarray:
    """The indices of this rank's rows of a global batch of ``n``: for
    each microbatch i in turn (the JAX step's rows ``[i n/m, (i+1) n/m)``)
    block r of it, r this rank's row-major index over the batch axes.
    One microbatch gives the contiguous block r; no mesh, every row."""
    from repro_torch.dist import tensor_parallel as tp

    if mesh is None:
        return np.arange(n)
    r, ways = 0, 1
    for a in tp.BATCH_AXES:
        s = tp.axis_size(mesh, a)
        r, ways = r * s + tp.axis_index(mesh, a), ways * s
    if n % (ways * microbatches):
        raise ValueError(f"a batch of {n} rows does not split into "
                         f"{microbatches} microbatches over {ways} "
                         "data-parallel ranks")
    mb, b = n // microbatches, n // (microbatches * ways)
    return (np.arange(microbatches)[:, None] * mb + r * b
            + np.arange(b)[None, :]).reshape(-1)


def _microbatch(batch: Dict[str, torch.Tensor], m: int, i: int):
    return {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def _reduce(model, shardings, loss, metrics, grads):
    """Sums over the batch axes: each gradient over those its leaf is not
    split over, the loss and the metrics over all."""
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.sharding import spec_axes

    mesh = model.mesh
    batch = tuple(a for a in tp.BATCH_AXES if tp.axis_size(mesh, a) > 1)
    out = []
    for g, sh in zip(grads, tree_leaves(shardings)):
        split = {a for e in sh.spec for a in spec_axes(e)}
        out.append(tp.all_reduce(g, mesh, [a for a in batch
                                           if a not in split]))
    if batch:
        loss = tp.all_reduce(loss.clone(), mesh, batch)
        metrics = {k: tp.all_reduce(v.clone(), mesh, batch)
                   for k, v in metrics.items()}
    return loss, metrics, out


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, the state's
    tensors updated in place; ``metrics`` holds
    scalar tensors ``loss``, ``grad_norm``, ``lr``, ``nll`` and ``aux``
    (read them back to time the device's step)."""
    schedule = make_schedule(tcfg.schedule)
    shardings = param_shardings(model)
    _, opt_update = make_optimizer(tcfg.optimizer, shardings)
    m = tcfg.microbatches
    acc_dtype = (torch.bfloat16 if tcfg.accum_dtype == "bfloat16"
                 else torch.float32)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if m == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            g_acc: List[torch.Tensor] = [
                torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=_F32, device=g_acc[0].device)
            for i in range(m):
                l, _, g = loss_and_grads(model, params,
                                         _microbatch(batch, m, i))
                for a, gi in zip(g_acc, g):
                    a.add_(gi.to(acc_dtype) / m)
                del g
                loss = loss + l / m
            grads = g_acc
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        if shardings is not None:
            loss, metrics, grads = _reduce(model, shardings, loss, metrics,
                                           grads)
        lr = schedule(state.step)
        new_params, new_opt, gnorm = opt_update(
            tree_unflatten(params, grads), state.opt, params, lr=lr)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr, **metrics}
        return TrainState(new_params, new_opt, state.step + 1), out

    return train_step

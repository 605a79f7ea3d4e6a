"""Optimizers over a parameter tree of tensors, PyTorch.

Port of ``repro.train.optimizer``.

* **AdamW**: global-norm clipping first, then the bias-corrected moments
  with epsilon added *after* the square root, decoupled weight decay, all
  in f32.  Written out rather than taken from ``torch.optim.AdamW`` so
  that a few steps agree numerically with the JAX package
  (``torch.optim.AdamW`` folds the bias correction into the step size and
  places epsilon differently).
* **Adafactor**: the factored second moment (Shazeer & Stern): a matrix
  leaf keeps row and column statistics (``vr``, ``vc``) instead of a full
  ``v``; beta1 = 0 (no momentum), RMS update clipping, the update scaled
  by the parameter's RMS.  A layer-stacked leaf past 2^26 elements
  updates one layer at a time, each with its own statistics, as the JAX
  package's ``lax.map`` does.

``adamw_update_`` and ``adafactor_update_`` write the moments and the
parameters in place, AdamW a slice of at most 2^26 elements at a time
(the JAX trainer donates its state; a copy of internlm2-1.8b's f32 m and
v is 15.1 GB); ``make_optimizer`` returns them.  ``adamw_update`` and
``adafactor_update`` return new trees and leave their inputs as they
were, as the JAX functions do: they run the in-place update on copies.

On a mesh each leaf is a rank's local shard.  The updates then take the
leaves' ``NamedSharding`` tree (``shardings``): every reduction over a
split dimension (the global norm, Adafactor's row and column means, the
update's and the parameter's RMS) sums its local part over the mesh
axes that split it, and Adafactor decides what it factors and what it
updates layer by layer on the global shapes.  A reduction over axes of
size 1 is the meshless one, op for op.  ``opt_state_sharding`` places
the state as the JAX dry run does (``_opt_state_sds``): AdamW ``m``/``v``
as the parameters, Adafactor ``vr`` as the parameter without its last
axis (all of it if unfactored), ``vc`` without its second-to-last (a
replicated placeholder if unfactored), ``step`` replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "global_norm",
           "tree_leaves", "tree_unflatten", "AdafactorConfig", "AdafactorState",
           "adafactor_init", "adafactor_update", "adafactor_update_",
           "make_optimizer", "opt_state_sharding"]

_F32 = torch.float32
# elements per slice of an in-place update (its f32 temporaries)
_SLICE = 1 << 26
# Adafactor: a layer-stacked factored leaf past this many f32 bytes
# updates one layer at a time (the JAX package's threshold)
_PER_LAYER_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # i32 scalar
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict/list/tuple tree in the order of
    ``jax.tree.leaves`` (dicts sorted by key, NamedTuples field by
    field)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` over ``leaves`` given in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(go(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(go(x) for x in t)
        return next(it)

    return go(like)


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=_tree_map(zeros, params), v=_tree_map(zeros, params))


# ------------------------------------------------------- sharded reductions
def _split_axes(sh, dims) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) that split any of ``dims`` of a leaf
    placed by ``sh`` (None: a meshless leaf)."""
    if sh is None:
        return ()
    from repro_torch.dist.sharding import axis_sizes, spec_axes

    sizes = axis_sizes(sh.mesh)
    spec = tuple(sh.spec)
    return tuple(a for d in dims if d < len(spec)
                 for a in spec_axes(spec[d]) if sizes[a] > 1)


def _global_shape(x: torch.Tensor, sh) -> Tuple[int, ...]:
    if sh is None:
        return tuple(x.shape)
    return tuple(n * w for n, (w, _i) in zip(x.shape, sh.splits(x.dim())))


def _sum_over(x: torch.Tensor, sh, axes) -> torch.Tensor:
    if not axes:
        return x
    from repro_torch.dist import tensor_parallel as tp

    return tp.all_reduce(x, sh.mesh, axes)


def _mean(x: torch.Tensor, sh, dim=None, keepdim: bool = False):
    """``x.mean(dim)`` of the global tensor whose local shard ``x`` is
    (``dim`` None: over every element); split dims summed over their
    axes."""
    nd = x.dim()
    dims = tuple(range(nd)) if dim is None else (dim % nd,)
    axes = _split_axes(sh, dims)
    if not axes:
        return (torch.mean(x) if dim is None
                else x.mean(dim=dim, keepdim=keepdim))
    n = 1
    g = _global_shape(x, sh)
    for d in dims:
        n *= g[d]
    part = torch.sum(x) if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return _sum_over(part, sh, axes) / n


def _leaf_shardings(shardings, n: int):
    return [None] * n if shardings is None else tree_leaves(shardings)


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The global L2 norm; with ``shardings``, each leaf's local sum of
    squares summed over the axes that split it."""
    leaves = tree_leaves(tree)
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    return torch.sqrt(sum(
        _sum_over(torch.sum(torch.square(x.float())), sh,
                  _split_axes(sh, range(x.dim())))
        for x, sh in zip(leaves, tree_leaves(shardings))))


def opt_state_sharding(state, shardings, params=None):
    """The ``NamedSharding`` tree of an optimizer state for parameters
    placed by ``shardings`` (see the module docstring); ``params`` are
    the whole parameters (Adafactor compares their shapes)."""
    from repro_torch.dist.sharding import NamedSharding

    mesh = tree_leaves(shardings)[0].mesh
    rep = NamedSharding(mesh, ())
    if isinstance(state, AdamWState):
        return AdamWState(step=rep, m=shardings, v=shardings)

    def vr(sh, p, v):
        spec = tuple(sh.spec) + (None,) * (p.dim() - len(sh.spec))
        return sh if tuple(v.shape) == tuple(p.shape) \
            else NamedSharding(mesh, spec[:-1])

    def vc(sh, p, v):
        spec = tuple(sh.spec) + (None,) * (p.dim() - len(sh.spec))
        return rep if tuple(v.shape) == (1,) \
            else NamedSharding(mesh, spec[:-2] + spec[-1:])

    return AdafactorState(step=rep,
                          vr=_tree_map(vr, shardings, params, state.vr),
                          vc=_tree_map(vc, shardings, params, state.vc))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm, scale = _clip_scale(grads, max_norm)
    return _tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _copy(tree):
    return _tree_map(lambda x: x.detach().clone(), tree)


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr: Optional[float] = None):
    """One AdamW step -> (new_params, new_state, pre-clip grad norm), new
    trees: ``adamw_update_`` on copies of the state and the parameters."""
    return adamw_update_(grads, state._replace(m=_copy(state.m),
                                               v=_copy(state.v)),
                         _copy(params), cfg, lr)


def _bias_corrections(step, b1, b2):
    stepf = step.to(_F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=_F32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=_F32,
                                       device=stepf.device), stepf)
    return bc1, bc2


def _clip_scale(grads, grad_clip, shardings=None):
    """(pre-clip global norm, the clip's scale or None)."""
    norm = global_norm(grads, shardings)
    if grad_clip is None:
        return norm, None
    return norm, torch.clamp(grad_clip / (norm + 1e-12), max=1.0)


def _slices(*leaves):
    """Equal-shaped leaves cut along their first axis into views of at
    most ``_SLICE`` elements (one view each if smaller)."""
    t0 = leaves[0]
    if t0.dim() == 0 or t0.numel() <= _SLICE:
        yield leaves
        return
    rows = max(1, _SLICE // (t0.numel() // t0.shape[0]))
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in leaves)


@torch.no_grad()
def adamw_update_(grads, state: AdamWState, params, cfg: AdamWConfig,
                  lr: Optional[float] = None, shardings=None):
    """One AdamW step written into ``state.m``, ``state.v`` and ``params``
    in place -> (params, new_state, pre-clip grad norm): global-norm
    clipping, then per slice the moments, their bias corrections, epsilon
    after the square root, and decoupled weight decay, in f32."""
    gnorm, scale = _clip_scale(grads, cfg.grad_clip, shardings)
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = _bias_corrections(step, b1, b2)
    for leaf in zip(tree_leaves(grads), tree_leaves(state.m),
                    tree_leaves(state.v), tree_leaves(params)):
        for g, m, v, p in _slices(*leaf):
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.float()
            m.mul_(b1).add_((1.0 - b1) * g32)
            v.mul_(b2).add_((1.0 - b2) * torch.square(g32))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


# ============================================================== Adafactor
@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    decay_exponent: float = 0.8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    min_dim_factored: int = 128  # matrices smaller than this keep full v


class AdafactorState(NamedTuple):
    step: torch.Tensor   # i32 scalar
    vr: Any              # row statistics (or the full v of an unfactored leaf)
    vc: Any              # column statistics (or a (1,) placeholder)


def _factored(p, cfg: AdafactorConfig, sh=None) -> bool:
    shape = _global_shape(p, sh)
    return len(shape) >= 2 and min(shape[-2:]) >= cfg.min_dim_factored


def adafactor_init(params, cfg: AdafactorConfig,
                   shardings=None) -> AdafactorState:
    def init_vr(p, sh=None):
        shape = p.shape[:-1] if _factored(p, cfg, sh) else p.shape
        return torch.zeros(shape, dtype=_F32, device=p.device)

    def init_vc(p, sh=None):
        shape = (p.shape[:-2] + p.shape[-1:] if _factored(p, cfg, sh)
                 else (1,))
        return torch.zeros(shape, dtype=_F32, device=p.device)

    dev = tree_leaves(params)[0].device
    trees = (params,) if shardings is None else (params, shardings)
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        vr=_tree_map(init_vr, *trees), vc=_tree_map(init_vc, *trees))


def _adafactor_one(g, vr, vc, p, cfg: AdafactorConfig, beta2, lr_t,
                   factored: bool, sh=None):
    """One matrix's (or one layer's) update -> (p_new, vr_new, vc_new);
    ``sh`` places the local shard ``p`` (None: the whole leaf)."""
    g32 = g.float()
    g2 = torch.square(g32) + cfg.eps1
    if factored:
        vr_new = beta2 * vr + (1 - beta2) * _mean(g2, sh, -1)
        vc_new = beta2 * vc + (1 - beta2) * _mean(g2, sh, -2)
        # rank-1 reconstruction of the second moment (vr's last axis is
        # the parameter's second-to-last)
        axes = _split_axes(sh, (g.dim() - 2,))
        denom = (vr_new.mean(dim=-1, keepdim=True) if not axes else
                 _sum_over(vr_new.sum(dim=-1, keepdim=True), sh, axes)
                 / _global_shape(g, sh)[-2])
        vhat = (vr_new[..., None] * vc_new[..., None, :]
                / torch.clamp(denom[..., None], min=cfg.eps1))
    else:
        vr_new = beta2 * vr + (1 - beta2) * g2
        vc_new = vc
        vhat = vr_new
    u = g32 * torch.rsqrt(vhat + cfg.eps1)
    # RMS update clipping (Adafactor section 6)
    rms_u = torch.sqrt(_mean(torch.square(u), sh) + 1e-30)
    u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
    p32 = p.float()
    scale = torch.clamp(torch.sqrt(_mean(torch.square(p32), sh)),
                        min=cfg.eps2)
    delta = lr_t * scale * u
    if cfg.weight_decay:
        delta = delta + lr_t * cfg.weight_decay * p32
    return (p32 - delta).to(p.dtype), vr_new, vc_new


def _per_layer(p, cfg: AdafactorConfig, sh=None) -> bool:
    """A layer-stacked factored leaf past 2^26 elements updates layer by
    layer (the JAX ``lax.map``: one layer's f32 temporaries, per-layer
    statistics)."""
    n = 1
    for d in _global_shape(p, sh):
        n *= d
    return p.dim() >= 3 and _factored(p, cfg, sh) and n * 4 > _PER_LAYER_BYTES


def _layer_sharding(sh):
    """A layer's placement: the leaf's without its (unsplit) layer axis."""
    if sh is None:
        return None
    from repro_torch.dist.sharding import NamedSharding

    return NamedSharding(sh.mesh, tuple(sh.spec)[1:])


def _adafactor_step(state: AdafactorState, cfg: AdafactorConfig, lr):
    step = state.step + 1
    beta2 = 1.0 - step.to(_F32) ** (-cfg.decay_exponent)
    return step, beta2, cfg.lr if lr is None else lr


def adafactor_update(grads, state: AdafactorState, params,
                     cfg: AdafactorConfig, lr: Optional[float] = None):
    """One Adafactor step -> (new_params, new_state, pre-clip grad norm),
    new trees: ``adafactor_update_`` on copies of the state and the
    parameters."""
    return adafactor_update_(grads, state._replace(vr=_copy(state.vr),
                                                   vc=_copy(state.vc)),
                             _copy(params), cfg, lr)


@torch.no_grad()
def adafactor_update_(grads, state: AdafactorState, params,
                      cfg: AdafactorConfig, lr: Optional[float] = None,
                      shardings=None):
    """One Adafactor step written into ``state.vr``, ``state.vc`` and
    ``params`` in place, a leaf (or a layer of a ``_per_layer`` leaf) at
    a time -> (params, new_state, pre-clip grad norm)."""
    gnorm, scale = _clip_scale(grads, cfg.grad_clip, shardings)
    step, beta2, lr_t = _adafactor_step(state, cfg, lr)
    ps_ = tree_leaves(params)
    for g, vr, vc, p, sh in zip(tree_leaves(grads), tree_leaves(state.vr),
                                tree_leaves(state.vc), ps_,
                                _leaf_shardings(shardings, len(ps_))):
        fac = _factored(p, cfg, sh)
        per = _per_layer(p, cfg, sh)
        parts = ([(g[i], vr[i], vc[i], p[i]) for i in range(p.shape[0])]
                 if per else [(g, vr, vc, p)])
        psh = _layer_sharding(sh) if per else sh
        for gs, vrs, vcs, ps in parts:
            if scale is not None:
                gs = gs * scale.to(gs.dtype)
            pn, vrn, vcn = _adafactor_one(gs, vrs, vcs, ps, cfg, beta2,
                                          lr_t, fac, psh)
            ps.copy_(pn)
            vrs.copy_(vrn)
            if fac:
                vcs.copy_(vcn)
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc), gnorm


def make_optimizer(cfg, shardings=None):
    """(init, update) pair for either optimizer config; the update writes
    the state and the parameters in place (``adamw_update_``,
    ``adafactor_update_``).  ``shardings`` places local-shard parameters
    on a mesh (see the module docstring)."""
    if isinstance(cfg, AdafactorConfig):
        return (lambda p: adafactor_init(p, cfg, shardings),
                lambda g, s, p, lr=None: adafactor_update_(
                    g, s, p, cfg, lr, shardings))
    return (lambda p: adamw_init(p, cfg),
            lambda g, s, p, lr=None: adamw_update_(g, s, p, cfg, lr,
                                                   shardings))

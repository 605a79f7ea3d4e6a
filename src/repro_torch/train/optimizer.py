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
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "global_norm",
           "tree_leaves", "tree_unflatten", "AdafactorConfig", "AdafactorState",
           "adafactor_init", "adafactor_update", "adafactor_update_",
           "make_optimizer"]

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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


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


def _clip_scale(grads, grad_clip):
    """(pre-clip global norm, the clip's scale or None)."""
    norm = global_norm(grads)
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
                  lr: Optional[float] = None):
    """One AdamW step written into ``state.m``, ``state.v`` and ``params``
    in place -> (params, new_state, pre-clip grad norm): global-norm
    clipping, then per slice the moments, their bias corrections, epsilon
    after the square root, and decoupled weight decay, in f32."""
    gnorm, scale = _clip_scale(grads, cfg.grad_clip)
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


def _factored(p, cfg: AdafactorConfig) -> bool:
    return p.dim() >= 2 and min(p.shape[-2:]) >= cfg.min_dim_factored


def adafactor_init(params, cfg: AdafactorConfig) -> AdafactorState:
    def init_vr(p):
        shape = p.shape[:-1] if _factored(p, cfg) else p.shape
        return torch.zeros(shape, dtype=_F32, device=p.device)

    def init_vc(p):
        shape = (p.shape[:-2] + p.shape[-1:] if _factored(p, cfg)
                 else (1,))
        return torch.zeros(shape, dtype=_F32, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        vr=_tree_map(init_vr, params), vc=_tree_map(init_vc, params))


def _adafactor_one(g, vr, vc, p, cfg: AdafactorConfig, beta2, lr_t,
                   factored: bool):
    """One matrix's (or one layer's) update -> (p_new, vr_new, vc_new)."""
    g32 = g.float()
    g2 = torch.square(g32) + cfg.eps1
    if factored:
        vr_new = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
        vc_new = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
        # rank-1 reconstruction of the second moment
        denom = vr_new.mean(dim=-1, keepdim=True)
        vhat = (vr_new[..., None] * vc_new[..., None, :]
                / torch.clamp(denom[..., None], min=cfg.eps1))
    else:
        vr_new = beta2 * vr + (1 - beta2) * g2
        vc_new = vc
        vhat = vr_new
    u = g32 * torch.rsqrt(vhat + cfg.eps1)
    # RMS update clipping (Adafactor section 6)
    rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
    u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
    p32 = p.float()
    scale = torch.clamp(torch.sqrt(torch.mean(torch.square(p32))),
                        min=cfg.eps2)
    delta = lr_t * scale * u
    if cfg.weight_decay:
        delta = delta + lr_t * cfg.weight_decay * p32
    return (p32 - delta).to(p.dtype), vr_new, vc_new


def _per_layer(p, cfg: AdafactorConfig) -> bool:
    """A layer-stacked factored leaf past 2^26 elements updates layer by
    layer (the JAX ``lax.map``: one layer's f32 temporaries, per-layer
    statistics)."""
    return (p.dim() >= 3 and _factored(p, cfg)
            and p.numel() * 4 > _PER_LAYER_BYTES)


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
                      cfg: AdafactorConfig, lr: Optional[float] = None):
    """One Adafactor step written into ``state.vr``, ``state.vc`` and
    ``params`` in place, a leaf (or a layer of a ``_per_layer`` leaf) at
    a time -> (params, new_state, pre-clip grad norm)."""
    gnorm, scale = _clip_scale(grads, cfg.grad_clip)
    step, beta2, lr_t = _adafactor_step(state, cfg, lr)
    for g, vr, vc, p in zip(tree_leaves(grads), tree_leaves(state.vr),
                            tree_leaves(state.vc), tree_leaves(params)):
        fac = _factored(p, cfg)
        parts = ([(g[i], vr[i], vc[i], p[i]) for i in range(p.shape[0])]
                 if _per_layer(p, cfg) else [(g, vr, vc, p)])
        for gs, vrs, vcs, ps in parts:
            if scale is not None:
                gs = gs * scale.to(gs.dtype)
            pn, vrn, vcn = _adafactor_one(gs, vrs, vcs, ps, cfg, beta2,
                                          lr_t, fac)
            ps.copy_(pn)
            vrs.copy_(vrn)
            if fac:
                vcs.copy_(vcn)
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc), gnorm


def make_optimizer(cfg):
    """(init, update) pair for either optimizer config; the update writes
    the state and the parameters in place (``adamw_update_``,
    ``adafactor_update_``)."""
    if isinstance(cfg, AdafactorConfig):
        return (lambda p: adafactor_init(p, cfg),
                lambda g, s, p, lr=None: adafactor_update_(g, s, p, cfg, lr))
    return (lambda p: adamw_init(p, cfg),
            lambda g, s, p, lr=None: adamw_update_(g, s, p, cfg, lr))

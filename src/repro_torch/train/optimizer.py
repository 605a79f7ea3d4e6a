"""AdamW over a parameter tree of tensors, PyTorch.

Port of ``repro.train.optimizer``'s AdamW: global-norm clipping first,
then the bias-corrected moments with epsilon added *after* the square
root, decoupled weight decay, all in f32.  Written out rather than taken
from ``torch.optim.AdamW`` so that a few steps agree numerically with
the JAX package (``torch.optim.AdamW`` folds the bias correction into
the step size and places epsilon differently).  Adafactor ports with
the LM scaffolding (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "tree_leaves"]


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
    """Leaves of a nested dict/list tree in key order (dicts sorted by
    key, like ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


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
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _tree_map(lambda g: g * scale, grads), norm


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr: Optional[float] = None):
    """One AdamW step -> (new_params, new_state, pre-clip grad norm)."""
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(g, m, v, p):
        g32 = g.float()
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * torch.square(g32)
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr_t * delta).to(p.dtype), m_new, v_new

    # a tree of (p, m, v) leaf tuples, split three ways
    out = _tree_map(upd, grads, state.m, state.v, params)
    return (_split(out, 0),
            AdamWState(step=step, m=_split(out, 1), v=_split(out, 2)),
            gnorm)


def _split(tree, i):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_split(v, i) for v in tree]
    return tree[i]

"""Numerical Normalizing Flow — a B-NAF for 1-D numerical keys, PyTorch.

Port of ``repro.core.flow`` (paper §3.2).  Input dim d, per-dim hidden
width h; layer l has weight W in R^{(d*h_out) x (d*h_in)} with blocks
B_ij: zero above the block diagonal (autoregressive), ``exp(w)`` on it
(monotone in x_i), free below.  tanh between layers, affine output,
then a learnable positive per-dim output scale.  The transformed 1-D key
is ``sum(z)`` (Alg 3.1 decoder).

Parameters are a plain dict of tensors, ``{"layers": [{"w", "b"}, ...],
"out_log_scale"}`` plus, after training, ``"feat_mu"`` / ``"feat_sd"``
— the same tree as the JAX package, so ``repro_torch.weights`` maps one
onto the other one-to-one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.feature import (KeyNormalizer, decode_features,
                                      expand_features)
from repro_torch.kernels.backend import resolve_device

__all__ = [
    "FlowConfig",
    "init_flow",
    "flow_forward",
    "flow_forward_with_logdet",
    "transform_keys",
    "materialize_weights",
]


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Numerical NF hyper-parameters (paper §4.1.3 defaults: 2 layers,
    2 input dims, 2 hidden dims per input dim).  ``latent_std`` is the
    std-dev of the wide normal latent."""

    dim: int = 2              # input feature dim d (>= 2)
    hidden: int = 2           # per-dim hidden width h
    layers: int = 2           # total affine layers (>= 2)
    latent_std: float = 1e4
    theta: float = 1e3        # feature-expansion digit base
    norm_scale: float = 1e4   # scaled min-max normalization span

    def layer_dims(self) -> List[Tuple[int, int]]:
        """Per-layer (in_width, out_width) in units of per-dim width."""
        if self.layers < 2:
            return [(1, 1)]
        dims = [(1, self.hidden)]
        for _ in range(self.layers - 2):
            dims.append((self.hidden, self.hidden))
        dims.append((self.hidden, 1))
        return dims


@functools.lru_cache(maxsize=64)
def _block_masks(dim: int, hidden: int, layers: int):
    """Per layer (diag_mask, lower_mask) as f32 numpy constants."""
    cfg = FlowConfig(dim=dim, hidden=hidden, layers=layers)
    out = []
    for a, b in cfg.layer_dims():
        diag = np.zeros((dim * b, dim * a), dtype=np.float32)
        lower = np.zeros((dim * b, dim * a), dtype=np.float32)
        for i in range(dim):
            for j in range(dim):
                blk = (slice(i * b, (i + 1) * b), slice(j * a, (j + 1) * a))
                if i == j:
                    diag[blk] = 1.0
                elif j < i:
                    lower[blk] = 1.0
        out.append((diag, lower))
    return out


def init_flow(gen: torch.Generator, cfg: FlowConfig,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Any]:
    """Initialize B-NAF parameters from ``gen`` (raw weights ~ N(0, 0.1²),
    zero biases, zero output log-scale).  Tensors are drawn on the CPU
    (so a seed gives the same numbers on every device) and then moved."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {"layers": []}
    d = cfg.dim
    for a, b in cfg.layer_dims():
        w = torch.randn((d * b, d * a), generator=gen,
                        dtype=torch.float32) * 0.1
        params["layers"].append({"w": w.to(dev),
                                 "b": torch.zeros(d * b, device=dev)})
    params["out_log_scale"] = torch.zeros(d, device=dev)
    return params


def materialize_weights(params: Dict[str, Any], cfg: FlowConfig
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Apply the B-NAF masks -> effective dense (W, b) per layer."""
    masks = _block_masks(cfg.dim, cfg.hidden, cfg.layers)
    out = []
    for (diag, lower), layer in zip(masks, params["layers"]):
        w = layer["w"]
        dm = torch.as_tensor(diag, device=w.device)
        lm = torch.as_tensor(lower, device=w.device)
        out.append((torch.exp(w) * dm + w * lm, layer["b"]))
    return out


def flow_forward(params: Dict[str, Any], x: torch.Tensor,
                 cfg: FlowConfig) -> torch.Tensor:
    """Forward map x [., d] -> z [., d]: optional standardization, tanh
    between layers, affine output, positive per-dim output scale."""
    weights = materialize_weights(params, cfg)
    h = x.to(torch.float32)
    if "feat_mu" in params:
        h = (h - params["feat_mu"]) / params["feat_sd"]
    n_layers = len(weights)
    for idx, (w, b) in enumerate(weights):
        h = h @ w.T + b
        if idx < n_layers - 1:
            h = torch.tanh(h)
    return h * torch.exp(params["out_log_scale"])


def flow_forward_with_logdet(params: Dict[str, Any], x: torch.Tensor,
                             cfg: FlowConfig
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, log|det dz/dx|) for a batch x [n, d].  The Jacobian is lower
    triangular with positive diagonal; the exact per-row Jacobian comes
    from ``vmap(jacfwd)`` (cheap at d <= 8, training only)."""

    def single(xi):
        return flow_forward(params, xi[None, :], cfg)[0]

    z = flow_forward(params, x, cfg)
    jac = torch.func.vmap(torch.func.jacfwd(single))(x)  # [n, d, d]
    diag = torch.diagonal(jac, dim1=-2, dim2=-1)
    logdet = torch.sum(torch.log(torch.abs(diag) + 1e-20), dim=-1)
    return z, logdet


def transform_keys(params: Dict[str, Any], normalizer: KeyNormalizer,
                   keys: np.ndarray, cfg: FlowConfig,
                   batch_size: int = 1 << 20) -> np.ndarray:
    """Host f64 expansion -> f32 flow (plain PyTorch, on the params'
    device) -> f64 sum decode.  The flat backend positions by
    ``ops.nf_transform_keys`` (the kernel) instead."""
    keys = np.asarray(keys, dtype=np.float64)
    dev = params["out_log_scale"].device
    outs = []
    with torch.no_grad():
        for start in range(0, keys.shape[0], batch_size):
            chunk = keys[start:start + batch_size]
            feats = expand_features(chunk, normalizer, cfg.dim, cfg.theta,
                                    dtype=np.float32)
            z = flow_forward(params, torch.from_numpy(feats).to(dev), cfg)
            outs.append(decode_features(z.cpu().numpy().astype(np.float64)))
    return np.concatenate(outs) if outs else np.empty((0,), np.float64)

"""Offline training of the Numerical NF (paper §3.2.2), PyTorch autograd.

Port of ``repro.core.train_flow``.  Objective: maximize ``E_x[log N(f(x);
0, sigma^2) + log|det df/dx|]`` with a wide normal latent.  The sample
(``sample_frac`` of the keys), the feature standardization and the
minibatch order come from ``np.random.default_rng`` exactly as in the JAX
package, so given the same initial parameters the two packages take the
same optimizer steps on the same minibatches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.feature import KeyNormalizer, expand_features
from repro_torch.core.flow import (FlowConfig, flow_forward_with_logdet,
                                   init_flow)
from repro_torch.kernels.backend import resolve_device
from repro_torch.train.optimizer import (AdamWConfig, _tree_map, adamw_init,
                                         adamw_update, tree_leaves)

__all__ = ["FlowTrainConfig", "FlowTrainer", "train_flow", "flow_nll"]


@dataclasses.dataclass(frozen=True)
class FlowTrainConfig:
    sample_frac: float = 0.1
    epochs: int = 3
    batch_size: int = 256
    lr: float = 1e-2
    seed: int = 0
    feature_standardize: bool = True


def flow_nll(params, x: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """Negative log-likelihood of expanded features under the wide normal."""
    z, logdet = flow_forward_with_logdet(params, x, cfg)
    var = cfg.latent_std ** 2
    logp = -0.5 * torch.sum(z * z, dim=-1) / var - cfg.dim * (
        0.5 * math.log(2 * math.pi) + math.log(cfg.latent_std))
    return -torch.mean(logp + logdet)


class FlowTrainer:
    """``train_flow`` split into one-minibatch ``step()`` units, as in the
    JAX package (the background re-flow of a later slice drives it step
    by step).  ``params`` may be replaced after construction."""

    def __init__(self, keys: np.ndarray, cfg: FlowConfig,
                 tcfg: FlowTrainConfig | None = None,
                 device: Optional[Union[str, torch.device]] = None):
        tcfg = tcfg or FlowTrainConfig()
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.float64)
        rng = np.random.default_rng(tcfg.seed)
        n_sample = max(int(keys.shape[0] * tcfg.sample_frac),
                       min(keys.shape[0], 1024))
        sample = rng.choice(keys, size=min(n_sample, keys.shape[0]),
                            replace=False)

        self.normalizer = KeyNormalizer.fit(keys, scale=cfg.norm_scale)
        feats = expand_features(sample, self.normalizer, cfg.dim, cfg.theta,
                                dtype=np.float32)
        if tcfg.feature_standardize:
            mu = feats.mean(axis=0)
            sd = feats.std(axis=0) + 1e-6
        else:
            mu = np.zeros(cfg.dim, np.float32)
            sd = np.ones(cfg.dim, np.float32)
        self._mu, self._sd = mu, sd
        feats = (feats - mu) / sd

        gen = torch.Generator().manual_seed(tcfg.seed)
        self.params = init_flow(gen, cfg, self.device)
        self._ocfg = AdamWConfig(lr=tcfg.lr, grad_clip=1.0)
        self._opt_state = adamw_init(self.params, self._ocfg)
        self._x_all = torch.from_numpy(np.ascontiguousarray(feats)).to(
            self.device)
        self._n = int(feats.shape[0])
        self._perm_rng = np.random.default_rng(tcfg.seed + 1)
        self._order: Optional[torch.Tensor] = None
        self._cursor = 0
        self._epochs_done = 0
        # per-step losses stay on the device: reading each one back would
        # stall the host on every step
        self._losses: List[torch.Tensor] = []

    @property
    def losses(self) -> List[float]:
        if not self._losses:
            return []
        return torch.stack(self._losses).cpu().tolist()

    @property
    def done(self) -> bool:
        return self._epochs_done >= self.tcfg.epochs

    def _train_step(self, x: torch.Tensor) -> torch.Tensor:
        params = _tree_map(lambda p: p.detach().requires_grad_(True),
                           self.params)
        leaves = tree_leaves(params)
        loss = flow_nll(params, x, self.cfg)
        grads = torch.autograd.grad(loss, leaves)
        by_id = {id(p): g for p, g in zip(leaves, grads)}
        gtree = _tree_map(lambda p: by_id[id(p)], params)
        with torch.no_grad():
            new_p, self._opt_state, _ = adamw_update(
                gtree, self._opt_state,
                _tree_map(lambda p: p.detach(), params), self._ocfg)
        self.params = new_p
        return loss.detach()

    def step(self) -> bool:
        """Run ONE optimizer minibatch; True once training is complete.
        Epoch boundaries reshuffle exactly like the JAX trainer."""
        bs = self.tcfg.batch_size
        if self.done:
            return True
        if self._order is None or self._cursor + bs > self._n:
            if self._order is not None:
                self._epochs_done += 1
                if self.done:
                    return True
            if bs > self._n:
                self._epochs_done = self.tcfg.epochs
                return True
            perm = self._perm_rng.permutation(self._n)
            self._order = torch.from_numpy(perm).to(self.device)
            self._cursor = 0
        idx = self._order[self._cursor:self._cursor + bs]
        self._cursor += bs
        self._losses.append(self._train_step(self._x_all[idx]))
        if self._cursor + bs > self._n:
            self._epochs_done += 1
            self._order = None
        return self.done

    def result(self) -> Tuple[Dict[str, Any], KeyNormalizer, Dict[str, float]]:
        """(params, normalizer, metrics) with the feature standardization
        folded into the params, as ``train_flow`` returns them."""
        losses = self.losses
        metrics = {
            "final_loss": losses[-1] if losses else float("nan"),
            "initial_loss": losses[0] if losses else float("nan"),
            "n_steps": float(len(losses)),
            "n_sample": float(self._n),
        }
        aux = {"feat_mu": torch.from_numpy(self._mu).to(self.device),
               "feat_sd": torch.from_numpy(self._sd).to(self.device)}
        return {**self.params, **aux}, self.normalizer, metrics


def train_flow(keys: np.ndarray, cfg: FlowConfig,
               tcfg: FlowTrainConfig | None = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[Dict[str, Any], KeyNormalizer, Dict[str, float]]:
    """Fit the Numerical NF on a sample of the bulk-loaded keys.
    Returns (params, normalizer, metrics)."""
    trainer = FlowTrainer(keys, cfg, tcfg, device)
    while not trainer.step():
        pass
    return trainer.result()

"""Unified model API: one entry point over the ported families.

Port of ``repro.models.model``'s ``ModelAPI`` and ``build_model`` for the
ssm family.  ``build_model`` fixes the device: ``None`` is the card (and
raises without one), ``device="cpu"`` runs every kernel's plain version.
``init`` takes a ``torch.Generator`` on that device.  ``train_loss``
raises: training ports with its own slice (ROADMAP A15b); the JAX
``param_specs``/``decode_state_specs`` are sharding layouts with no
counterpart on one card.  ``prefill`` and ``decode_step`` drop the JAX
``extra`` argument (VLM inputs), which no ported family reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as tfm

__all__ = ["ModelAPI", "build_model"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]
    train_loss: Callable[..., Tuple[torch.Tensor, Any]]
    prefill: Callable[..., Tuple[Any, torch.Tensor]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    init_decode_state: Callable[[int, int], Any]


def _train_loss(params, batch):
    raise NotImplementedError(
        "train_loss is not ported to repro_torch yet: training ports with "
        "its own slice (ROADMAP A15b)")


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None
                ) -> ModelAPI:
    dev = resolve_device(device)
    tfm._check_family(cfg)

    def init(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"init needs a generator on {dev}, got one on "
                             f"{generator.device}")
        return tfm.init_params(generator, cfg)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        train_loss=_train_loss,
        prefill=lambda params, tokens, max_len: tfm.prefill(
            params, tokens, cfg, max_len),
        decode_step=lambda params, state, tokens: tfm.decode_step(
            params, state, tokens, cfg),
        init_decode_state=lambda batch, max_len: tfm.init_decode_state(
            cfg, batch, max_len, dev),
    )

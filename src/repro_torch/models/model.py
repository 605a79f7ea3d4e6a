"""Unified model API: one entry point over every architecture family.

Port of ``repro.models.model``'s ``ModelAPI`` and ``build_model``:
``encdec`` dispatches to ``models.encdec``, every other family to
``models.transformer``.  ``build_model`` fixes the device: ``None`` is
the card (and raises without one), ``device="cpu"`` runs every kernel's
plain version.  ``init`` takes a ``torch.Generator`` on that device.
``prefill`` and ``decode_step`` take the JAX ``extra`` argument: the vlm
prefill reads ``extra["patches"]`` and the encdec prefill
``extra["frames"]``.  ``train_loss(params, batch)`` -> (loss, {"nll",
"aux"}) differentiates under autograd (``train.train_step`` takes the
gradients); ``batch`` holds ``tokens``/``targets`` and the vlm
``patches`` or encdec ``frames``.  The JAX
``param_specs``/``decode_state_specs`` are sharding layouts with no
counterpart on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import encdec as encdec_mod
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


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None
                ) -> ModelAPI:
    dev = resolve_device(device)
    if cfg.family == "encdec":
        mod = encdec_mod
    else:
        tfm._check_family(cfg)
        mod = tfm

    def init(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"init needs a generator on {dev}, got one on "
                             f"{generator.device}")
        return mod.init_params(generator, cfg)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        train_loss=lambda params, batch: mod.train_loss(params, batch, cfg),
        prefill=lambda params, tokens, max_len, extra=None: mod.prefill(
            params, tokens, cfg, max_len, extra=extra),
        decode_step=lambda params, state, tokens, extra=None: mod.decode_step(
            params, state, tokens, cfg, extra=extra),
        init_decode_state=lambda batch, max_len: mod.init_decode_state(
            cfg, batch, max_len, dev),
    )

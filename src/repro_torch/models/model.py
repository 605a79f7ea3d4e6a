"""Unified model API: one entry point over every architecture family.

Port of ``repro.models.model``'s ``ModelAPI`` and ``build_model``:
``encdec`` dispatches to ``models.encdec``, every other family to
``models.transformer``.  ``build_model`` fixes the device: ``None`` is
the card (and raises without one), ``device="cpu"`` runs every kernel's
plain version, ``device="meta"`` runs shapes only (the dry run).
``init`` takes a ``torch.Generator`` on that device (on meta, which has
none, a CPU generator).
``prefill`` and ``decode_step`` take the JAX ``extra`` argument: the vlm
prefill reads ``extra["patches"]`` and the encdec prefill
``extra["frames"]``.  ``train_loss(params, batch)`` -> (loss, {"nll",
"aux"}) differentiates under autograd (``train.train_step`` takes the
gradients); ``batch`` holds ``tokens``/``targets`` and the vlm
``patches`` or encdec ``frames``.  The JAX
``param_specs``/``decode_state_specs`` are sharding layouts with no
counterpart on one card.

``input_specs`` and ``decode_state_shapes`` are the dry run's input
surface: meta tensors with the JAX names, shapes and dtypes, no
storage.  The JAX logical axes have no use on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm

__all__ = ["ModelAPI", "build_model", "input_specs", "decode_state_shapes"]

_META = torch.device("meta")


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
        want = "cpu" if dev.type == "meta" else dev.type
        if generator.device.type != want:
            raise ValueError(f"init needs a generator on {want} for {dev}, "
                             f"got one on {generator.device}")
        return mod.init_params(generator, cfg, dev)

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


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """{name: meta tensor} of every input of a step at ``shape``'s global
    batch: ``tokens`` (and ``targets`` to train) i32 [B, L], a decode
    step's ``tokens`` [B, 1]; encdec ``frames`` and vlm ``patches`` f32
    [B, n, d_model]."""
    gb, l = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = torch.empty((gb, l), dtype=i32, device=_META)
        specs["targets"] = torch.empty((gb, l), dtype=i32, device=_META)
    elif shape.kind == "prefill":
        specs["tokens"] = torch.empty((gb, l), dtype=i32, device=_META)
    else:  # decode: one new token against an l-entry KV cache
        specs["tokens"] = torch.empty((gb, 1), dtype=i32, device=_META)
    extra = {"encdec": ("frames", cfg.enc_seq),
             "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if extra:
        specs[extra[0]] = torch.empty((gb, extra[1], cfg.d_model),
                                      dtype=torch.float32, device=_META)
    return specs


def decode_state_shapes(cfg: ModelConfig, batch: int, max_len: int
                        ) -> Dict[str, torch.Tensor]:
    """The decode state's tree as meta tensors (no allocation)."""
    mod = encdec_mod if cfg.family == "encdec" else tfm
    return mod.init_decode_state(cfg, batch, max_len, _META)

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
``patches`` or encdec ``frames``.  ``param_specs()`` and
``decode_state_specs()`` are the JAX trees of logical axes.

``build_model(cfg, device, mesh=...)`` (a ``DeviceMesh`` with axes among
"pod", "data", "model"; every family) makes the mesh's
``transformer.MeshPlan`` once (``plan``) and passes it to every entry
point, which runs on this rank's local shards:
``place(params)`` cuts them from whole parameters (``param_sharding`` on
each leaf's shape), ``train_loss`` takes the
rank's rows and returns its part of the global loss,
``prefill``/``decode_step`` take the rank's rows and return their
logits over the whole vocabulary, and ``init_decode_state(batch,
max_len)`` takes the whole batch and returns the rank's shard of the
state (``decode_state_specs``).

``input_specs`` and ``decode_state_shapes`` are the dry run's input
surface: meta tensors with the JAX names, shapes and dtypes, no
storage; ``input_axes`` gives their JAX logical axes, and
``input_sharding`` their placement on a mesh: every input's rows, the
vlm ``patches`` and encdec ``frames`` [B, n, D] f32 among them, over
the batch axes (on every data rank where the batch does not split), as
the JAX ``input_specs`` places them; a rank takes the vlm or encdec
prefill's and ``train_loss``'s stub inputs for its own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import param_sharding, place
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm

__all__ = ["ModelAPI", "build_model", "input_specs", "input_axes",
           "input_sharding", "decode_state_shapes"]

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
    param_specs: Callable[[], Any] = None
    decode_state_specs: Callable[[], Any] = None
    mesh: Any = None
    plan: Any = None
    place: Callable[[Any], Any] = None


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None,
                mesh=None) -> ModelAPI:
    dev = resolve_device(device)
    if cfg.family == "encdec":
        mod = encdec_mod
    else:
        tfm._check_family(cfg)
        mod = tfm
    # the mesh's plan, made once, goes to every entry point
    plan = None if mesh is None else tfm.mesh_plan(cfg, mesh)
    kw = {} if plan is None else {"plan": plan}

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
        train_loss=lambda params, batch: mod.train_loss(params, batch, cfg,
                                                        **kw),
        prefill=lambda params, tokens, max_len, extra=None: mod.prefill(
            params, tokens, cfg, max_len, extra=extra, **kw),
        decode_step=lambda params, state, tokens, extra=None: mod.decode_step(
            params, state, tokens, cfg, extra=extra, **kw),
        init_decode_state=lambda batch, max_len: mod.init_decode_state(
            cfg, batch, max_len, dev, **kw),
        param_specs=lambda: mod.param_specs(cfg),
        decode_state_specs=lambda: mod.decode_state_specs(cfg),
        mesh=mesh,
        plan=plan,
        place=((lambda params: params) if plan is None
               else (lambda params: place(params, plan.shardings))),
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


def input_axes(cfg: ModelConfig, shape: ShapeConfig
               ) -> Dict[str, Tuple]:
    """The JAX logical axes of each ``input_specs`` entry."""
    axes = {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in input_specs(cfg, shape).items()}
    return axes


def input_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """{name: ``NamedSharding``} of every ``input_specs`` entry on
    ``mesh`` (``input_axes``, guarded on its shape)."""
    return param_sharding(input_axes(cfg, shape), mesh,
                          input_specs(cfg, shape))


def decode_state_shapes(cfg: ModelConfig, batch: int, max_len: int
                        ) -> Dict[str, torch.Tensor]:
    """The decode state's tree as meta tensors (no allocation)."""
    mod = encdec_mod if cfg.family == "encdec" else tfm
    return mod.init_decode_state(cfg, batch, max_len, _META)

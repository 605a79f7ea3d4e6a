"""Shared neural-net layers (functional, explicit parameter dicts).

Port of the parts of ``repro.models.layers`` the ssm family uses:
``dtype_of``, ``Initializer`` and ``rms_norm``.  The rest of the JAX
module (rope, MLPs, chunked cross-entropy) ports with ROADMAP A15b.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["dtype_of", "Initializer", "rms_norm"]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class Initializer:
    """Deterministic parameter init from one ``torch.Generator``.

    Draws on the generator's device, with the JAX package's stddevs and
    dtypes: a normal leaf is drawn in f32, scaled, then cast.  The two
    libraries give different numbers from the same seed; the tests carry
    the JAX parameters across instead (``weights.model_params_from_numpy``).
    """

    def __init__(self, generator: torch.Generator, dtype: torch.dtype):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype

    def normal(self, shape: Sequence[int], stddev: float) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=self.generator,
                        dtype=torch.float32, device=self.device)
        return (x * stddev).to(self.dtype)

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back to x's
    dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + w.to(torch.float32))).to(x.dtype)

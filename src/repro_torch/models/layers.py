"""Shared neural-net layers (functional, explicit parameter dicts).

Port of ``repro.models.layers``: ``dtype_of``, ``Initializer``,
``rms_norm``, ``softcap``, ``rope``, ``init_dense``, ``init_mlp`` and the
MLP block (``swiglu``, alias ``gelu_mlp``).  ``rope`` is the half-split
convention computed in f32; the GELU is ``jax.nn.gelu``'s default, the
tanh approximation.  ``chunked_cross_entropy`` is training (ROADMAP
A15d).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["dtype_of", "Initializer", "rms_norm", "softcap", "rope",
           "init_dense", "init_mlp", "swiglu", "gelu_mlp"]

_F32 = torch.float32
# a normal leaf past this many elements is drawn in slices along its first
# axis, so its f32 draw never holds more than this at once (arctic-480b's
# [128, 7168, 4864] expert leaves are 17.8 GB in f32)
_DRAW_SLICE = 1 << 28


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class Initializer:
    """Deterministic parameter init from one ``torch.Generator``.

    Draws on the generator's device, with the JAX package's stddevs and
    dtypes: a normal leaf is drawn in f32, scaled, then cast (a leaf of
    more than 2^28 elements slice by slice along its first axis).  The
    two libraries give different numbers from the same seed; the tests
    carry the JAX parameters across instead
    (``weights.model_params_from_numpy``).
    """

    def __init__(self, generator: torch.Generator, dtype: torch.dtype):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype

    def _draw(self, shape, stddev: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator, dtype=_F32,
                        device=self.device)
        return (x * stddev).to(self.dtype)

    def normal(self, shape: Sequence[int], stddev: float) -> torch.Tensor:
        shape = tuple(shape)
        n = 1
        for s in shape:
            n *= s
        if n <= _DRAW_SLICE or len(shape) < 2:
            return self._draw(shape, stddev)
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        rows = max(1, _DRAW_SLICE // (n // shape[0]))
        for i in range(0, shape[0], rows):
            part = out[i:i + rows]
            part.copy_(self._draw(tuple(part.shape), stddev))
        return out

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back to x's
    dtype."""
    x32 = x.to(_F32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + w.to(_F32))).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embeddings, half-split, in f32. x [..., L, H, Dh];
    positions [..., L]."""
    half = x.shape[-1] // 2
    freq = torch.pow(torch.tensor(theta, dtype=_F32, device=x.device),
                     -torch.arange(0, half, dtype=_F32, device=x.device)
                     / half)
    angle = positions[..., None].to(_F32) * freq             # [..., L, half]
    cos = torch.cos(angle)[..., None, :]
    sin = torch.sin(angle)[..., None, :]
    x1, x2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_dense(init: Initializer, d_in: int, d_out: int,
               stddev: Optional[float] = None) -> torch.Tensor:
    return init.normal((d_in, d_out), stddev or d_in ** -0.5)


def init_mlp(init: Initializer, d: int, f: int, act: str
             ) -> Dict[str, torch.Tensor]:
    p = {"w_up": init_dense(init, d, f),
         "w_down": init_dense(init, f, d, stddev=f ** -0.5)}
    if act == "swiglu":
        p["w_gate"] = init_dense(init, d, f)
    return p


def swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor],
           act: str = "swiglu") -> torch.Tensor:
    """MLP block: SwiGLU, or GELU (tanh approximation) when ``act`` is not
    ``"swiglu"``; the nonlinearity in f32, cast back to x's dtype."""
    up = x @ p["w_up"]
    if act == "swiglu":
        gate = x @ p["w_gate"]
        h = F.silu(gate.to(_F32)).to(x.dtype) * up
    else:
        h = F.gelu(up.to(_F32), approximate="tanh").to(x.dtype)
    return h @ p["w_down"]


gelu_mlp = swiglu  # same entry point; act selects the nonlinearity

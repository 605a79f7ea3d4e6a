"""LR schedules (pure functions of the step scalar).

Port of ``repro.train.schedule``: cosine, linear and constant decay after
a linear warmup, computed in f32 with the JAX package's constants and
order of operations (a Python float times an f32 array is the float
rounded to f32 first, as JAX's weak types do); the cosine is rounded to
f32 from an f64 cosine of the f32 angle.  The schedule takes an
int or an integer tensor and returns an f32 scalar tensor on the step's
device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ScheduleConfig", "make_schedule"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_ratio: float = 0.1
    kind: str = "cosine"   # cosine | linear | constant


def make_schedule(cfg: ScheduleConfig):
    if cfg.kind not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule kind {cfg.kind!r}")

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(_F32)

        def c(v):
            return torch.tensor(v, dtype=_F32, device=step.device)

        warm = torch.minimum(step / c(max(cfg.warmup_steps, 1)), c(1.0))
        if cfg.kind == "constant":
            decay = c(1.0)
        else:
            frac = torch.clamp(
                (step - c(cfg.warmup_steps))
                / c(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
            if cfg.kind == "cosine":
                # (1 - min_ratio) * 0.5 folds in double, as Python does;
                # the f32 cos rounded from f64 (XLA's f32 cos is closer
                # to that than the vectorized f32 cos of the CPU)
                cos = torch.cos((c(math.pi) * frac).double()).to(_F32)
                decay = c(cfg.min_ratio) + c((1 - cfg.min_ratio) * 0.5) * (
                    c(1.0) + cos)
            else:
                decay = c(1.0) - c(1.0 - cfg.min_ratio) * frac
        return c(cfg.peak_lr) * warm * decay

    return schedule

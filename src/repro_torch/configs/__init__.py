"""Architecture registry of the port: --arch <id> -> ModelConfig.

Only the architectures the port has configs for are registered; any
other id of the JAX package's registry raises and names ROADMAP A15b."""

import importlib

from repro_torch.configs.base import (
    AttnConfig, ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
    applicable_shapes, reduce_for_smoke,
)

ARCHS = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen3-14b": "qwen3_14b",
}

# the JAX package's other architectures, not ported yet
UNPORTED = ("arctic-480b", "granite-moe-1b-a400m", "gemma2-9b",
            "internlm2-1.8b", "phi4-mini-3.8b", "whisper-medium",
            "llama-3.2-vision-11b", "zamba2-2.7b")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP "
            f"A15b); ported: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def arch_names():
    return list(ARCHS)


__all__ = [
    "AttnConfig", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "applicable_shapes", "reduce_for_smoke", "ARCHS",
    "get_config", "arch_names",
]

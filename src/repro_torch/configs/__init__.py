"""Architecture registry of the port: --arch <id> -> ModelConfig.

Every architecture of the JAX package's registry, each a copy of its
``repro.configs`` module."""

import importlib

from repro_torch.configs.base import (
    AttnConfig, ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
    applicable_shapes, reduce_for_smoke,
)

ARCHS = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "arctic-480b": "arctic_480b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "gemma2-9b": "gemma2_9b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-14b": "qwen3_14b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "zamba2-2.7b": "zamba2_2_7b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def arch_names():
    return list(ARCHS)


__all__ = [
    "AttnConfig", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "applicable_shapes", "reduce_for_smoke", "ARCHS",
    "get_config", "arch_names",
]

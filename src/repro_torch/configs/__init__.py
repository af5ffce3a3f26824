"""Config registry: ``get_config("<arch-id>")`` for the architectures the
port serves."""
from __future__ import annotations

from repro_torch.configs.base import (DrafterConfig, HybridConfig, ModelConfig,
                                      MoEConfig, SSMConfig)
from repro_torch.configs.qwen2_1_5b import CONFIG as _QWEN2_1_5B

_CONFIGS = {"qwen2-1.5b": _QWEN2_1_5B}

ARCH_IDS = tuple(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[arch_id]


__all__ = ["ARCH_IDS", "DrafterConfig", "HybridConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config"]

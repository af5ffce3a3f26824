"""Config registry: ``get_config("<arch-id>")`` for the architectures the
port serves."""
from __future__ import annotations

from repro_torch.configs.base import (INPUT_SHAPES, DrafterConfig,
                                      HybridConfig, InputShape, ModelConfig,
                                      MoEConfig, SSMConfig)
from repro_torch.configs.dbrx_132b import CONFIG as _DBRX_132B
from repro_torch.configs.gemma2_27b import CONFIG as _GEMMA2_27B
from repro_torch.configs.gemma_7b import CONFIG as _GEMMA_7B
from repro_torch.configs.internvl2_1b import CONFIG as _INTERNVL2_1B
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _LLAMA4
from repro_torch.configs.mamba2_780m import CONFIG as _MAMBA2_780M
from repro_torch.configs.minitron_4b import CONFIG as _MINITRON_4B
from repro_torch.configs.qwen2_1_5b import CONFIG as _QWEN2_1_5B
from repro_torch.configs.recurrentgemma_2b import CONFIG as _RECURRENTGEMMA_2B
from repro_torch.configs.whisper_base import CONFIG as _WHISPER_BASE

_CONFIGS = {c.arch_id: c for c in (_QWEN2_1_5B, _GEMMA_7B, _GEMMA2_27B,
                                   _MINITRON_4B, _MAMBA2_780M,
                                   _RECURRENTGEMMA_2B, _DBRX_132B, _LLAMA4,
                                   _INTERNVL2_1B, _WHISPER_BASE)}

ARCH_IDS = tuple(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[arch_id]


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "DrafterConfig", "HybridConfig",
           "InputShape", "ModelConfig", "MoEConfig", "SSMConfig",
           "all_configs", "get_config"]

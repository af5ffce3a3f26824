"""The ``Model`` facade (counterpart of the JAX package's
``models/registry.py``). The port carries the dense family only; other
families raise."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        transformer.check_supported(self.cfg)

    def init(self, generator: torch.Generator, *, device="cuda") -> dict:
        return transformer.init_params(self.cfg, generator, device=device)

    def make_cache(self, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   device="cuda") -> dict:
        return transformer.make_cache(self.cfg, batch, max_len, dtype=dtype,
                                      device=device)

    def forward(self, params: dict, tokens, *, positions=None, cache=None,
                mode: str = "train", collect_taps: bool = True,
                head_last_only: bool = False,
                head_positions=None,
                block_table=None) -> transformer.ModelOutput:
        return transformer.forward(self.cfg, params, tokens,
                                   positions=positions, cache=cache,
                                   mode=mode, collect_taps=collect_taps,
                                   head_last_only=head_last_only,
                                   head_positions=head_positions,
                                   block_table=block_table)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

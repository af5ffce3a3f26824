"""The ``Model`` facade (counterpart of the JAX package's
``models/registry.py``). The port carries the dense family only; other
families raise, and so does, for a CUDA device, a head dim the attention
kernels do not take."""
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
                   device="cuda", block: int = 1) -> dict:
        """``block``: the widest decode block that may be rolled back (K + 1
        for a verify), which sizes local layers' rings."""
        return transformer.make_cache(self.cfg, batch, max_len, dtype=dtype,
                                      device=device, block=block)

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


def get_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg``; with ``device``, also checked against what the
    kernels on that device take (before any weight is made)."""
    if device is not None:
        transformer.check_supported(cfg, device)
    return Model(cfg)

"""The ``Model`` facade (counterpart of the JAX package's
``models/registry.py``): one interface over the family modules, dispatched
on ``cfg.family``. The port carries the dense and MoE families
(``transformer.py``), the SSM family (``ssm.py``) and the hybrid family
(``hybrid.py``); the others (vlm, encdec) raise, and so does, for a CUDA
device, a head dim the attention kernels do not take."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, ssm, transformer

_FAMILY_MODULE = {"dense": transformer, "moe": transformer, "ssm": ssm,
                  "hybrid": hybrid}


def check_supported(cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError for a family this port does not carry,
    then for what its module does not carry (on a CUDA ``device`` also a
    head dim without a kernel); before any weight is made."""
    if cfg.family not in _FAMILY_MODULE:
        raise NotImplementedError(
            f"{cfg.arch_id}: not ported yet: family {cfg.family!r} (the port "
            f"carries {sorted(_FAMILY_MODULE)})")
    _FAMILY_MODULE[cfg.family].check_supported(cfg, device)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        check_supported(self.cfg)

    @property
    def module(self):
        return _FAMILY_MODULE[self.cfg.family]

    @property
    def recurrent(self) -> bool:
        """Whether the target carries per-slot recurrent state: pads would
        fold into it (admission chunks instead), the verify commits
        per-token snapshots, and cached pages cannot stand for it (no
        prefix-cache hit): the SSM and the hybrid families."""
        return self.cfg.family in ("ssm", "hybrid")

    def init(self, generator: torch.Generator, *, device="cuda") -> dict:
        return self.module.init_params(self.cfg, generator, device=device)

    def make_cache(self, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   device="cuda", block: int = 1) -> dict:
        """``block``: the widest decode block that may be rolled back (K + 1
        for a verify), which sizes local layers' rings."""
        return self.module.make_cache(self.cfg, batch, max_len, dtype=dtype,
                                      device=device, block=block)

    def forward(self, params: dict, tokens, *, positions=None, cache=None,
                mode: str = "train", collect_taps: bool = True,
                head_last_only: bool = False,
                head_positions=None,
                block_table=None,
                snapshots: bool = False) -> transformer.ModelOutput:
        """``snapshots``: a recurrent target's verify returns each token's
        state for ``cache_ops.commit`` (ignored by attention targets, whose
        caches roll back by position)."""
        kw = dict(positions=positions, cache=cache, mode=mode,
                  collect_taps=collect_taps, head_last_only=head_last_only,
                  head_positions=head_positions, block_table=block_table)
        if self.recurrent:
            kw["snapshots"] = snapshots
        return self.module.forward(self.cfg, params, tokens, **kw)


def get_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg``; with ``device``, also checked against what the
    kernels on that device take (before any weight is made)."""
    if device is not None:
        check_supported(cfg, device)
    return Model(cfg)

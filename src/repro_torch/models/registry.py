"""The ``Model`` facade (counterpart of the JAX package's
``models/registry.py``): one interface over the family modules, dispatched
on ``cfg.family``: the dense, MoE and VLM families (``transformer.py``),
the SSM family (``ssm.py``), the hybrid family (``hybrid.py``) and the
encoder-decoder family (``encdec.py``). A family it does not know raises,
and so does, for a CUDA device, a head dim the attention kernels do not
take.

Modality frontends are stubs: a VLM target's train and prefill take
``vision_embeds`` (B, vision_tokens, vision_dim), an encoder-decoder
target's ``encoder_embeds`` (B, encoder_seq, d_model), as keyword extras
of ``Model.forward``; ``extra_input_shapes`` gives their shapes and
``make_extras`` draws them from a threefry key, bitwise the JAX package's
draws (``prng.normal``); ``takes_extras`` says whether a target takes any,
``extras_on`` moves given ones to a device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models import layers as L

_FAMILY_MODULE = {"dense": transformer, "moe": transformer,
                  "vlm": transformer, "ssm": ssm, "hybrid": hybrid,
                  "encdec": encdec}


def check_supported(cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError for a family this port does not carry,
    then for what its module does not carry (on a CUDA ``device`` also a
    head dim without a kernel); before any weight is made."""
    if cfg.family not in _FAMILY_MODULE:
        raise NotImplementedError(
            f"{cfg.arch_id}: unknown family {cfg.family!r} (the port "
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

    def init(self, generator: torch.Generator, *, device="cuda",
             keep=None) -> dict:
        """Random weights drawn from ``generator`` (on ``device``).
        ``keep``: a per-leaf hook, called on each drawn weight right after
        its draw; what it returns stands in the tree
        (``models.layers.keeping``: a leaf-by-leaf sharded build keeps its
        slice). Without it the tree is what it always was."""
        with L.keeping(keep):
            return self.module.init_params(self.cfg, generator,
                                           device=device)

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
                snapshots: bool = False,
                **extras) -> transformer.ModelOutput:
        """``snapshots``: a recurrent target's verify returns each token's
        state for ``cache_ops.commit`` (ignored by attention targets, whose
        caches roll back by position). ``extras``: the stub frontends'
        inputs, ``encoder_embeds`` for an encoder-decoder target,
        ``vision_embeds`` for a VLM one (ignored by the other families)."""
        kw = dict(positions=positions, cache=cache, mode=mode,
                  collect_taps=collect_taps, head_last_only=head_last_only,
                  head_positions=head_positions, block_table=block_table)
        if self.recurrent:
            kw["snapshots"] = snapshots
        if self.cfg.family == "encdec":
            kw["encoder_embeds"] = extras.get("encoder_embeds")
        elif self.cfg.family == "vlm":
            kw["vision_embeds"] = extras.get("vision_embeds")
        return self.module.forward(self.cfg, params, tokens, **kw)

    def text_len(self, total_seq: int, mode: str) -> int:
        """How many token inputs give a ``total_seq``-long sequence (a VLM
        target prepends its vision tokens at train and prefill)."""
        if self.cfg.family == "vlm" and mode in ("train", "prefill"):
            return max(total_seq - self.cfg.vision_tokens, 1)
        return total_seq


def get_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg``; with ``device``, also checked against what the
    kernels on that device take (before any weight is made)."""
    if device is not None:
        check_supported(cfg, device)
    return Model(cfg)


def extra_input_shapes(cfg: ModelConfig, batch: int,
                       mode: str) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Stub-frontend inputs: name -> (shape, dtype). Empty for pure-text
    families."""
    dt = getattr(torch, cfg.dtype)
    out: Dict[str, Tuple[tuple, torch.dtype]] = {}
    if cfg.family == "encdec":
        out["encoder_embeds"] = ((batch, cfg.encoder_seq, cfg.d_model), dt)
    elif cfg.family == "vlm" and mode in ("train", "prefill"):
        out["vision_embeds"] = ((batch, cfg.vision_tokens, cfg.vision_dim),
                                dt)
    return out


def takes_extras(cfg: ModelConfig) -> bool:
    """Whether the target's prefill takes stub-frontend inputs (the VLM and
    encoder-decoder families)."""
    return bool(extra_input_shapes(cfg, 1, "prefill"))


def extras_on(extras: Optional[dict], device) -> dict:
    """``extras`` (numpy arrays or tensors; None: none) as tensors on
    ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.as_tensor(np.array(v))).to(device)
            for k, v in (extras or {}).items()}


def make_extras(cfg: ModelConfig, batch: int, mode: str,
                key: torch.Tensor) -> dict:
    """Random stub-frontend inputs from the threefry ``key`` (on the
    device the extras are wanted on): one split per input, in the order of
    ``extra_input_shapes``, then ``0.02 * normal`` in the config's dtype
    (the factor rounded to that dtype first), as the JAX package draws
    them."""
    out = {}
    for name, (shape, dt) in extra_input_shapes(cfg, batch, mode).items():
        key, sub = prng.split(key, 2)
        out[name] = prng.normal(sub, shape).to(dt) * torch.tensor(
            0.02, dtype=dt, device=key.device)
    return out

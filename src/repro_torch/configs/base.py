"""Configuration dataclasses for target architectures and drafters.

A copy of the JAX package's ``configs/base.py`` (``ModelConfig``,
``DrafterConfig`` and the family extensions they carry), kept here so the
port imports nothing of the JAX package. Field names, defaults,
``reduced()`` and ``resolve()`` are unchanged, so one config describes the
same model in both packages. The TPU hardware constants are not copied.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    pattern: str = "all"               # "all" or "interleaved"
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3
    aux_loss_weight: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128
    conv_width: int = 4
    dt_rank: int = 0


@dataclass(frozen=True)
class HybridConfig:
    lru_width: int = 0
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    source: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MLP / norm ---
    mlp_variant: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False

    # --- attention ---
    attn_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096
    logit_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False
    post_norms: bool = False
    nope_on_global: bool = False
    rope_theta: float = 10_000.0
    query_scale: Optional[float] = None
    positional: str = "rope"

    # --- family extensions ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)

    # --- encoder-decoder ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- vlm ---
    vision_tokens: int = 0
    vision_dim: int = 0

    # --- long context ---
    long_context: str = "sliding_window"
    long_window: int = 8192

    # --- numerics ---
    dtype: str = "bfloat16"
    use_pallas: bool = False

    def q_scale(self) -> float:
        return self.query_scale if self.query_scale is not None else self.head_dim ** -0.5

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU-test variant of the same family: 2 layers, d_model<=256."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        kw = dict(
            n_layers=2, d_model=d, n_heads=heads, n_kv_heads=kv, head_dim=32,
            d_ff=min(self.d_ff, 512) or 0, vocab_size=min(self.vocab_size, 1024),
            dtype="float32", window_size=min(self.window_size, 64),
            long_window=64, encoder_seq=16 if self.n_encoder_layers else self.encoder_seq,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            vision_dim=64 if self.vision_dim else 0,
        )
        if self.moe.n_experts:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                capacity_factor=4.0)
        if self.family == "ssm":
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk_size=8)
        if self.family == "hybrid":
            kw["hybrid"] = dataclasses.replace(self.hybrid, lru_width=d)
        return self.replace(**kw)


@dataclass(frozen=True)
class DrafterConfig:
    """P-EAGLE / AR-EAGLE drafter riding on a target ModelConfig."""
    n_layers: int = 4
    d_model: int = 0                   # 0 => target d_model
    n_heads: int = 0                   # 0 => max(4, d_model // 128)
    n_kv_heads: int = 0                # 0 => n_heads
    head_dim: int = 0
    d_ff: int = 0                      # 0 => ~3.5 * d_model rounded to 128
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    parallel: bool = True
    k_train: int = 8
    k_infer: int = 5
    cod_rate: float = 0.8
    hidden_state_variant: str = "shared"
    # shared | depth_encoding | ntp_hidden | ntp_hidden_depth | regularized
    freeze_embeddings: bool = False
    num_taps: int = 3
    ttt_steps: int = 3
    hca: bool = True
    remat: bool = False
    flash_train: bool = True

    def resolve(self, target: ModelConfig) -> "DrafterConfig":
        d = self.d_model or target.d_model
        heads = self.n_heads or max(4, d // 128)
        hd = self.head_dim or (d // heads)
        ff = self.d_ff or max(128, int(3.5 * d) // 128 * 128)
        return dataclasses.replace(
            self, d_model=d, n_heads=heads, n_kv_heads=self.n_kv_heads or heads,
            head_dim=hd, d_ff=ff)

"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B LM backbone. [arXiv:2404.16821]

LM: 24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151655,
qwen2-style (QKV bias, SwiGLU). The InternViT-300M vision encoder + MLP
projector are a stub: callers provide (B, 256, vision_dim=1024) patch
embeddings (``models.registry.make_extras``); the in-framework projector
maps them to d_model and they are early-fusion prepended to the text
embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2); LM=Qwen2-0.5B",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    mlp_variant="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    vision_tokens=256,
    vision_dim=1024,
    long_context="sliding_window",
)

"""qwen2-1.5b [dense] — GQA, QKV bias. [arXiv:2407.10671]

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960 (SwiGLU), vocab=151936,
head_dim=128, tied embeddings, RoPE theta 1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671 (Qwen2)",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mlp_variant="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context="sliding_window",
)

"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]

40L, d_model=6144, 48 heads (GQA kv=8), d_ff=10752 per expert, vocab=100352,
MoE on every layer. Full (global) attention; rope_theta=500000.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=16, top_k=4, pattern="all"),
    long_context="skip",
)

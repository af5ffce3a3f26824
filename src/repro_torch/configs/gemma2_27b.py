"""gemma2-27b [dense] — local/global alternating, logit softcap. [arXiv:2408.00118]

46L, d_model=4608, 32 heads (GQA kv=16), d_ff=36864 (GeGLU), vocab=256000,
head_dim=128, alternating local(4096)/global attention, attn logit softcap 50,
final logit softcap 30, query scale (d_model/n_heads)^-0.5 = 144^-0.5.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118 (Gemma 2)",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    mlp_variant="geglu",
    embed_scale=True,
    tie_embeddings=True,
    attn_pattern=("local", "global"),
    window_size=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    query_scale=(4608 / 32) ** -0.5,
    long_context="native",
)

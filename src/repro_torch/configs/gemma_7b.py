"""gemma-7b [dense] — GeGLU, head_dim=256, MHA. [arXiv:2403.08295]

28L, d_model=3072, 16 heads (kv=16 — MHA on 7b; MQA is the 2b variant),
d_ff=24576 (GeGLU), vocab=256000. Embeddings scaled by sqrt(d_model), tied.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-7b",
    family="dense",
    source="arXiv:2403.08295 (Gemma)",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_variant="geglu",
    embed_scale=True,
    tie_embeddings=True,
    long_context="sliding_window",
)

"""minitron-4b [dense] — pruned Nemotron. [arXiv:2407.14679]

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000,
squared-ReLU MLP (Nemotron family), untied embeddings, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-4b",
    family="dense",
    source="arXiv:2407.14679 (Minitron)",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_variant="relu2",
    tie_embeddings=False,
    rope_theta=10_000.0,
    long_context="sliding_window",
)

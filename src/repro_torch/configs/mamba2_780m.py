"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060]

48 layers, d_model 1536, vocab 50280, d_state 128, expand 2 (d_inner
3072), SSD head dim 64: 48 SSD heads. The drafter is attention-based
(resolved from d_model: 12 heads of 128).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060 (Mamba-2)",
    n_layers=48,
    d_model=1536,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                     # no MLP: the SSD block only
    vocab_size=50280,
    mlp_variant="swiglu",       # unused
    tie_embeddings=True,
    norm_eps=1e-5,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=128,
                  conv_width=4),
    long_context="native",
)

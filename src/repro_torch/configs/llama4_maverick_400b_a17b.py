"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

48L, d_model=5120, 40 heads (GQA kv=8), d_ff=8192 per routed expert,
vocab=202048. MoE interleaved (every 2nd layer) with one shared expert —
Maverick's layout; 24 MoE layers x 128 x 3 x 5120 x 8192 ~= 386B routed
params + dense ~= 400B total, 17B active (top-1 + shared).

Attention: Llama-4 iRoPE — chunked local attention (8192) on 3 of 4 layers,
global NoPE layer every 4th.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick layout)",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=False,
    attn_pattern=("local", "local", "local", "global"),
    window_size=8192,
    nope_on_global=True,
    moe=MoEConfig(n_experts=128, top_k=1, pattern="interleaved",
                  n_shared_experts=1),
    long_context="native",
)

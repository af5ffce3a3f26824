"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2. [arXiv:2402.19427]

26 layers in the pattern (recurrent, recurrent, attention): 8 super-blocks
and a tail of 2 recurrent layers. d_model 2560, MQA with 10 query heads on
1 KV head of dim 256, local window 2048, d_ff 7680 (GeGLU), vocab 256000,
lru_width 2560, conv width 4, embeddings scaled by sqrt(d_model), tied.
The recurrent state is O(1) and the window bounded.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_variant="geglu",
    embed_scale=True,
    tie_embeddings=True,
    attn_pattern=("local",),
    window_size=2048,
    hybrid=HybridConfig(lru_width=2560,
                        block_pattern=("recurrent", "recurrent", "attention")),
    long_context="native",
)

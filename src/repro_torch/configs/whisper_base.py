"""whisper-base [audio] — enc-dec, conv frontend stubbed. [arXiv:2212.04356]

6L encoder + 6L decoder, d_model=512, 8 heads (kv=8), d_ff=2048, vocab=51865.
Whisper uses absolute sinusoidal positions and GELU MLPs. The mel-spectrogram
+ conv feature extractor is a stub: callers provide precomputed (B, 1500,
512) frame embeddings (``models.registry.make_extras``). The decoder is
architecturally capped at 448 positions; nothing here enforces it.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="encdec",
    source="arXiv:2212.04356 (Whisper)",
    n_layers=6,                 # decoder layers
    n_encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_variant="gelu",
    positional="sinusoidal",
    tie_embeddings=True,
    long_context="skip",
)

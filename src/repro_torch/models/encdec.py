"""Whisper-style encoder-decoder backbone (PyTorch). [arXiv:2212.04356]

Counterpart of the JAX package's ``models/encdec.py``. The mel-spectrogram
and conv feature extractor are a stub: callers provide precomputed frame
embeddings (B, encoder_seq, d_model) as ``encoder_embeds``
(``models/registry.make_extras``). The transformer is a bidirectional
encoder over the frames and a causal decoder with cross-attention;
absolute sinusoidal positions are added at the embedding of both. The
drafter taps the decoder's layers. Parameters and caches are plain dicts of
tensors, layers in Python lists (``convert.py`` unstacks the JAX package's
``vmap``-stacked ``enc_blocks`` / ``dec_blocks``):

    {"embed": (V, D), "enc_blocks": [{"ln1", "ln2", "attn", "mlp"}, ...],
     "enc_norm": (D,), "final_norm": (D,),
     "dec_blocks": [{"ln1", "lnx", "ln2", "self_attn", "cross_attn",
                     "mlp"}, ...]}
    cache: {"blocks": [{"self": layer KV cache (layers.make_kv_cache),
                        "cross": {"k", "v"} (B, encoder_seq, KV, hd)}, ...]}

Train and prefill run the encoder; a prefill also writes each layer's
cross K/V into the cache, cast to the cache's dtype (its own
cross-attention reads the fresh K/V in the activation dtype, as the
reference's does). A decode reads the cached cross K/V, cast to the
queries' dtype. The cross leaves have no ``positions``: no commit or
invalidation touches them, and ``cache_ops`` carries them as per-slot rows
in both layouts (write, reset, swap).

Attention goes through ``kernels.ops``: the encoder's self-attention and a
train or prefill cross-attention through the flash kernel without the
causal mask (every key of the 1500 frames); a decode's cross-attention
(verify, admission chunks) through the decode kernel, every encoder key
at position 0, so its mask ``0 <= kp <= qp`` admits them all; the
decoder's self-attention as a dense target's (``transformer.attn_apply``,
pooled when paged). On the CPU those calls take the kernels' plain
versions (``ops.flash_attention_plain(causal=False)`` and the decode
kernel's); ``layers.full_attention`` is only the reference the tests hold
this unmasked attention against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelOutput, tap_layers
from repro_torch.sharding import utils as SH

Tensor = torch.Tensor


def check_supported(cfg: ModelConfig, device=None) -> None:
    """On a CUDA ``device``, a head dim the kernels do not take raises
    NotImplementedError (``transformer.check_supported``)."""
    T.check_supported(cfg, device)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: dict, frames: Tensor) -> Tensor:
    """frames (B, Senc, D) stub embeddings -> encoder output (B, Senc, D):
    bidirectional layers (flash, no causal mask), a final norm."""
    B, S, D = frames.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=frames.device)[None].expand(B, S)
    x = frames + L.sinusoidal_positions(pos, D).to(frames.dtype)
    for p in params["enc_blocks"]:
        p = SH.use(p)            # this layer's weights, gathered under a mesh
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = T.attn_apply(p["attn"], h, cfg=cfg, kind="full",
                            positions=pos, cache=None, mode="train")
        x = x + a
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h, cfg.mlp_variant)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _enc_kv(cfg: ModelConfig, p: dict, enc_out: Tensor) -> dict:
    B, S, _ = enc_out.shape
    return {"k": (enc_out @ p["wk"]).reshape(B, S, cfg.n_kv_heads,
                                             cfg.head_dim),
            "v": (enc_out @ p["wv"]).reshape(B, S, cfg.n_kv_heads,
                                             cfg.head_dim)}


def _cross_apply(cfg: ModelConfig, p: dict, x: Tensor, enc_kv: dict,
                 q_positions: Optional[Tensor]) -> Tensor:
    """Cross-attention against encoder K/V (no mask). ``q_positions`` (B,
    Tq) in decode mode: the decode kernel over keys all at position 0;
    None: the flash kernel without the causal mask."""
    B, Tq, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, Tq, H, hd)
    k, v = enc_kv["k"].to(q.dtype), enc_kv["v"].to(q.dtype)
    if q_positions is None:
        out = ops.flash_attention(q, k, v, scale=cfg.q_scale(), causal=False)
    else:
        kpos = torch.zeros(k.shape[:2], dtype=torch.int32, device=k.device)
        out = ops.decode_attention(q, k.contiguous(), v.contiguous(), kpos,
                                   q_positions, scale=cfg.q_scale())
    return out.reshape(B, Tq, H * hd) @ p["wo"]


def _dec_slot_apply(cfg: ModelConfig, p: dict, x: Tensor, *,
                    positions: Tensor, cache: Optional[dict], mode: str,
                    enc_kv: dict, block_table: Optional[Tensor]) -> Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = T.attn_apply(p["self_attn"], h, cfg=cfg, kind="global",
                        positions=positions,
                        cache=None if cache is None else cache["self"],
                        mode=mode, block_table=block_table)
    x = x + a
    h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
    x = x + _cross_apply(cfg, p["cross_attn"], h, enc_kv,
                         positions if mode == "decode" else None)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg.mlp_variant)


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights in ``cfg.dtype`` (norms in float32), drawn from
    ``generator`` (on ``device``): the encoder's layers, the decoder's,
    then the embedding."""
    check_supported(cfg, device)
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model

    def ones():
        return torch.ones(d, dtype=torch.float32, device=device)

    def mlp():
        return L.mlp_init(d, cfg.d_ff, generator, device=device, dtype=dtype,
                          variant=cfg.mlp_variant)

    def attn():
        return T.attn_init(cfg, generator, device, dtype, False)

    enc = [{"ln1": ones(), "ln2": ones(), "attn": attn(), "mlp": mlp()}
           for _ in range(cfg.n_encoder_layers)]
    dec = [{"ln1": ones(), "lnx": ones(), "ln2": ones(), "self_attn": attn(),
            "cross_attn": attn(), "mlp": mlp()} for _ in range(cfg.n_layers)]
    return {"embed": L.embed_init(cfg.vocab_size, d, generator,
                                  device=device, dtype=dtype),
            "enc_blocks": enc, "enc_norm": ones(), "dec_blocks": dec,
            "final_norm": ones()}


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda", block: int = 1) -> dict:
    """A self-attention cache per decoder layer plus its cross K/V (filled
    at the prefill). ``block`` is unused: no layer is a ring."""
    check_supported(cfg, device)

    def cross():
        return SH.kv_zeros((batch, cfg.encoder_seq, cfg.n_kv_heads,
                           cfg.head_dim), dtype=dtype, device=device)
    return {"blocks": [
        {"self": L.make_kv_cache(batch, max_len, cfg.n_kv_heads,
                                 cfg.head_dim, dtype=dtype, ring=False,
                                 device=device),
         "cross": {"k": cross(), "v": cross()}}
        for _ in range(cfg.n_layers)]}


def forward(cfg: ModelConfig, params: dict, tokens: Tensor, *,
            positions: Optional[Tensor] = None, cache: Optional[dict] = None,
            mode: str = "train", collect_taps: bool = True,
            head_last_only: bool = False,
            head_positions: Optional[Tensor] = None,
            block_table: Optional[Tensor] = None,
            encoder_embeds: Optional[Tensor] = None) -> ModelOutput:
    """tokens (B, S) of the decoder. Train and prefill take
    ``encoder_embeds`` (B, encoder_seq, D) and run the encoder; a prefill
    fills the self caches and writes the cross K/V of every layer into the
    cache, in place. A decode (``positions`` required, as in
    ``transformer.forward``) reads the cross K/V from the cache.
    ``block_table`` makes the self caches page pools (decode only)."""
    B, S = tokens.shape
    if mode == "decode" and (positions is None or cache is None):
        raise ValueError("decode mode needs positions and a cache")
    if mode != "decode" and (positions is not None
                             or block_table is not None):
        raise ValueError(f"{mode} attends by index: positions and "
                         f"block_table must be None")
    if mode != "decode" and encoder_embeds is None:
        raise ValueError(f"{mode} mode runs the encoder: encoder_embeds is "
                         f"required")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    embed = SH.use(params["embed"])     # the lookup's and the head's
    x = embed[tokens]
    x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    enc_out = (None if encoder_embeds is None
               else encode(cfg, params, encoder_embeds))
    taps_idx = tap_layers(cfg.n_layers)
    taps = [None] * len(taps_idx)
    for li, bp in enumerate(params["dec_blocks"]):
        bp = SH.use(bp)          # this layer's weights, gathered under a mesh
        bc = None if cache is None else cache["blocks"][li]
        if enc_out is not None:
            ekv = _enc_kv(cfg, bp["cross_attn"], enc_out)
            if bc is not None:
                for name in ("k", "v"):
                    bc["cross"][name].copy_(SH.kv_local(ekv[name]))
        else:   # the cross K/V slices, gathered under a mesh
            ekv = dict(zip(("k", "v"), SH.kv_full(
                [bc["cross"]["k"], bc["cross"]["v"]], cfg.n_kv_heads,
                cfg.head_dim)))
        x = _dec_slot_apply(cfg, bp, x, positions=positions, cache=bc,
                            mode=mode, enc_kv=ekv, block_table=block_table)
        if collect_taps:
            for i, t in enumerate(taps_idx):
                if t == li:
                    taps[i] = x

    if head_positions is not None:
        x = x[torch.arange(B, device=x.device), head_positions.long()][:, None]
    elif head_last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ embed.T.to(x.dtype)).float()
    return ModelOutput(logits=logits,
                       taps=torch.cat(taps, dim=-1) if collect_taps else None,
                       cache=cache, aux=None)

"""Decoder-only transformer, dense family (PyTorch).

Counterpart of the JAX package's ``models/transformer.py`` for dense
targets such as qwen2. The JAX model scans super-blocks; here the layers
are a Python list and the forward is a loop. Parameters are plain dicts of
tensors:

    {"embed": (V, D), "final_norm": (D,),
     "blocks": [{"ln1", "ln2", "attn": {wq, wk, wv, wo[, bq, bk, bv]},
                 "mlp": {w_gate, w_up, w_down}}, ...]}

and the cache is ``{"blocks": [layer cache, ...]}`` with the layer caches
of ``layers.make_kv_cache``. ``convert.py`` turns the JAX package's
scan-stacked trees into these.

Attention goes through ``kernels.ops``: the flash kernel for the prefill,
the decode kernel for both phases of the two-phase decode. Given a block
table, a decode reads paged caches (``layers.paged_view`` layout): phase 1
goes through the paged decode kernel on the pools. Configurations
with a logit softcap, local (windowed) attention, MoE layers or other
options the port does not carry yet raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Tensor = torch.Tensor


@dataclass
class ModelOutput:
    logits: Tensor
    taps: Optional[Tensor]         # (B, S, num_taps * D)
    cache: Optional[dict]


def tap_layers(n_layers: int, num_taps: int = 3):
    """EAGLE-3 tap layer indices (output-of-layer): 2, L/2, L-1."""
    if num_taps == 1 or n_layers < 3:
        return (n_layers - 1,) * num_taps
    return (min(2, n_layers - 1), n_layers // 2, n_layers - 1)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this port does not carry yet."""
    missing = [name for name, unsupported in (
        (f"family {cfg.family!r}", cfg.family != "dense"),
        ("logit_softcap", cfg.logit_softcap > 0),
        ("final_softcap", cfg.final_softcap > 0),
        ("local/windowed attention", any(k != "global" for k in cfg.attn_pattern)),
        ("MoE layers", cfg.moe.n_experts > 0),
        ("post_norms", cfg.post_norms),
        ("embed_scale", cfg.embed_scale),
        ("nope_on_global", cfg.nope_on_global),
        (f"positional {cfg.positional!r}", cfg.positional != "rope"),
        (f"mlp {cfg.mlp_variant!r}", cfg.mlp_variant != "swiglu"),
        ("untied lm_head", not cfg.tie_embeddings),
    ) if unsupported]
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: not ported yet: {', '.join(missing)}")


# ---------------------------------------------------------------------------
# attention layer
# ---------------------------------------------------------------------------

def attn_apply(p: dict, x: Tensor, *, cfg: ModelConfig, positions: Tensor,
               cache: Optional[dict], mode: str,
               block_table: Optional[Tensor] = None):
    """mode: train | prefill | decode. Returns (out, cache); a cache is
    updated in place. ``block_table`` (B, nb): the cache is a page pool
    (decode only)."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    sin, cos = L.rope_sincos(positions, hd, cfg.rope_theta)
    q = L.apply_rope(q.reshape(B, T, H, hd), sin, cos)
    k = L.apply_rope(k.reshape(B, T, KV, hd), sin, cos)
    v = v.reshape(B, T, KV, hd)
    scale = cfg.q_scale()

    if mode == "decode":
        pos0 = positions[:, 0]
        # two-phase: attend [old cache] + [current block], merge by LSE,
        # THEN insert, so the cache is never copied
        o1, m1, l1 = cache_phase(q, cache, positions, block_table, scale)
        o2, m2, l2 = ops.decode_attention(q, k, v, positions, positions,
                                          scale=scale, return_stats=True)
        out = L.merge_attention(o1, m1, l1, o2, m2, l2)
        if block_table is None:
            L.cache_update(cache, k, v, pos0)
        else:
            L.paged_cache_update(cache, block_table, k, v, pos0)
    else:
        if cache is not None:  # prefill: also populate the cache
            ins = min(T, cache["k"].shape[1])
            L.cache_update(cache, k[:, -ins:], v[:, -ins:],
                           positions[:, T - ins])
        out = ops.flash_attention(q, k, v, scale=scale, causal=True)
    return out.reshape(B, T, H * hd) @ p["wo"], cache


def cache_phase(q: Tensor, cache: dict, positions: Tensor,
                block_table: Optional[Tensor], scale: float):
    """Phase 1 of a two-phase decode: q at ``positions`` (B, T) against
    the cache entries older than the block (position < positions[:, 0]).
    Returns (out, m, l). A contiguous cache masks the newer entries; a paged
    one has them invalidated in the row's pages first (the paged kernel
    takes no per-row bound; the insert that follows invalidates them
    anyway), then the pools are read through the table."""
    pos0 = positions[:, :1]
    if block_table is None:
        old_kpos = torch.where(cache["positions"] >= pos0, -1,
                               cache["positions"])
        return ops.decode_attention(
            q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), old_kpos,
            positions, scale=scale, return_stats=True)
    L.paged_invalidate(cache["positions"], block_table, pos0[:, 0] - 1)
    return ops.paged_decode_attention(
        q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
        cache["positions"], block_table, positions, scale=scale,
        return_stats=True)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def _layer_init(cfg: ModelConfig, g: torch.Generator, device, dtype) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape):
        return L.dense_init(shape, g, device=device, dtype=dtype)

    attn = {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)),
            "wv": dense((d, KV * hd)), "wo": dense((H * hd, d))}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            attn[name] = torch.zeros(n, dtype=dtype, device=device)
    ones = torch.ones(d, dtype=torch.float32, device=device)
    return {"ln1": ones, "ln2": ones.clone(), "attn": attn,
            "mlp": L.mlp_init(d, cfg.d_ff, g, device=device, dtype=dtype)}


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights in ``cfg.dtype`` (norms in float32), drawn from
    ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    return {
        "embed": L.embed_init(cfg.vocab_size, cfg.d_model, generator,
                              device=device, dtype=dtype),
        "blocks": [_layer_init(cfg, generator, device, dtype)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda") -> dict:
    check_supported(cfg)
    return {"blocks": [L.make_kv_cache(batch, max_len, cfg.n_kv_heads,
                                       cfg.head_dim, dtype=dtype,
                                       device=device)
                       for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, tokens: Tensor, *,
            positions: Optional[Tensor] = None, cache: Optional[dict] = None,
            mode: str = "train", collect_taps: bool = True,
            head_last_only: bool = False,
            head_positions: Optional[Tensor] = None,
            block_table: Optional[Tensor] = None) -> ModelOutput:
    """tokens (B, S) int. ``positions`` (B, S) int32 is required in decode
    mode; train/prefill attend by index (the flash kernel's causal mask),
    so they take the default positions 0..S-1 only. ``head_positions``
    (B,) restricts the LM head to one sequence index per row,
    ``head_last_only`` to the last one. ``block_table`` (B, nb) makes the
    cache's layers page pools (decode mode only)."""
    check_supported(cfg)
    B, S = tokens.shape
    if mode == "decode":
        if positions is None or cache is None:
            raise ValueError("decode mode needs positions and a cache")
    elif positions is not None or block_table is not None:
        raise ValueError(f"{mode} attends by index: positions and "
                         f"block_table must be None")
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = params["embed"][tokens]
    taps_idx = tap_layers(cfg.n_layers)
    taps = [None] * len(taps_idx)
    new_blocks = [] if cache is not None else None
    for li, bp in enumerate(params["blocks"]):
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        a, lc = attn_apply(bp["attn"], h, cfg=cfg, positions=positions,
                           cache=None if cache is None else cache["blocks"][li],
                           mode=mode, block_table=block_table)
        x = x + a
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(bp["mlp"], h, cfg.mlp_variant)
        if new_blocks is not None:
            new_blocks.append(lc)
        if collect_taps:
            for i, t in enumerate(taps_idx):
                if t == li:
                    taps[i] = x

    if head_positions is not None:
        x = x[torch.arange(B, device=x.device), head_positions.long()][:, None]
    elif head_last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["embed"].T.to(x.dtype)).float()
    return ModelOutput(
        logits=logits,
        taps=torch.cat(taps, dim=-1) if collect_taps else None,
        cache=None if cache is None else {"blocks": new_blocks})

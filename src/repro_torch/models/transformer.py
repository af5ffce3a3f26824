"""Decoder-only transformer, dense, MoE and VLM families (PyTorch).

Counterpart of the JAX package's ``models/transformer.py`` for dense
targets (qwen2, gemma, gemma2, minitron), MoE targets (dbrx, llama4) and
the VLM target (internvl2).
The JAX model scans super-blocks; here the layers are a Python list and the
forward is a loop. Parameters are plain dicts of tensors:

    {"embed": (V, D), "final_norm": (D,)[, "lm_head": (D, V)]
     [, "vis_proj": {"w1": (vision_dim, D), "w2": (D, D)}],
     "blocks": [{"ln1", "ln2"[, "pn1", "pn2"],
                 "attn": {wq, wk, wv, wo[, bq, bk, bv]},
                 "mlp": {[w_gate,] w_up, w_down}
                 | "moe": {router (D, E) float32, w_gate / w_up (E, D, F),
                           w_down (E, F, D)[, shared: an MLP]}}, ...]}

and the cache is ``{"blocks": [layer cache, ...]}`` with the layer caches
of ``layers.make_kv_cache``. ``convert.py`` turns the JAX package's
scan-stacked trees into these.

Each layer's attention is global or local (``cfg.attn_kind``): a local
layer sees the last ``cfg.window_size`` positions, and its cache is a ring
of ``window + block`` slots when that is shorter than ``max_len`` (see
``make_cache``). ``cfg.logit_softcap`` caps every attention score,
``cfg.final_softcap`` the logits. A layer with ``cfg.is_moe_layer``
holds ``"moe"`` (``models/moe.py``) in place of ``"mlp"``, and the output's
``aux`` sums the layers' ``lb_loss`` and ``z_loss``; with
``cfg.nope_on_global`` a global layer takes no RoPE.

A VLM target's train and prefill take ``vision_embeds`` (B, Tv,
vision_dim), the stub vision encoder's output: projected by ``vis_proj``
(``gelu(x @ w1) @ w2``) and prepended to the text embeddings (early
fusion), so the sequence, its positions and its logits and taps cover Tv +
S; a decode continues at positions past that. With ``cfg.positional ==
"sinusoidal"`` absolute sinusoidal positions are added at the embedding and
no RoPE is applied.

Attention goes through ``kernels.ops``: the flash kernel for the prefill,
the decode kernel for both phases of the two-phase decode. Given a block
table, a decode reads paged caches (``layers.paged_view`` layout): phase 1
of a layer whose cache is a pool goes through the paged decode kernel; a
ring stays per slot and goes through the decode kernel. A layer of kind
"full" (the encoder of ``models/encdec.py``) attends to every key: the
flash kernel without the causal mask. On the card a head dim the kernels
do not take raises ``NotImplementedError``.

Under an active mesh (``sharding.utils``; the storage-sharded engine) the
weights are :class:`~repro_torch.sharding.utils.Shard` s gathered a layer
at a time (``use``: the embedding, each layer, the head) and the caches
hold K/V slices, gathered before each kernel (``cache_phase``) and written
slice by slice (``layers.cache_update``); without one both are the
identity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.sharding import utils as SH

Tensor = torch.Tensor


@dataclass
class ModelOutput:
    logits: Tensor
    taps: Optional[Tensor]         # (B, S, num_taps * D)
    cache: Optional[dict]
    # {"snapshots": per-token recurrent states} of a recurrent target's
    # verify (models/ssm.py); {"lb_loss", "z_loss"} summed over the layers
    # of an MoE target; None for the other attention targets
    aux: Optional[dict] = None


def tap_layers(n_layers: int, num_taps: int = 3):
    """EAGLE-3 tap layer indices (output-of-layer): 2, L/2, L-1."""
    if num_taps == 1 or n_layers < 3:
        return (n_layers - 1,) * num_taps
    return (min(2, n_layers - 1), n_layers // 2, n_layers - 1)


def check_supported(cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError, on a CUDA ``device``, for a head dim the
    attention kernels do not take (checked before any weight or cache is
    made; ``models/registry.py`` gates the family). Positions are RoPE or
    sinusoidal."""
    if cfg.positional not in ("rope", "sinusoidal"):
        raise NotImplementedError(
            f"{cfg.arch_id}: unknown positional {cfg.positional!r}")
    if (device is not None and torch.device(device).type == "cuda"
            and cfg.head_dim not in ops.HEAD_DIMS):
        raise NotImplementedError(
            f"{cfg.arch_id}: head dim {cfg.head_dim} has no kernel on the "
            f"card: the decode, paged decode and flash kernels take head dims "
            f"{ops.HEAD_DIMS}; another head dim needs a body of its own in "
            f"decode_splitk.cuh, flash_tc.cuh and attention_common.cuh")


# ---------------------------------------------------------------------------
# attention layer
# ---------------------------------------------------------------------------

def attn_apply(p: dict, x: Tensor, *, cfg: ModelConfig, kind: str,
               positions: Tensor, cache: Optional[dict], mode: str,
               block_table: Optional[Tensor] = None):
    """kind: global | local | full (every key, train mode: the encoder's).
    mode: train | prefill | decode. Returns (out, cache); a cache is
    updated in place. ``block_table`` (B, nb): a cache that is not a ring
    is a page pool (decode only)."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = q.reshape(B, T, H, hd), k.reshape(B, T, KV, hd), \
        v.reshape(B, T, KV, hd)
    if cfg.positional == "rope" and not (kind == "global"
                                         and cfg.nope_on_global):
        sin, cos = L.rope_sincos(positions, hd, cfg.rope_theta)
        q, k = L.apply_rope(q, sin, cos), L.apply_rope(k, sin, cos)
    scale = cfg.q_scale()
    mask = dict(window=cfg.window_size if kind == "local" else 0,
                softcap=cfg.logit_softcap)

    if mode == "decode":
        pos0 = positions[:, 0]
        table = None if cache["ring"] else block_table
        # two-phase: attend [old cache] + [current block], merge by LSE,
        # THEN insert, so the cache is never copied (and a ring never
        # evicts a key the block's queries still see)
        o1, m1, l1 = cache_phase(q, cache, positions, table, scale, n_kv=KV,
                                 **mask)
        o2, m2, l2 = ops.decode_attention(q, k, v, positions, positions,
                                          scale=scale, return_stats=True,
                                          **mask)
        out = L.merge_attention(o1, m1, l1, o2, m2, l2)
        if table is None:
            L.cache_update(cache, k, v, pos0)
        else:
            L.paged_cache_update(cache, table, k, v, pos0)
    else:
        if cache is not None:  # prefill: also populate the cache
            ins = min(T, cache["k"].shape[1])
            L.cache_update(cache, k[:, -ins:], v[:, -ins:],
                           positions[:, T - ins])
        out = ops.flash_attention(q, k, v, scale=scale,
                                  causal=kind != "full", **mask)
    return out.reshape(B, T, H * hd) @ p["wo"], cache


def cache_phase(q: Tensor, cache: dict, positions: Tensor,
                block_table: Optional[Tensor], scale: float, *, n_kv: int,
                window: int = 0, softcap: float = 0.0):
    """Phase 1 of a two-phase decode: q at ``positions`` (B, T) against
    the cache entries older than the block (position < positions[:, 0]).
    Returns (out, m, l). A contiguous cache masks the newer entries; a paged
    one has them invalidated in the row's pages first (the paged kernel
    takes no per-row bound; the insert that follows invalidates them
    anyway), then the pools are read through the table. Under an active
    mesh the cache's K/V (or pools) are this rank's slices of ``n_kv``
    heads: they are gathered here, so the kernel sees full tensors. The
    paged call stays out of a verify forward's CUDA graph
    (``kernels.ops.outside_graph``): each replay makes it eagerly."""
    pos0 = positions[:, :1]
    hd = q.shape[-1]
    k, v = (t.to(q.dtype) for t in SH.kv_full([cache["k"], cache["v"]],
                                              n_kv, hd))
    if block_table is None:
        old_kpos = torch.where(cache["positions"] >= pos0, -1,
                               cache["positions"])
        return ops.decode_attention(
            q, k, v, old_kpos, positions, scale=scale, window=window,
            softcap=softcap, return_stats=True)
    L.paged_invalidate(cache["positions"], block_table, pos0[:, 0] - 1)
    return ops.outside_graph(
        "paged_decode_attention", q, k, v, cache["positions"], block_table,
        positions, scale=scale, window=window, softcap=softcap,
        return_stats=True)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def attn_init(cfg: ModelConfig, g: torch.Generator, device, dtype,
              qkv_bias: bool) -> dict:
    """One attention layer's projections (and zero biases)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape):
        return L.dense_init(shape, g, device=device, dtype=dtype)

    attn = {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)),
            "wv": dense((d, KV * hd)), "wo": dense((H * hd, d))}
    if qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            attn[name] = torch.zeros(n, dtype=dtype, device=device)
    return attn


def _layer_init(cfg: ModelConfig, layer_idx: int, g: torch.Generator, device,
                dtype) -> dict:
    d = cfg.d_model
    layer = {"attn": attn_init(cfg, g, device, dtype, cfg.qkv_bias)}
    if cfg.is_moe_layer(layer_idx):
        layer["moe"] = moe_init(d, cfg.d_ff, cfg.moe.n_experts,
                                cfg.moe.n_shared_experts, cfg.mlp_variant, g,
                                device=device, dtype=dtype)
    else:
        layer["mlp"] = L.mlp_init(d, cfg.d_ff, g, device=device, dtype=dtype,
                                  variant=cfg.mlp_variant)
    for norm in ("ln1", "ln2") + (("pn1", "pn2") if cfg.post_norms else ()):
        layer[norm] = torch.ones(d, dtype=torch.float32, device=device)
    return layer


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights in ``cfg.dtype`` (norms and routers in float32), drawn
    from ``generator`` (which must live on ``device``)."""
    check_supported(cfg, device)
    dtype = getattr(torch, cfg.dtype)
    params = {
        "embed": L.embed_init(cfg.vocab_size, cfg.d_model, generator,
                              device=device, dtype=dtype),
        "blocks": [_layer_init(cfg, li, generator, device, dtype)
                   for li in range(cfg.n_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init((cfg.d_model, cfg.vocab_size),
                                         generator, device=device,
                                         dtype=dtype)
    if cfg.family == "vlm":     # drawn after the head, as in the JAX package
        params["vis_proj"] = {
            "w1": L.dense_init((cfg.vision_dim, cfg.d_model), generator,
                               device=device, dtype=dtype),
            "w2": L.dense_init((cfg.d_model, cfg.d_model), generator,
                               device=device, dtype=dtype)}
    return params


def ring_length(cfg: ModelConfig, layer_idx: int, max_len: int,
                block: int = 1) -> int:
    """Slots of layer ``layer_idx``'s ring cache, or 0 for a full-length
    cache. A local layer's ring holds ``window + block`` slots, ``block``
    being the widest decode block that may be rolled back (K + 1 for a
    verify): a rejected tail then never evicts a key that a later query's
    window still covers. The JAX package's ring holds ``window`` slots, and
    a rejected draft can overwrite an in-window key. A ring that would not
    be shorter than ``max_len`` is a full-length cache instead."""
    n = cfg.window_size + block
    return n if cfg.attn_kind(layer_idx) == "local" and n < max_len else 0


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda", block: int = 1) -> dict:
    """Per-layer KV caches; local layers get rings of ``ring_length``."""
    check_supported(cfg, device)

    def layer(li):
        ring = ring_length(cfg, li, max_len, block)
        return L.make_kv_cache(batch, ring or max_len, cfg.n_kv_heads,
                               cfg.head_dim, dtype=dtype, ring=ring > 0,
                               device=device)
    return {"blocks": [layer(li) for li in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, tokens: Tensor, *,
            positions: Optional[Tensor] = None, cache: Optional[dict] = None,
            mode: str = "train", collect_taps: bool = True,
            head_last_only: bool = False,
            head_positions: Optional[Tensor] = None,
            block_table: Optional[Tensor] = None,
            vision_embeds: Optional[Tensor] = None) -> ModelOutput:
    """tokens (B, S) int. ``positions`` (B, S) int32 is required in decode
    mode; train/prefill attend by index (the flash kernel's causal mask),
    so they take the default positions 0..S-1 only (0..Tv+S-1 with a VLM
    target's ``vision_embeds`` (B, Tv, vision_dim) prepended).
    ``head_positions`` (B,) restricts the LM head to one sequence index
    per row (an index into the fused sequence), ``head_last_only`` to the
    last one. ``block_table`` (B, nb) makes the cache's layers that are not
    rings page pools (decode mode only)."""
    check_supported(cfg)
    B = tokens.shape[0]
    if mode == "decode" and (positions is None or cache is None):
        raise ValueError("decode mode needs positions and a cache")
    if mode != "decode" and (positions is not None
                             or block_table is not None):
        raise ValueError(f"{mode} attends by index: positions and "
                         f"block_table must be None")
    head = params.get("lm_head")
    # gathered once for the lookup and, tied, the head
    embed = SH.use(params["embed"])
    x = embed[tokens]
    if head is not None:
        embed = None
    if cfg.embed_scale:   # sqrt(d) cast to the activation dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.family == "vlm" and vision_embeds is not None:
        vp = SH.use(params["vis_proj"])
        vis = F.gelu(vision_embeds.to(x.dtype) @ vp["w1"],
                     approximate="tanh") @ vp["w2"]
        x = torch.cat([vis, x], dim=1)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    if cfg.positional == "sinusoidal":
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    taps_idx = tap_layers(cfg.n_layers)
    taps = [None] * len(taps_idx)
    new_blocks = [] if cache is not None else None
    aux = None
    if cfg.moe.n_experts:
        aux = {name: torch.zeros((), dtype=torch.float32, device=x.device)
               for name in ("lb_loss", "z_loss")}
    for li, bp in enumerate(params["blocks"]):
        bp = SH.use(bp)          # this layer's weights, gathered under a mesh
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        a, lc = attn_apply(bp["attn"], h, cfg=cfg, kind=cfg.attn_kind(li),
                           positions=positions,
                           cache=None if cache is None else cache["blocks"][li],
                           mode=mode, block_table=block_table)
        if cfg.post_norms:
            a = L.rms_norm(a, bp["pn1"], cfg.norm_eps)
        x = x + a
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        if "moe" in bp:
            m = cfg.moe
            f, layer_aux = moe_apply(bp["moe"], h, n_experts=m.n_experts,
                                     top_k=m.top_k,
                                     capacity_factor=m.capacity_factor,
                                     variant=cfg.mlp_variant,
                                     n_shared=m.n_shared_experts)
            for name in aux:
                aux[name] = aux[name] + layer_aux[name]
        else:
            f = L.mlp_apply(bp["mlp"], h, cfg.mlp_variant)
        if cfg.post_norms:
            f = L.rms_norm(f, bp["pn2"], cfg.norm_eps)
        x = x + f
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
    logits = x @ (SH.use(head) if head is not None
                  else embed.T.to(x.dtype))
    logits = L.softcap(logits.float(), cfg.final_softcap)
    return ModelOutput(
        logits=logits,
        taps=torch.cat(taps, dim=-1) if collect_taps else None,
        cache=None if cache is None else {"blocks": new_blocks}, aux=aux)

"""P-EAGLE drafter and the AR EAGLE-3 baseline: training forward and
inference (PyTorch).

Counterpart of the JAX package's ``core/drafter.py``. The drafter is a
LLaMA-style transformer conditioned on target hidden states: taps from
target layers (2, L/2, L-1) are concatenated (3·D_t), projected by ``fc`` to
the drafter width and fused with the token embedding through ``fuse``
([emb; hidden] → D), then run through N blocks.

Drafter RoPE position p carries (taps[p], emb(token[p+1])) and predicts
token[p+2]. An MTP slot at depth g > 0 lacks both and takes the
hidden-state variant's input and the mask-token embedding instead.

Parameters are plain dicts; ``blocks`` is a list of per-layer dicts and the
cache is ``{"blocks": [layer cache, ...]}``. At inference both attention
phases of every block go through the decode kernel
(``kernels.ops.decode_attention``) and caches are updated in place; given a
block table, the caches are page pools and phase 1 goes through the paged
decode kernel (``models.transformer.cache_phase``).

Training (``mtp_forward``) runs over COD-expanded positions under the MTP
predicate. On a CUDA tensor every training attention goes through
``core.flash_train.MTPFlashAttention``, whose forward is the MTP kernel;
the AR baseline's causal attention is the predicate with depth 0
everywhere. On the CPU the JAX package's switch applies: the flash
function when ``dcfg.flash_train`` and M >= 512, else autograd through the
plain blocked attention under the predicate mask. ``dcfg.remat``
recomputes each block in the backward (``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.configs.base import DrafterConfig, ModelConfig
from repro_torch.core import spec_decode as SD
from repro_torch.core.flash_train import mtp_flash_attention
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import cache_phase

Tensor = torch.Tensor


def mask_token_id(tcfg: ModelConfig) -> int:
    return tcfg.vocab_size - 1          # reserved unused id (paper §4.3)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(dcfg: DrafterConfig, tcfg: ModelConfig,
                generator: torch.Generator, *, device="cuda",
                dtype=torch.float32) -> dict:
    d, H, KV, hd = dcfg.d_model, dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim

    def dense(shape):
        return L.dense_init(shape, generator, device=device, dtype=dtype)

    def block():
        ones = torch.ones(d, dtype=torch.float32, device=device)
        return {"ln1": ones, "ln2": ones.clone(),
                "attn": {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)),
                         "wv": dense((d, KV * hd)), "wo": dense((H * hd, d))},
                "mlp": L.mlp_init(d, dcfg.d_ff, generator, device=device,
                                  dtype=dtype)}

    def normal(shape):
        return (0.02 * torch.randn(shape, generator=generator, device=device,
                                   dtype=torch.float32)).to(dtype)

    params = {
        "embed": L.embed_init(tcfg.vocab_size, d, generator, device=device,
                              dtype=dtype),
        "fc": dense((dcfg.num_taps * tcfg.d_model, d)),
        "fuse": dense((2 * d, d)),
        "h_shared": normal((d,)),
        "blocks": [block() for _ in range(dcfg.n_layers)],
        "final_norm": torch.ones(d, dtype=torch.float32, device=device),
        "lm_head": dense((d, tcfg.vocab_size)),
    }
    v = dcfg.hidden_state_variant
    if v in ("depth_encoding", "ntp_hidden_depth"):
        params["depth_emb"] = normal((max(dcfg.k_train, dcfg.k_infer) + 1, d))
    if v in ("ntp_hidden", "ntp_hidden_depth", "regularized"):
        params["ntp_proj"] = dense((d, d))
    if v == "regularized":
        params["alpha"] = torch.tensor(0.1, dtype=torch.float32, device=device)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _train_attention(q, k, v, meta, scale):
    """Training attention under the MTP predicate; meta = (pos, depth,
    flash) with pos/depth (B, M) int32."""
    pos, depth, flash = meta
    if q.is_cuda or flash:
        return mtp_flash_attention(q, k, v, pos, depth, scale=scale)
    return ops.mtp_attention_plain(q, k, v, pos, depth, scale=scale)


def _block_apply(dcfg: DrafterConfig, p: dict, x: Tensor, *,
                 positions: Tensor, cache: Optional[dict], mode: str,
                 meta=None, block_table: Optional[Tensor] = None) -> Tensor:
    """mode: "train" attends the whole block under the MTP predicate of
    ``meta`` (no cache); "draft" commits only slot 0 (the NTP position) to
    the cache, "extend" commits every slot (depth-0 tokens). With
    ``block_table`` the cache is a page pool."""
    B, T, _ = x.shape
    H, KV, hd = dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim
    h = L.rms_norm(x, p["ln1"], dcfg.norm_eps)
    sin, cos = L.rope_sincos(positions.clamp_min(0), hd, dcfg.rope_theta)
    q = L.apply_rope((h @ p["attn"]["wq"]).reshape(B, T, H, hd), sin, cos)
    k = L.apply_rope((h @ p["attn"]["wk"]).reshape(B, T, KV, hd), sin, cos)
    v = (h @ p["attn"]["wv"]).reshape(B, T, KV, hd)
    if mode == "train":
        out = _train_attention(q, k, v, meta, hd ** -0.5)
    else:
        # two-phase: [old cache] + [current block], merged by LSE; the
        # block is a single chain, so causal-by-position masking applies
        o1, m1, l1 = cache_phase(q, cache, positions, block_table,
                                 hd ** -0.5)
        o2, m2, l2 = ops.decode_attention(q, k, v, positions, positions,
                                          scale=hd ** -0.5, return_stats=True)
        out = L.merge_attention(o1, m1, l1, o2, m2, l2)
        n = 1 if mode == "draft" else T
        if block_table is None:
            L.cache_update(cache, k[:, :n], v[:, :n], positions[:, 0])
        else:
            L.paged_cache_update(cache, block_table, k[:, :n], v[:, :n],
                                 positions[:, 0])
    x = x + out.reshape(B, T, H * hd) @ p["attn"]["wo"]
    h = L.rms_norm(x, p["ln2"], dcfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, "swiglu")


def _run_blocks(dcfg, params, x, *, positions, cache, mode, meta=None,
                block_table=None):
    """All blocks in order. Inference updates the layer caches in place
    (page pools when ``block_table`` is given); "train" takes no cache and,
    with ``dcfg.remat``, recomputes each block in the backward."""
    if mode == "train":
        for bp in params["blocks"]:
            if dcfg.remat:
                x = checkpoint(_block_apply, dcfg, bp, x, positions=positions,
                               cache=None, mode=mode, meta=meta,
                               use_reentrant=False)
            else:
                x = _block_apply(dcfg, bp, x, positions=positions, cache=None,
                                 mode=mode, meta=meta)
        return x
    for bp, bc in zip(params["blocks"], cache["blocks"]):
        x = _block_apply(dcfg, bp, x, positions=positions, cache=bc,
                         mode=mode, block_table=block_table)
    return x


def _head(dcfg, params, x):
    h = L.rms_norm(x, params["final_norm"], dcfg.norm_eps)
    return (h @ params["lm_head"]).float(), h


def make_cache(dcfg: DrafterConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda") -> dict:
    return {"blocks": [L.make_kv_cache(batch, max_len, dcfg.n_kv_heads,
                                       dcfg.head_dim, dtype=dtype,
                                       device=device)
                       for _ in range(dcfg.n_layers)]}


# ---------------------------------------------------------------------------
# input construction
# ---------------------------------------------------------------------------

def _hidden_inputs(dcfg: DrafterConfig, params: dict, fc_taps: Tensor,
                   depth: Tensor, anchor_fc: Tensor, *,
                   rng: Optional[Tensor] = None) -> Tensor:
    """Per-position drafter 'hidden' input: fc(taps) at depth 0, the variant
    formula at MTP depths. fc_taps (B,M,D) is fc(taps) at each position;
    anchor_fc (B,M,D) fc(taps) at each anchor; depth (M,) or (B, M). The
    regularized variant drops 10% of its injection (inverted dropout), the
    mask ``prng.bernoulli(rng, 0.9, shape)`` as the JAX package draws it,
    and not at all without a key."""
    v = dcfg.hidden_state_variant
    h = params["h_shared"].to(fc_taps.dtype).expand_as(fc_taps)
    if v in ("depth_encoding", "ntp_hidden_depth"):
        de = params["depth_emb"][depth.clamp(0, params["depth_emb"].shape[0] - 1)]
        h = h + de.to(h.dtype)
    if v in ("ntp_hidden", "ntp_hidden_depth", "regularized"):
        inj = anchor_fc @ params["ntp_proj"]
        if v == "regularized":
            if rng is not None:
                keep = prng.bernoulli(rng.to(inj.device), 0.9, inj.shape)
                inj = inj * keep / 0.9
            inj = params["alpha"].to(inj.dtype) * inj
        h = h + inj
    is_ntp = depth == 0
    if is_ntp.dim() == 1:
        is_ntp = is_ntp[None, :]
    return torch.where(is_ntp[..., None], fc_taps, h)


def embed_tokens(dcfg: DrafterConfig, params: dict, tok: Tensor) -> Tensor:
    emb = params["embed"]
    if dcfg.freeze_embeddings:
        emb = emb.detach()
    return emb[tok]


# ---------------------------------------------------------------------------
# training forward (MTP, full or segment)
# ---------------------------------------------------------------------------

def mtp_forward(dcfg: DrafterConfig, tcfg: ModelConfig, params: dict,
                tokens: Tensor, taps: Tensor, pos: Tensor, depth: Tensor, *,
                rng: Optional[Tensor] = None):
    """Training forward over COD-expanded positions.

    tokens (B, n) original sequence; taps (B, n, num_taps·D_t) target taps;
    pos/depth (M,) shared or (B, M) per-row int32 expanded metadata
    (padding: -1). ``rng`` (2,) is the key of the regularized variant's
    dropout.
    Returns (logits (B,M,V) f32, hidden (B,M,D))."""
    B, n = tokens.shape
    if pos.dim() == 1:
        pos = pos[None].expand(B, pos.shape[0])
        depth = depth[None].expand(B, depth.shape[0])
    pos = pos.to(torch.int32).contiguous()
    depth = depth.to(torch.int32).contiguous()
    rows = torch.arange(B, device=tokens.device)[:, None]
    safe_pos = pos.clamp(0, n - 1).long()
    anchor = (pos - depth.clamp_min(0)).clamp(0, n - 1).long()

    fc_all = taps.to(params["fc"].dtype) @ params["fc"]         # (B, n, D)
    hid = _hidden_inputs(dcfg, params, fc_all[rows, safe_pos], depth,
                         fc_all[rows, anchor], rng=rng)
    tok_in = tokens[rows, (safe_pos + 1).clamp(0, n - 1)]
    tok_in = torch.where(depth == 0, tok_in, mask_token_id(tcfg))
    emb = embed_tokens(dcfg, params, tok_in)
    x = torch.cat([emb, hid], dim=-1) @ params["fuse"]
    # the flash path when M is large enough that the plain attention's
    # per-block residuals would dominate memory (always on the card)
    flash = dcfg.flash_train and pos.shape[-1] >= 512
    x = _run_blocks(dcfg, params, x, positions=pos.clamp_min(0), cache=None,
                    mode="train", meta=(pos, depth, flash))
    return _head(dcfg, params, x)


# ---------------------------------------------------------------------------
# inference: extend / parallel draft / AR draft
# ---------------------------------------------------------------------------

def extend(dcfg: DrafterConfig, tcfg: ModelConfig, params: dict, cache: dict,
           tokens_next: Tensor, taps: Tensor, positions: Tensor,
           block_table: Optional[Tensor] = None) -> dict:
    """Commit T depth-0 positions: position p carries (taps[p], emb(t_{p+1})).

    tokens_next (B, T) = tokens p+1 aligned to taps (B, T, 3D_t);
    positions (B, T) int32; ``block_table`` (B, nb) for page-pool caches."""
    fc = taps.to(params["fc"].dtype) @ params["fc"]
    x = torch.cat([params["embed"][tokens_next], fc], dim=-1) @ params["fuse"]
    _run_blocks(dcfg, params, x, positions=positions, cache=cache,
                mode="extend", block_table=block_table)
    return cache


def draft_block_inputs(dcfg, tcfg, params, token_next, taps_last, anchor_pos,
                       K):
    """The K-slot parallel draft block (slot 0 = NTP, 1..K-1 = MTP)."""
    B = token_next.shape[0]
    fc = (taps_last.to(params["fc"].dtype) @ params["fc"])[:, None]   # (B,1,D)
    depth = torch.arange(K, dtype=torch.int32, device=token_next.device)
    fc_b = fc.expand(B, K, fc.shape[-1])
    hid = _hidden_inputs(dcfg, params, fc_b, depth, fc_b)
    tok = torch.where((depth == 0)[None, :], token_next[:, None],
                      mask_token_id(tcfg))
    x = torch.cat([params["embed"][tok], hid], dim=-1) @ params["fuse"]
    positions = anchor_pos[:, None] + depth[None, :]
    return x, positions


def _draw(policy, logits: Tensor, toks: Tensor) -> Tensor:
    """Sampled drafts under ``policy = (keys (B, T, 2), temperature, top_k,
    top_p)``: rows with temperature > 0 draw each slot from the row-warped
    distribution of its logits (B, T, V) with the slot's key; greedy rows
    keep ``toks``."""
    keys, temperature, top_k, top_p = policy
    probs = SD.warp_probs(logits, temperature, top_k, top_p)
    drawn = prng.categorical(keys, torch.log(probs)).to(torch.int32)
    return torch.where((temperature > 0)[:, None], drawn, toks)


def draft_parallel(dcfg: DrafterConfig, tcfg: ModelConfig, params: dict,
                   cache: dict, token_next: Tensor, taps_last: Tensor,
                   anchor_pos: Tensor, K: int,
                   block_table: Optional[Tensor] = None, policy=None):
    """P-EAGLE: one forward pass drafts K tokens (argmax per slot).

    ``policy`` = (keys (B, K, 2), temperature, top_k, top_p (B,)) samples
    the drafts of rows with temperature > 0 from the row-warped drafter
    distribution, one key a slot; greedy rows stay on the argmax. The K
    slots are conditioned on mask tokens in one forward, so their logits do
    not depend on the drafts chosen: drawing after the forward is drawing
    from the proposal the verifier is handed as q.

    Returns (draft_tokens (B,K) int32, draft_logits (B,K,V) f32, cache)."""
    x, positions = draft_block_inputs(dcfg, tcfg, params, token_next,
                                      taps_last, anchor_pos, K)
    x = _run_blocks(dcfg, params, x, positions=positions, cache=cache,
                    mode="draft", block_table=block_table)
    logits, _ = _head(dcfg, params, x)
    toks = logits.argmax(-1).to(torch.int32)
    if policy is not None:
        toks = _draw(policy, logits, toks)
    return toks, logits, cache


def draft_ar(dcfg: DrafterConfig, tcfg: ModelConfig, params: dict,
             cache: dict, token_next: Tensor, taps_last: Tensor,
             anchor_pos: Tensor, K: int,
             block_table: Optional[Tensor] = None, policy=None):
    """AR EAGLE-3 baseline: K sequential single-position forwards; step i
    feeds (token d_i, drafter hidden h_i) into step i+1 (argmax).

    ``policy`` as in :func:`draft_parallel`, drawn inside the loop: slot i
    is fed forward, so slot i+1's logits are conditioned on the slot
    actually drawn, and its warped distribution is the true proposal."""
    hid = taps_last.to(params["fc"].dtype) @ params["fc"]           # (B, D)
    tok = token_next
    toks, logits_all = [], []
    for i in range(K):
        emb = params["embed"][tok[:, None]]                          # (B,1,D)
        x = torch.cat([emb, hid[:, None]], dim=-1) @ params["fuse"]
        positions = (anchor_pos + i)[:, None]
        x = _run_blocks(dcfg, params, x, positions=positions, cache=cache,
                        mode="extend", block_table=block_table)
        logits, h = _head(dcfg, params, x)
        tok = logits[:, 0].argmax(-1).to(torch.int32)
        if policy is not None:
            keys, temperature, top_k, top_p = policy
            tok = _draw((keys[:, i:i + 1], temperature, top_k, top_p),
                        logits, tok[:, None])[:, 0]
        hid = h[:, 0]
        toks.append(tok)
        logits_all.append(logits[:, 0])
    return torch.stack(toks, 1), torch.stack(logits_all, 1), cache

"""RecurrentGemma (Griffin) target model (PyTorch): RG-LRU recurrent layers
and local attention, 1:2. [arXiv:2402.19427]

Counterpart of the JAX package's ``models/hybrid.py``. Layer ``li`` is of
kind ``cfg.hybrid.block_pattern[li % 3]`` (recurrent, recurrent,
attention), the tail included. The JAX model scans super-blocks of the
pattern and runs the ``n_layers % 3`` tail layers after them; here the
layers are a Python list in layer order and the forward is a loop.
Parameters are plain dicts of tensors:

    {"embed": (V, D), "final_norm": (D,),
     "blocks": [{"ln1", "ln2", "mlp": {w_gate, w_up, w_down},
                 "rec": {in_x, in_gate, conv_w, conv_b, w_rec_gate,
                         w_in_gate, lam, out}} |
                {"ln1", "ln2", "mlp", "attn": {wq, wk, wv, wo}}, ...]}

and the cache is ``{"blocks": [layer cache, ...]}``: a recurrent layer's
``{"conv": (B, cw - 1, W), "h": (B, W)}`` (the conv's last ``cw - 1``
inputs in the cache dtype, the RG-LRU state in float32), an attention
layer's KV cache of ``layers.make_kv_cache``, a ring of ``window + block``
slots when that is shorter than ``max_len`` (``transformer.ring_length``;
the JAX model's ring holds ``window`` slots, which a rejected draft can
rob of an in-window key).

A recurrent layer: the gate branch ``gelu(x @ in_gate)``, the branch
``x @ in_x`` through a width-``cw`` causal conv, then the RG-LRU
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * i_t * x_t`` with ``a_t =
sigmoid(lam)^(8 r_t)``, and ``(h * gate) @ out``. The gates are the
products in the activation dtype, then float32; the recurrence is float32.
Train and prefill run it as a log-depth scan over S with the JAX model's
combine (Hillis-Steele doubling: ceil(log2 S) rounds of elementwise ops);
decode walks the tokens, as the JAX model's ``lax.scan`` does. The
attention layers are ``transformer.attn_apply(kind="local")``: the flash
kernel in prefill, the two-phase decode through the decode kernel (a ring
or a contiguous cache) or the paged kernel (a pool).

The speculative verify needs the recurrent state after each token of its
block: ``forward(snapshots=True)`` returns them in ``aux["snapshots"]``
(``{"blocks": [{"conv": (B, T, cw - 1, W), "h": (B, T, W)} or None, ...]}``,
None for attention layers) and leaves the recurrent leaves as they were,
for ``serving.cache_ops.commit`` to write the one it selects (attention
layers insert their keys as always; the commit invalidates the rejected
ones). A snapshot of ``h`` is the state rounded to the activation dtype,
then float32, as the JAX model's (in bfloat16 every verify commit rounds
the state; a prefill or an admission chunk keeps it in float32). Without
``snapshots`` no snapshot is built and the cache is updated in place.
No kernel of its own: the JAX model has no Pallas kernel for the RG-LRU
or the conv.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelOutput, tap_layers
from repro_torch.sharding import utils as SH

Tensor = torch.Tensor
_LRU_C = 8.0


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def slot_kind(cfg: ModelConfig, layer_idx: int) -> str:
    """"recurrent" or "attention": the pattern cycles over every layer."""
    pat = cfg.hybrid.block_pattern
    return pat[layer_idx % len(pat)]


# what the port does not carry of a hybrid target is its attention
# layers' (on a CUDA device: a head dim the kernels do not take)
check_supported = T.check_supported


# ---------------------------------------------------------------------------
# RG-LRU recurrent mixer
# ---------------------------------------------------------------------------

def _rec_init(cfg: ModelConfig, g: torch.Generator, device, dtype) -> dict:
    d, W, cw = cfg.d_model, _lru_width(cfg), cfg.hybrid.conv_width

    def dense(shape, scale=None):
        return L.dense_init(shape, g, device=device, dtype=dtype, scale=scale)

    # lam such that a = sigmoid(lam)^c lies in (0.9, 0.999)
    u = 0.9 + 0.099 * torch.rand(W, generator=g, device=device)
    root = u ** (1.0 / _LRU_C)
    return {
        "in_x": dense((d, W)),
        "in_gate": dense((d, W)),
        "conv_w": dense((cw, W), 0.5),
        "conv_b": torch.zeros(W, dtype=dtype, device=device),
        "w_rec_gate": dense((W, W), 0.02),
        "w_in_gate": dense((W, W), 0.02),
        "lam": torch.log(root / (1 - root)),
        "out": dense((W, d)),
    }


def _conv(xr: Tensor, w: Tensor, b: Tensor, conv_state: Optional[Tensor]):
    """Depthwise causal conv of width cw over xr (B, S, W); conv_state (B,
    cw - 1, W) holds the previous inputs (zeros without a cache). Returns
    (out, the new state, full): full (B, cw - 1 + S, W) is the window the
    per-token conv snapshots are cut from."""
    cw, S = w.shape[0], xr.shape[1]
    hist = (conv_state if conv_state is not None else
            xr.new_zeros((xr.shape[0], cw - 1, xr.shape[-1])))
    full = torch.cat([hist.to(xr.dtype), xr], dim=1)
    out = full[:, 0:S] * w[0]
    for i in range(1, cw):
        out = out + full[:, i:i + S] * w[i]
    return out + b, full[:, S:], full


def _linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1: Hillis-Steele
    doubling with the combine ``(a1 a2, a2 b1 + b2)``, ceil(log2 S) rounds.
    Returns every h_t."""
    S, d = a.shape[1], 1
    a, b = a.clone(), b.clone()
    while d < S:
        b[:, d:] = torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])
        if 2 * d < S:
            a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b


def _rg_lru(xr: Tensor, p: dict, h0: Optional[Tensor], mode: str):
    """xr (B, S, W) after the conv. Returns (h (B, S, W) in xr's dtype, the
    last state (B, W) float32)."""
    r = torch.sigmoid((xr @ p["w_rec_gate"]).float())
    i = torch.sigmoid((xr @ p["w_in_gate"]).float())
    log_a = _LRU_C * r * F.logsigmoid(p["lam"])          # <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) * (
        i * xr.float())
    if mode == "decode":
        h = (h0.float() if h0 is not None else
             gated.new_zeros((gated.shape[0], gated.shape[2])))
        hs = []
        for t in range(xr.shape[1]):
            h = torch.addcmul(gated[:, t], a[:, t], h)
            hs.append(h)
        return torch.stack(hs, dim=1).to(xr.dtype), h
    if h0 is not None:       # fold the carried state into the first step
        gated[:, 0] += a[:, 0] * h0.float()
    hs = _linear_scan(a, gated)
    return hs.to(xr.dtype), hs[:, -1]


def _rec_apply(p: dict, x: Tensor, *, cache: Optional[dict], mode: str,
               snapshots: bool):
    """The recurrent mixer: returns (out, layer snapshots or None). A cache
    is updated in place, except under ``snapshots`` (the verify), whose
    selected snapshot ``cache_ops.commit`` writes."""
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    xr, conv_state, conv_full = _conv(
        x @ p["in_x"], p["conv_w"], p["conv_b"],
        cache["conv"] if cache is not None else None)
    h, h_last = _rg_lru(xr, p, cache["h"] if cache is not None else None,
                        mode)
    out = (h * gate) @ p["out"]
    snaps = None
    if snapshots:
        # the conv window after token t: the inputs ending at t
        cw = p["conv_w"].shape[0]
        conv_snaps = conv_full.unfold(1, cw - 1, 1)[:, 1:].transpose(2, 3)
        snaps = {"conv": conv_snaps.to(cache["conv"].dtype), "h": h.float()}
    elif cache is not None:
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h_last)
    return out, snaps


# ---------------------------------------------------------------------------
# model API (mirrors transformer.py)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights in ``cfg.dtype`` (norms and the RG-LRU's ``lam`` in
    float32), drawn from ``generator`` (which must live on ``device``)."""
    check_supported(cfg, device)
    dtype = getattr(torch, cfg.dtype)
    blocks = []
    for li in range(cfg.n_layers):
        if slot_kind(cfg, li) == "attention":
            blocks.append(T._layer_init(cfg, li, generator, device, dtype))
            continue
        f32 = dict(dtype=torch.float32, device=device)
        blocks.append({
            "ln1": torch.ones(cfg.d_model, **f32),
            "ln2": torch.ones(cfg.d_model, **f32),
            "mlp": L.mlp_init(cfg.d_model, cfg.d_ff, generator, device=device,
                              dtype=dtype, variant=cfg.mlp_variant),
            "rec": _rec_init(cfg, generator, device, dtype)})
    return {
        "embed": L.embed_init(cfg.vocab_size, cfg.d_model, generator,
                              device=device, dtype=dtype),
        "blocks": blocks,
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda", block: int = 1) -> dict:
    """Per-layer caches: a recurrent layer's conv window in ``dtype`` and
    state in float32; an attention layer's KV cache, a ring of
    ``transformer.ring_length`` slots (``block``: the widest decode block
    that may be rolled back) or ``max_len``."""
    check_supported(cfg, device)
    W, cw = _lru_width(cfg), cfg.hybrid.conv_width

    def layer(li):
        if slot_kind(cfg, li) == "recurrent":
            return {"conv": torch.zeros((batch, cw - 1, W), dtype=dtype,
                                        device=device),
                    "h": torch.zeros((batch, W), dtype=torch.float32,
                                     device=device)}
        ring = T.ring_length(cfg, li, max_len, block)
        return L.make_kv_cache(batch, ring or max_len, cfg.n_kv_heads,
                               cfg.head_dim, dtype=dtype, ring=ring > 0,
                               device=device)
    return {"blocks": [layer(li) for li in range(cfg.n_layers)]}


def forward(cfg: ModelConfig, params: dict, tokens: Tensor, *,
            positions: Optional[Tensor] = None, cache: Optional[dict] = None,
            mode: str = "train", collect_taps: bool = True,
            head_last_only: bool = False,
            head_positions: Optional[Tensor] = None,
            block_table: Optional[Tensor] = None,
            snapshots: bool = False) -> ModelOutput:
    """tokens (B, S) int. Decode mode needs ``positions`` (B, S) and a
    cache; train/prefill attend by index (positions 0..S-1). ``block_table``
    (decode only) makes the attention caches that are not rings page pools;
    the recurrent leaves are per slot in both layouts. ``snapshots`` (decode
    only): return each token's recurrent state in ``aux["snapshots"]`` and
    leave the recurrent leaves for ``cache_ops.commit``.
    ``head_positions`` / ``head_last_only`` as in ``transformer.forward``."""
    check_supported(cfg)
    B, S = tokens.shape
    if mode == "decode":
        if positions is None or cache is None:
            raise ValueError("decode mode needs positions and a cache")
    elif positions is not None or block_table is not None or snapshots:
        raise ValueError(f"{mode} attends by index and takes no snapshots: "
                         f"positions, block_table and snapshots must be unset")
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    embed = SH.use(params["embed"])     # the lookup's and the head's
    x = embed[tokens]
    if cfg.embed_scale:   # sqrt(d) cast to the activation dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    taps_idx = tap_layers(cfg.n_layers)
    taps = [None] * len(taps_idx)
    snap_blocks = [] if snapshots else None
    for li, bp in enumerate(params["blocks"]):
        bp = SH.use(bp)          # this layer's weights, gathered under a mesh
        lc = None if cache is None else cache["blocks"][li]
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        snaps = None
        if slot_kind(cfg, li) == "recurrent":
            mix, snaps = _rec_apply(bp["rec"], h, cache=lc, mode=mode,
                                    snapshots=snapshots)
        else:
            mix, _ = T.attn_apply(bp["attn"], h, cfg=cfg, kind="local",
                                  positions=positions, cache=lc, mode=mode,
                                  block_table=block_table)
        x = x + mix
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(bp["mlp"], h, cfg.mlp_variant)
        if snapshots:
            snap_blocks.append(snaps)
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
    return ModelOutput(
        logits=logits,
        taps=torch.cat(taps, dim=-1) if collect_taps else None,
        cache=cache,
        aux={"snapshots": ({"blocks": snap_blocks} if snapshots else None)})

"""Mamba-2 (SSD, state-space duality) target model (PyTorch).
[arXiv:2405.21060]

Counterpart of the JAX package's ``models/ssm.py``. Attention-free: each
block is an SSD mixer (in_proj, a depthwise causal conv over (x, B, C), the
selective state-space scan, a gated RMSNorm, out_proj). The JAX model scans
stacked blocks; here the layers are a Python list and the forward is a
loop. Parameters are plain dicts of tensors:

    {"embed": (V, D), "final_norm": (D,),
     "blocks": [{"ln", "in_proj", "conv_w", "conv_b", "A_log", "dt_bias",
                 "D", "gnorm", "out_proj"}, ...]}

and the cache is ``{"blocks": [{"conv": (B, cw - 1, C), "state": (B, H, P,
N)}, ...]}``: the raw conv inputs of the last ``cw - 1`` positions in the
cache dtype, and the SSD state in float32.

Train and prefill run the chunked SSD scan (quadratic within chunks of the
largest divisor of S up to ``chunk_size``, a loop over chunk states).
Decode steps the recurrence token by token (``_ssd_step``), as the JAX
model does. The speculative verify needs the state after each token of its
block, to roll back to the last accepted one: ``forward(snapshots=True)``
returns them in ``aux["snapshots"]`` (``{"blocks": [{"conv": (B, T, cw - 1,
C), "state": (B, T, H, P, N)}, ...]}``) and leaves the cache's leaves as
they were, for ``serving.cache_ops.commit`` to write the snapshot it
selects. Without it (prefill, the decode-mode admission chunks) no
snapshot is built: under ``jit`` the JAX model's unread snapshots are
dropped, and an eager port would hold T of them (75.5 MB a slot each for
mamba2-780m) for nothing. Every other call updates the cache in place.

Dtypes follow the JAX model: the state and the scan in float32, every
contraction accumulated in float32 (bfloat16 operands are upcast first), the
conv window in the cache dtype, the mixer's output in the activation dtype.
No kernel: the JAX model has no Pallas kernel here, and the drafter (which
is attention-based for every target family) runs the ported ones.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import ModelOutput, tap_layers
from repro_torch.sharding import utils as SH

Tensor = torch.Tensor


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    H = d_inner // cfg.ssm.head_dim
    return d_inner, H, cfg.ssm.head_dim, cfg.ssm.d_state


def check_supported(cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError for what this port does not carry yet."""
    if cfg.moe.n_experts > 0:
        raise NotImplementedError(f"{cfg.arch_id}: not ported yet: MoE layers")


# ---------------------------------------------------------------------------
# per-layer parameters
# ---------------------------------------------------------------------------

def _uniform(n: int, lo: float, hi: float, g: torch.Generator, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def _mixer_init(cfg: ModelConfig, g: torch.Generator, device, dtype) -> dict:
    d_inner, H, P, N = _dims(cfg)
    cw = cfg.ssm.conv_width
    conv_ch = d_inner + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = L.dense_init((cfg.d_model, 2 * d_inner + 2 * N + H), g,
                           device=device, dtype=dtype)
    conv_w = L.dense_init((cw, conv_ch), g, device=device, dtype=dtype,
                          scale=0.5)
    A_log = torch.log(_uniform(H, 1.0, 16.0, g, device))
    dt = torch.exp(_uniform(H, math.log(1e-3), math.log(1e-1), g, device))
    return {
        "ln": torch.ones(cfg.d_model, **f32),
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": A_log,
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),   # softplus^-1(dt)
        "D": torch.ones(H, **f32),
        "gnorm": torch.ones(d_inner, **f32),
        "out_proj": L.dense_init((d_inner, cfg.d_model), g, device=device,
                                 dtype=dtype),
    }


def _split_proj(cfg: ModelConfig, proj: Tensor):
    d_inner, H, P, N = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(xBC: Tensor, w: Tensor, b: Tensor,
                 conv_state: Optional[Tensor]):
    """Depthwise causal conv of width cw over xBC (B, S, C); conv_state
    (B, cw - 1, C) holds the previous raw inputs (zeros without a cache).
    Returns (silu(out), new_state, full): full (B, cw - 1 + S, C) is the
    window the per-token conv snapshots are cut from."""
    cw = w.shape[0]
    S = xBC.shape[1]
    hist = (conv_state if conv_state is not None else
            xBC.new_zeros((xBC.shape[0], cw - 1, xBC.shape[-1])))
    full = torch.cat([hist.to(xBC.dtype), xBC], dim=1)
    out = full[:, 0:S] * w[0]
    for i in range(1, cw):
        out = out + full[:, i:i + S] * w[i]
    return F.silu(out + b), full[:, S:], full


def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int, init_state=None):
    """Chunked SSD scan. x (B, S, H, P), dt (B, S, H) after the softplus,
    A (H,) negative, Bm / Cm (B, S, N) float32. Returns (y (B, S, H, P) in
    x's dtype, final_state (B, H, P, N) float32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xq = x.reshape(Bsz, nc, chunk, H, P).float()
    dq = dt.reshape(Bsz, nc, chunk, H)
    Bq = Bm.reshape(Bsz, nc, chunk, N)
    Cq = Cm.reshape(Bsz, nc, chunk, N)
    csum = torch.cumsum(dq * A, dim=2)        # (B, nc, Q, H) log-decays

    # intra-chunk, quadratic in the chunk. Above the diagonal csum_i -
    # csum_j is positive and its exp may overflow: the where drops it (a
    # product with a 0/1 mask would turn inf into nan)
    cb = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    decay = torch.exp(csum[:, :, :, None, :] - csum[:, :, None, :, :])
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    w = torch.where(causal, cb[..., None] * decay, 0.0)   # (B, nc, Q, Q, H)
    y = torch.einsum("bcijh,bcjhp->bcihp", w * dq[:, :, None], xq)

    # each chunk's contribution to the running state
    last = csum[:, :, -1:, :]
    st = torch.einsum("bcjh,bcjn,bcjhp->bchpn", torch.exp(last - csum) * dq,
                      Bq, xq)
    state = (init_state.float() if init_state is not None else
             x.new_zeros((Bsz, H, P, N), dtype=torch.float32))
    chunk_decay = torch.exp(last[:, :, 0])    # (B, nc, H)
    prev = []
    for c in range(nc):                       # the state before each chunk
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + st[:, c]
    prev_states = torch.stack(prev, dim=1)    # (B, nc, H, P, N)

    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cq, prev_states,
                           torch.exp(csum))
    out = (y + y_inter).reshape(Bsz, S, H, P) + D[None, None, :, None] * x
    return out.to(x.dtype), state


def _ssd_step(x, dt, A, Bm, Cm, D, state, snapshots: bool):
    """Sequential decode over T tokens, shapes as ``_ssd_chunked``'s with S
    = T. Returns (y, state after the last token, and with ``snapshots``
    the state after each token (B, T, H, P, N), else None)."""
    s = state.float()
    xf = x.float()
    ys, snaps = [], []
    for t in range(x.shape[1]):
        dtt = dt[:, t]                                     # (B, H)
        s = s * torch.exp(dtt * A)[:, :, None, None] + (
            dtt[:, :, None, None] * xf[:, t, :, :, None]
            * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], s))
        if snapshots:
            snaps.append(s)
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * x
    return (y.to(x.dtype), s,
            torch.stack(snaps, dim=1) if snapshots else None)


def _mixer_apply(cfg: ModelConfig, p: dict, x: Tensor, *,
                 cache: Optional[dict], mode: str, snapshots: bool):
    """One SSD block: returns (x + mixer(x), layer snapshots or None). A
    cache is updated in place, except under ``snapshots`` (the verify),
    whose selected snapshot ``cache_ops.commit`` writes."""
    d_inner, H, P, N = _dims(cfg)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xBC, dt_raw = _split_proj(cfg, h @ p["in_proj"])
    xBC, conv_state, conv_full = _causal_conv(
        xBC, p["conv_w"], p["conv_b"],
        cache["conv"] if cache is not None else None)
    xs, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    Bsz, S = xs.shape[:2]
    xh = xs.reshape(Bsz, S, H, P)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    snaps = None
    if mode == "decode":
        y, state, st_snaps = _ssd_step(xh, dt, A, Bm.float(), Cm.float(),
                                       p["D"], cache["state"], snapshots)
        if snapshots:
            # the conv window after token t: the raw inputs ending at t
            cw = p["conv_w"].shape[0]
            conv_snaps = torch.stack(
                [conv_full[:, t + 1:t + cw] for t in range(S)], dim=1)
            snaps = {"conv": conv_snaps.to(cache["conv"].dtype),
                     "state": st_snaps}
    else:
        chunk = min(cfg.ssm.chunk_size, S)
        while S % chunk:
            chunk -= 1
        y, state = _ssd_chunked(xh, dt, A, Bm.float(), Cm.float(), p["D"],
                                chunk)

    y = y.reshape(Bsz, S, d_inner)
    y = L.rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if cache is not None and not snapshots:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
    return x + out, snaps


# ---------------------------------------------------------------------------
# model API (mirrors transformer.py)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random weights in ``cfg.dtype`` (norms and the SSD's A, dt and D in
    float32), drawn from ``generator`` (which must live on ``device``)."""
    check_supported(cfg, device)
    dtype = getattr(torch, cfg.dtype)
    return {
        "embed": L.embed_init(cfg.vocab_size, cfg.d_model, generator,
                              device=device, dtype=dtype),
        "blocks": [_mixer_init(cfg, generator, device, dtype)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda", block: int = 1) -> dict:
    """Per-layer recurrent caches: the conv window in ``dtype``, the state
    in float32. Their size does not grow with ``max_len``; ``block`` (which
    sizes attention rings) does not apply."""
    check_supported(cfg, device)
    d_inner, H, P, N = _dims(cfg)
    cw = cfg.ssm.conv_width

    def layer():
        return {"conv": torch.zeros((batch, cw - 1, d_inner + 2 * N),
                                    dtype=dtype, device=device),
                "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                                     device=device)}
    return {"blocks": [layer() for _ in range(cfg.n_layers)]}


def forward(cfg: ModelConfig, params: dict, tokens: Tensor, *,
            positions: Optional[Tensor] = None, cache: Optional[dict] = None,
            mode: str = "train", collect_taps: bool = True,
            head_last_only: bool = False,
            head_positions: Optional[Tensor] = None,
            block_table: Optional[Tensor] = None,
            snapshots: bool = False) -> ModelOutput:
    """tokens (B, S) int. Decode mode needs a cache (``positions`` are
    accepted and unused: the recurrence has no position; ``block_table``
    too, as the state is per slot in both layouts). ``snapshots`` (decode
    only): return each token's state in ``aux["snapshots"]`` and leave the
    cache for ``cache_ops.commit``. ``head_positions`` / ``head_last_only``
    as in ``transformer.forward``."""
    check_supported(cfg)
    B, S = tokens.shape
    if mode == "decode" and cache is None:
        raise ValueError("decode mode needs a cache")
    if snapshots and mode != "decode":
        raise ValueError("snapshots are taken in decode mode only")
    embed = SH.use(params["embed"])     # the lookup's and the head's
    x = embed[tokens]
    taps_idx = tap_layers(cfg.n_layers)
    taps = [None] * len(taps_idx)
    snap_blocks = [] if snapshots else None
    for li, bp in enumerate(params["blocks"]):
        bp = SH.use(bp)          # this layer's weights, gathered under a mesh
        x, snaps = _mixer_apply(
            cfg, bp, x, cache=None if cache is None else cache["blocks"][li],
            mode=mode, snapshots=snapshots)
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

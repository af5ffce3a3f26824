"""Shared neural-net primitives for the target and the drafter (PyTorch).

Counterpart of the JAX package's ``models/layers.py``, with its layouts:
activations ``(B, S, D)``, heads ``(B, S, H, head_dim)``, weights
``(d_in, d_out)`` applied as ``x @ W``; norms, softmax statistics and
accumulations in float32.

``blocked_attention`` is the plain-PyTorch online-softmax attention (a
Python loop over KV blocks). The kernels' plain versions in
``kernels/ops.py`` are built on it, so it is what runs on the CPU where the
CUDA kernels run on the card. Masks are predicates over absolute positions,
as in the JAX package.

KV caches are updated in place (``cache_update``): a full-width cache is
hundreds of MB, and the serving loop never reads a cache after writing its
successor.

A paged KV cache has the same leaves as a pool of pages shared by every
row: k/v (NP, page, KV, hd) and positions (NP, page), which row b reaches
through its block table (B, nb), page ids per ``page`` positions, -1 =
unallocated. A page belongs to at most one row. The pool's last page is the
sink: no table names it, and writes that fall on an unallocated page land
there (the JAX scatter's ``mode="drop"``, without a host sync).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(shape, generator: torch.Generator, *, device, dtype,
               scale: Optional[float] = None) -> Tensor:
    """Truncated-normal fan-in init (as the JAX package's ``dense_init``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(dtype)


def embed_init(vocab: int, d: int, generator: torch.Generator, *, device,
               dtype) -> Tensor:
    return dense_init((vocab, d), generator, device=device, dtype=dtype,
                      scale=0.02)


# ---------------------------------------------------------------------------
# norms / positions / activations
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_sincos(positions: Tensor, head_dim: int, theta: float):
    """positions (..., T) int -> sin/cos (..., T, head_dim//2) float32."""
    half = head_dim // 2
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exponent)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: Tensor, sin: Tensor, cos: Tensor) -> Tensor:
    """Half-split rotation. x (B, T, H, hd); sin/cos (B, T, hd/2) or
    (T, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if sin.dim() == 2:
        s, c = sin[None, :, None, :], cos[None, :, None, :]
    else:
        s, c = sin[:, :, None, :], cos[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(d: int, f: int, generator: torch.Generator, *, device,
             dtype) -> dict:
    return {"w_gate": dense_init((d, f), generator, device=device, dtype=dtype),
            "w_up": dense_init((d, f), generator, device=device, dtype=dtype),
            "w_down": dense_init((f, d), generator, device=device, dtype=dtype)}


def mlp_apply(p: dict, x: Tensor, variant: str) -> Tensor:
    if variant != "swiglu":
        raise NotImplementedError(f"mlp variant {variant!r} is not ported")
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# blocked attention (online softmax over KV blocks)
# ---------------------------------------------------------------------------

MaskFn = Callable[[Tensor, Tensor], Tensor]   # (q_idx (Sq,), k_idx (Bk,)) -> bool


def cache_mask_fn(q_positions: Tensor, k_positions: Tensor,
                  window: int = 0) -> MaskFn:
    """Decode against a cache with stored absolute positions.

    q_positions (B, Sq); k_positions (B, W) with -1 for empty slots."""
    def fn(q_idx, k_idx):
        qp = q_positions[:, q_idx]                        # (B, Sq)
        kp = k_positions[:, k_idx]                        # (B, Bk)
        ok = (kp[:, None, :] <= qp[:, :, None]) & (kp[:, None, :] >= 0)
        if window > 0:
            ok &= (qp[:, :, None] - kp[:, None, :]) < window
        return ok[:, None, None]                          # (B,1,1,Sq,Bk)
    return fn


def blocked_attention(q: Tensor, k: Tensor, v: Tensor, *, scale: float,
                      mask_fn: Optional[MaskFn] = None,
                      logit_cap: float = 0.0, block_k: int = 512,
                      return_stats: bool = False):
    """Flash-style attention in plain PyTorch.

    q (B, Sq, H, hd); k/v (B, Skv, KV, hd) with H % KV == 0 (GQA). mask_fn
    maps (q_idx, k_idx) index vectors to a bool tensor broadcastable to
    (B, KV, G, Sq, Bk). Scores, p and accumulators are float32.

    Keys are walked in blocks of ``block_k``; the last block holds the
    ragged remainder (Skv need not be a multiple of the block).

    With return_stats=True also returns the online-softmax (m, l), shaped
    (B, KV, G, Sq), for ``merge_attention``."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qr = q.reshape(B, Sq, KV, G, hd).float()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    q_idx = torch.arange(Sq, device=dev)
    for j0 in range(0, Skv, block_k):
        kj = k[:, j0:j0 + block_k].float()
        vj = v[:, j0:j0 + block_k].float()
        s = torch.einsum("bqkgd,bjkd->bkgqj", qr, kj) * scale
        if logit_cap > 0.0:
            s = logit_cap * torch.tanh(s / logit_cap)
        ok = None
        if mask_fn is not None:
            ok = mask_fn(q_idx, torch.arange(j0, j0 + kj.shape[1], device=dev))
            s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if ok is not None:   # fully-masked rows: exp(NEG_INF - NEG_INF) = 1
            p = torch.where(ok, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqj,bjkd->bkgqd", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = torch.where((l > 0)[..., None], out, 0.0)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    if return_stats:
        return out, m, l
    return out


def merge_attention(o1: Tensor, m1: Tensor, l1: Tensor,
                    o2: Tensor, m2: Tensor, l2: Tensor) -> Tensor:
    """Exact merge of two online-softmax passes over disjoint key sets.

    o* (B, Sq, H, hd) normalized outputs; m*/l* (B, KV, G, Sq)."""
    B, Sq, H, hd = o1.shape
    m = torch.maximum(m1, m2)
    w1 = l1 * torch.exp(m1 - m)
    w2 = l2 * torch.exp(m2 - m)
    l = w1 + w2
    w1 = w1 / l.clamp_min(1e-30)
    w2 = w2 / l.clamp_min(1e-30)

    def rs(w):   # (B, KV, G, Sq) -> (B, Sq, H, 1)
        return w.permute(0, 3, 1, 2).reshape(B, Sq, H)[..., None]

    out = o1.float() * rs(w1) + o2.float() * rs(w2)
    out = torch.where(rs(l) > 0, out, 0.0)
    return out.to(o1.dtype)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def make_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, *,
                  dtype=torch.bfloat16, ring: bool = False,
                  device="cuda") -> dict:
    """One layer's KV cache. ``positions`` holds the absolute position of
    each slot (-1 = empty); ``ring`` is a Python bool."""
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "positions": torch.full((batch, max_len), -1, dtype=torch.int32,
                                device=device),
        "ring": ring,
    }


def cache_update(cache: dict, k_new: Tensor, v_new: Tensor,
                 pos: Tensor) -> dict:
    """Insert T new tokens at per-row absolute positions ``pos`` (B,), in
    place, and return the cache.

    Entries with position >= pos are stale history being rewritten
    (speculative rollback) and are invalidated first. A ring cache writes
    slot ``position % W``; a plain cache writes slot ``position``, which
    the caller keeps below W (the engine checks its length budget up
    front)."""
    B, T = k_new.shape[0], k_new.shape[1]
    W = cache["k"].shape[1]
    positions = cache["positions"]
    positions.masked_fill_(positions >= pos[:, None], -1)
    abs_pos = pos[:, None] + torch.arange(T, dtype=pos.dtype,
                                          device=pos.device)[None]
    slot = (abs_pos % W if cache["ring"] else abs_pos).long()
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, T)
    cache["k"][rows, slot] = k_new.to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new.to(cache["v"].dtype)
    positions[rows, slot] = abs_pos.to(positions.dtype)
    return cache


# ---------------------------------------------------------------------------
# paged KV caches (a shared pool of pages behind per-row block tables)
# ---------------------------------------------------------------------------

def paged_view(pool: Tensor, block_table: Tensor, empty=None) -> Tensor:
    """Each row's pages of ``pool`` (NP, page, ...) laid end to end:
    (B, nb * page, ...). Table entries outside [0, NP) (-1 = unallocated)
    read page 0, or hold ``empty`` where it is given (positions pass -1)."""
    NP, page = pool.shape[0], pool.shape[1]
    B, nb = block_table.shape
    ok = (block_table >= 0) & (block_table < NP)
    view = pool[torch.where(ok, block_table, 0).long()]    # (B, nb, page, ...)
    if empty is not None:
        view = view.masked_fill(~ok.view((B, nb) + (1,) * (pool.dim() - 1)),
                                empty)
    return view.reshape((B, nb * page) + tuple(pool.shape[2:]))


def paged_invalidate(positions: Tensor, block_table: Tensor,
                     bound: Tensor) -> Tensor:
    """In place: in every pool page that row b's table names, entries whose
    position exceeds ``bound[b]`` become empty (-1). positions (NP, page);
    block_table (B, nb); bound (B,). Pages no table names are untouched.
    Returns ``positions``."""
    NP = positions.shape[0]
    ok = (block_table >= 0) & (block_table < NP)
    idx = torch.where(ok, block_table, NP).long().flatten()
    lim = torch.full((NP + 1,), INT32_MAX, dtype=positions.dtype,
                     device=positions.device)
    lim.scatter_(0, idx, bound.to(positions.dtype)[:, None]
                 .expand(block_table.shape).flatten())
    return positions.masked_fill_(positions > lim[:NP, None], -1)


def paged_cache_update(cache: dict, block_table: Tensor, k_new: Tensor,
                       v_new: Tensor, pos: Tensor) -> dict:
    """Write T new tokens at per-row absolute positions ``pos`` (B,) into the
    pool pages of each row's table, in place, and return the cache. A write
    whose page is unallocated (-1) or past the table goes to the sink page.

    Unlike ``cache_update`` this does not invalidate entries >= pos: the
    decode step does that with ``paged_invalidate`` before it attends to
    the pool, since the paged kernel takes no per-row bound."""
    positions = cache["positions"]
    NP, page = positions.shape
    B, T = k_new.shape[0], k_new.shape[1]
    nb = block_table.shape[1]
    abs_pos = pos[:, None] + torch.arange(T, dtype=pos.dtype,
                                          device=pos.device)[None]
    blk = torch.div(abs_pos, page, rounding_mode="floor")
    pg = block_table.gather(1, blk.clamp(0, nb - 1).long())
    ok = (blk >= 0) & (blk < nb) & (pg >= 0) & (pg < NP - 1)
    pg = torch.where(ok, pg, NP - 1).long()
    off = torch.remainder(abs_pos, page).long()
    cache["k"][pg, off] = k_new.to(cache["k"].dtype)
    cache["v"][pg, off] = v_new.to(cache["v"].dtype)
    positions[pg, off] = abs_pos.to(positions.dtype)
    return cache

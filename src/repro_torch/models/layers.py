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

import contextlib
import functools
import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import utils as SH

Tensor = torch.Tensor
NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

# the per-leaf hooks of the builds in progress (``keeping``), innermost last
_KEEP: List[Callable] = []


@contextlib.contextmanager
def keeping(keep: Optional[Callable]):
    """Within the block, each weight a ``dense_init`` draws (and each leaf
    an init passes to ``kept``) is handed to ``keep`` right after its draw,
    and what ``keep`` returns stands in the tree: a leaf-by-leaf build
    (``Model.init(keep=)``, ``core.drafter.init_params(keep=)``) keeps a
    slice and frees the drawn leaf before the next is drawn. None: nothing
    changes. The draws and their order are the same with and without a
    hook."""
    if keep is None:
        yield
        return
    _KEEP.append(keep)
    try:
        yield
    finally:
        _KEEP.pop()


def kept(w):
    """What the active hook keeps of the drawn leaf ``w`` (``w`` without
    one)."""
    return _KEEP[-1](w) if _KEEP else w


def dense_init(shape, generator: torch.Generator, *, device, dtype,
               scale: Optional[float] = None):
    """Truncated-normal fan-in init (as the JAX package's ``dense_init``),
    drawn in float32 and cast, scaled in place: a leaf peaks at its float32
    draw plus its cast. Returns what ``kept`` keeps of it."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    w = w.mul_(std).to(dtype)
    return kept(w)


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
    # a fill, not a copy from the host: capturable in a CUDA graph
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
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



# XLA's float32 exp on the CPU (Cephes): e^x = e^a * 2^n, n = floor(x /
# ln 2 + 1/2), a = x - n ln 2 in two parts, e^a by a degree-6 polynomial
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _xla_exp(x: Tensor) -> Tensor:
    """float32 exp of a host tensor as XLA's compiled graphs compute it,
    one rounding per operation, so that a float32 angle built on it is the
    JAX package's bit for bit (torch's exp differs by an ulp on some
    inputs)."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32)
    x = x.clamp(-104.0, 88.8)
    n = torch.floor(x * c(1.44269504088896341) + c(0.5)).clamp(-126, 127)
    a = x - n * c(0.693359375)
    a = a - n * c(-2.12194440e-4)
    z = a * c(_EXP_POLY[0]) + c(_EXP_POLY[1])
    for p in _EXP_POLY[2:]:
        z = z * a + c(p)
    z = z * (a * a) + a
    return torch.ldexp(z + c(1.0), n.to(torch.int32))


def sinusoidal_positions(positions: Tensor, d: int) -> Tensor:
    """Whisper-style absolute sinusoidal embeddings, (..., T) -> (..., T,
    d) float32: the angle ``position * exp(-i * log(1e4) / (half - 1))``
    in float32 as the JAX package's compiled forward forms it (the factor
    rounded to float32 first, XLA's exp), then sin and cos
    concatenated."""
    ang = positions.float()[..., None] * _sinusoid_rates(d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@functools.lru_cache(maxsize=None)
def _sinusoid_rates(d: int, device: torch.device) -> Tensor:
    """The (d // 2,) float32 rates of ``sinusoidal_positions``: they depend
    on d alone, so each (d, device) is made once on the host and copied to
    the device once."""
    half = d // 2
    rate = torch.tensor(math.log(10_000.0) / max(half - 1, 1),
                        dtype=torch.float32)
    return _xla_exp(-torch.arange(half, dtype=torch.float32)
                    * rate).to(device)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def softcap(x: Tensor, cap: float) -> Tensor:
    """``cap * tanh(x / cap)``; x unchanged when cap is 0."""
    return cap * torch.tanh(x / cap) if cap > 0.0 else x


def mlp_init(d: int, f: int, generator: torch.Generator, *, device, dtype,
             variant: str = "swiglu") -> dict:
    """Gated variants (swiglu, geglu) have w_gate, w_up, w_down; relu2 and
    gelu only w_up, w_down (as the JAX package's ``mlp_init``)."""
    names = (("w_gate", "w_up") if variant in ("swiglu", "geglu")
             else ("w_up",))
    p = {n: dense_init((d, f), generator, device=device, dtype=dtype)
         for n in names}
    p["w_down"] = dense_init((f, d), generator, device=device, dtype=dtype)
    return p


def mlp_apply(p: dict, x: Tensor, variant: str) -> Tensor:
    """GELUs are tanh-approximate, as ``jax.nn.gelu(approximate=True)``."""
    if variant == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif variant == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    elif variant == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    elif variant == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown mlp variant {variant!r}")
    return h @ p["w_down"]


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



def full_attention(q: Tensor, k: Tensor, v: Tensor, *, scale: float) -> Tensor:
    """Unmasked attention in one pass (the JAX package's ``full_attention``
    without mask or cap): q (B, Sq, H, hd) over every key of k/v (B, Skv,
    KV, hd), GQA, scores and softmax in float32, the output in q's dtype.
    The port's paths do not call it: ``models/encdec.py`` runs its unmasked
    attention through ``kernels.ops`` (the kernels on the card, their plain
    versions on the CPU). It is the reference the tests hold those paths
    against."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qr = q.reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qr, k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqj,bjkd->bkgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)

# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def make_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, *,
                  dtype=torch.bfloat16, ring: bool = False,
                  device="cuda") -> dict:
    """One layer's KV cache. ``positions`` holds the absolute position of
    each slot (-1 = empty); ``ring`` is a Python bool. Under an active
    mesh (``sharding.utils.mesh_scope``) K/V hold this rank's slice of
    their trailing (KV, hd) axes."""
    shape = (batch, max_len, n_kv, head_dim)
    return {
        "k": SH.kv_zeros(shape, dtype=dtype, device=device),
        "v": SH.kv_zeros(shape, dtype=dtype, device=device),
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
    front). A ring takes only the last W of a block longer than itself
    (a long admission chunk), so no two entries share a slot. Under an
    active mesh the cache holds this rank's K/V slice, and takes its slice
    of ``k_new`` / ``v_new``."""
    k_new, v_new = SH.kv_local(k_new), SH.kv_local(v_new)
    B, T = k_new.shape[0], k_new.shape[1]
    W = cache["k"].shape[1]
    positions = cache["positions"]
    positions.masked_fill_(positions >= pos[:, None], -1)
    if cache["ring"] and T > W:
        k_new, v_new, pos, T = k_new[:, -W:], v_new[:, -W:], pos + (T - W), W
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
    the pool, since the paged kernel takes no per-row bound. Under an
    active mesh the pools take this rank's slice of the new K/V."""
    k_new, v_new = SH.kv_local(k_new), SH.kv_local(v_new)
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

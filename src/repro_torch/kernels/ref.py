"""Plain-PyTorch twins of the JAX package's attention oracles
(``kernels/ref.py``): dense-mask softmax attention, the ground truth the
kernels and their plain versions are held against; and the split-K decode
kernel's combine pass, written out in plain PyTorch."""
from __future__ import annotations

import torch

from repro_torch.core.masks import mtp_mask_predicate

NEG_INF = -1e30


def _attend(q, k, v, ok, scale, softcap=0.0):
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd); ok broadcastable to
    (B, KV, G, Sq, Skv)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qr, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqj,bjkd->bkgqd", p, v.float())
    out = torch.where(ok.any(-1)[..., None], out, 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def attention_reference(q, k, v, *, scale, causal=True, window=0,
                        softcap=0.0):
    """Index-causal (or sliding-window, or full) attention."""
    Sq, Skv = q.shape[1], k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    return _attend(q, k, v, ok, scale, softcap)


def decode_reference(q, k, v, k_positions, q_positions, *, scale, window=0):
    """q (B,T,H,hd) against cache k/v (B,S,KV,hd) with per-slot absolute
    positions (B,S) (-1 = empty) and query positions (B,T)."""
    kp = k_positions[:, None, :]
    qp = q_positions[:, :, None]
    ok = (kp <= qp) & (kp >= 0)
    if window > 0:
        ok &= (qp - kp) < window
    return _attend(q, k, v, ok[:, None, None], scale)


def paged_decode_reference(q, k_pool, v_pool, pos_pool, block_table,
                           q_positions, *, scale, window=0):
    """Paged decode: each row's contiguous view gathered from the pool
    (unallocated entries read page 0 with positions -1), then the dense
    decode reference on it."""
    B, nb = block_table.shape
    page = k_pool.shape[1]

    def view(pool):
        g = pool[block_table.clamp_min(0).long()]            # (B, nb, page, ...)
        return g.reshape((B, nb * page) + tuple(pool.shape[2:]))

    kpos = torch.where((block_table < 0).repeat_interleave(page, dim=1), -1,
                       view(pos_pool))
    return decode_reference(q, view(k_pool), view(v_pool), kpos, q_positions,
                            scale=scale, window=window)


def mtp_reference(q, k, v, pos, depth, *, scale):
    """MTP attention with the closed-form predicate materialized densely.
    q/k/v (B,M,H|KV,hd); pos/depth (M,) or (B,M) int32 (-1 = padding)."""
    ok = mtp_mask_predicate(depth, pos, depth, pos)       # (M,M) or (B,M,M)
    ok = ok[None, None, None] if ok.dim() == 2 else ok[:, None, None]
    return _attend(q, k, v, ok, scale)


def decode_combine(po, pm, pl, B, T, H, KV):
    """The combine pass of the split-K bfloat16 decode kernel
    (``csrc/decode_splitk.cuh``) in plain PyTorch, on its scratch layout:
    per (b, KV head) and row r = t * G + g, the splits' unnormalised partial
    outputs po (B * KV, n, G * T, hd) with their stats pm, pl
    (B * KV, n, G * T) are rescaled by exp(m_i - m), summed and divided by
    l = sum_i l_i exp(m_i - m), m the largest m_i. Splits with l_i == 0 drop
    out (their po is never read) and rows with l == 0 are zeros with
    m = NEG_INF. Returns out (B, T, H, hd) float32 and (m, l), each
    (B, KV, G, T)."""
    G, hd = H // KV, po.shape[-1]
    live = pl > 0
    m = torch.where(live, pm, NEG_INF).amax(1)                  # (B*KV, R)
    w = torch.where(live, torch.exp(pm - m[:, None]), 0.0)      # (B*KV, n, R)
    l = (pl * w).sum(1)
    o = torch.where(live[..., None], po * w[..., None], 0.0).sum(1)
    o = torch.where((l > 0)[..., None], o / l.clamp_min(1e-30)[..., None],
                    0.0)
    out = o.reshape(B, KV, T, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, T, H, hd)

    def stats(x):   # (B*KV, T*G) -> (B, KV, G, T)
        return x.reshape(B, KV, T, G).permute(0, 1, 3, 2)

    return out, stats(m), stats(l)

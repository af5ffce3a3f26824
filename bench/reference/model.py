"""Plain reference of the served model, in float32 with TF32 off.

The target (a decoder-only transformer: RMSNorm, RoPE by half-split
rotation, grouped-query attention with optional q/k/v biases, SwiGLU, a
tied or separate head) over a whole sequence at once, and the P-EAGLE
drafter's parallel draft at chosen anchors: its cache context (the
positions the program's ``extend`` commits) and its K-slot block, computed
together in one causal pass with a block mask. Everything the program
derives from the weights and the tokens (KV, taps, the drafter's state) is
worked out here again from them alone; this module imports torch and
nothing else, so it never calls the program.

``prec="fp8"`` is the control: every matrix product's operands rounded to
float8 e4m3 (weights per output column, activations per row, each scaled
to the format's largest value), the step below the served bfloat16.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor
E4M3_MAX = 448.0


def exact_matmuls() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: Tensor, dim: int) -> Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(x: Tensor, w: Tensor, prec: Optional[str]) -> Tensor:
    """x (..., n) @ w (n, m), float32; ``prec="fp8"`` rounds both first."""
    x, w = x.float(), w.float()
    if prec == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    return x @ w


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x (T, heads, hd) rotated by half-split pairs at positions (T,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = pos.double()[:, None] * freqs[None]
    s, c = torch.sin(ang).float()[:, None], torch.cos(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def attention(q: Tensor, k: Tensor, v: Tensor, allowed: Callable,
              block: int = 1024) -> Tensor:
    """Softmax attention of q (T, H, hd) over k/v (S, KV, hd), query head
    h reading K/V head h // (H / KV), scaled by hd ** -0.5, where
    ``allowed(qi, kj)`` (index vectors) says which keys a query sees;
    queries in blocks of ``block``."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    kj = torch.arange(k.shape[0], device=q.device)
    out = torch.empty_like(q)
    for i0 in range(0, T, block):
        qi = torch.arange(i0, min(i0 + block, T), device=q.device)
        s = torch.einsum("qhd,khd->hqk", q[qi], k) * hd ** -0.5
        s = s.masked_fill(~allowed(qi, kj)[None], float("-inf"))
        out[qi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return out


def tap_layers(n_layers: int) -> Tuple[int, int, int]:
    """EAGLE-3's taps: the outputs of layers 2, L / 2 and L - 1."""
    if n_layers < 3:
        return (n_layers - 1,) * 3
    return (2, n_layers // 2, n_layers - 1)


def swiglu(p: dict, h: Tensor, prec: Optional[str]) -> Tensor:
    g = mm(h, p["w_gate"], prec)
    return mm(torch.nn.functional.silu(g) * mm(h, p["w_up"], prec),
              p["w_down"], prec)


def target_forward(t: dict, params: dict, tokens: Tensor,
                   logit_positions: Tensor, prec: Optional[str] = None
                   ) -> Tuple[Tensor, Tensor]:
    """The target over ``tokens`` (N,) at positions 0..N-1, causal.
    Returns (logits (n, V) at ``logit_positions`` (n,), taps (N, 3 d): the
    tap layers' outputs side by side). ``t``: the configuration's
    ``target`` group; a dense MLP only (an MoE target is not served by
    this reference)."""
    if (t.get("moe") or {}).get("n_experts"):
        raise NotImplementedError("the reference serves dense targets")
    N = tokens.shape[0]
    H, KV, hd = t["n_heads"], t["n_kv_heads"], t["head_dim"]
    eps = t["norm_eps"]
    pos = torch.arange(N, device=tokens.device)
    x = params["embed"][tokens.long()].float()
    taps_at = tap_layers(t["n_layers"])
    taps: List[Optional[Tensor]] = [None] * 3

    def causal(qi, kj):
        return kj[None, :] <= qi[:, None]

    for li, bp in enumerate(params["blocks"]):
        a = bp["attn"]
        h = rms_norm(x, bp["ln1"], eps)
        q, k, v = (mm(h, a[w], prec) for w in ("wq", "wk", "wv"))
        if "bq" in a:
            q = q + a["bq"].float()
            k, v = k + a["bk"].float(), v + a["bv"].float()
        q = rope(q.view(N, H, hd), pos, t["rope_theta"])
        k = rope(k.view(N, KV, hd), pos, t["rope_theta"])
        o = attention(q, k, v.view(N, KV, hd), causal)
        x = x + mm(o.reshape(N, H * hd), a["wo"], prec)
        x = x + swiglu(bp["mlp"], rms_norm(x, bp["ln2"], eps), prec)
        for i, tl in enumerate(taps_at):
            if tl == li:
                taps[i] = x
    h = rms_norm(x[logit_positions.long()], params["final_norm"], eps)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return mm(h, head, prec), torch.cat(taps, -1)


def draft_logits(dr: dict, t: dict, params: dict, tokens: Tensor,
                 taps: Tensor, anchors: Sequence[int], K: int,
                 prec: Optional[str] = None) -> Tensor:
    """The P-EAGLE drafter's K-slot parallel draft at each anchor a (the
    position before the last committed token): (len(anchors), K, V)
    logits. Drafter position p carries (taps[p], token p + 1); the cache
    a draft at anchor a reads holds positions 0..a-1; its slot 0 carries
    (taps[a], token a + 1) at position a, slot g > 0 the mask token and the
    shared hidden input (``hidden_state_variant`` "shared") at a + g, each
    slot seeing the slots before it. ``tokens`` must reach position
    max(anchors) + 1."""
    if dr.get("hidden_state_variant", "shared") != "shared":
        raise NotImplementedError("the reference drafts the shared variant")
    dev = tokens.device
    H, KV, hd = dr["n_heads"], dr["n_kv_heads"], dr["head_dim"]
    eps = dr["norm_eps"]
    mask_id = t["vocab_size"] - 1
    P = max(anchors)                      # context positions 0..P-1
    S = len(anchors)
    emb, fc = params["embed"], params["fc"]
    ctx_in = torch.cat([emb[tokens[1:P + 1].long()].float(),
                        mm(taps[:P], fc, prec)], -1)
    a_t = torch.as_tensor(list(anchors), device=dev)
    slot0 = torch.cat([emb[tokens[a_t + 1].long()].float(),
                       mm(taps[a_t], fc, prec)], -1)
    mtp = torch.cat([emb[mask_id].float(), params["h_shared"].float()])
    blocks = torch.cat([slot0[:, None], mtp.expand(S, K - 1, -1)], 1)
    x = mm(torch.cat([ctx_in, blocks.reshape(S * K, -1)]), params["fuse"],
           prec)
    g = torch.arange(K, device=dev)
    pos = torch.cat([torch.arange(P, device=dev),
                     (a_t[:, None] + g[None]).reshape(-1)])
    # query/key kinds: context p (anchor -1, slot p) or block slot (s, g)
    is_blk = torch.arange(P + S * K, device=dev) >= P
    blk_id = torch.where(is_blk, (torch.arange(P + S * K, device=dev) - P)
                         // K, -1)
    anchor_of = torch.where(is_blk, a_t[blk_id.clamp_min(0)], -1)

    def allowed(qi, kj):
        qb, kb = is_blk[qi][:, None], is_blk[kj][None, :]
        ctx_ctx = ~qb & ~kb & (kj[None, :] <= qi[:, None])
        blk_ctx = qb & ~kb & (kj[None, :] < anchor_of[qi][:, None])
        blk_blk = (qb & kb & (blk_id[qi][:, None] == blk_id[kj][None, :])
                   & (kj[None, :] <= qi[:, None]))
        return ctx_ctx | blk_ctx | blk_blk

    n = P + S * K
    for bp in params["blocks"]:
        a = bp["attn"]
        h = rms_norm(x, bp["ln1"], eps)
        q = rope(mm(h, a["wq"], prec).view(n, H, hd), pos, dr["rope_theta"])
        k = rope(mm(h, a["wk"], prec).view(n, KV, hd), pos, dr["rope_theta"])
        v = mm(h, a["wv"], prec).view(n, KV, hd)
        x = x + mm(attention(q, k, v, allowed).reshape(n, H * hd), a["wo"],
                   prec)
        x = x + swiglu(bp["mlp"], rms_norm(x, bp["ln2"], eps), prec)
    h = rms_norm(x[P:], params["final_norm"], eps)
    return mm(h, params["lm_head"], prec).view(S, K, -1)

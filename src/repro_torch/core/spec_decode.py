"""Speculative verification: greedy prefix matching, lossless rejection
sampling (Leviathan et al. 2023 / Chen et al. 2023) with per-request key
streams, logit warping (temperature / top-k / top-p, applied alike to
drafter and target rows) and the acceptance-length bookkeeping
(counterpart of the JAX package's ``core/spec_decode.py``).

Verification policy is per row: :func:`mixed_verify` runs the argmax
prefix match for ``temperature == 0`` rows and seeded rejection sampling
against the warped distributions for the rest, in one step. The keys are
threefry words from ``repro_torch.prng``, bit for bit the JAX package's, so
a row draws the reference's uniforms and Gumbel noise (the latter within a
float32 rounding of ``log``). Every function is batched over rows where
the JAX package maps one row with ``jax.vmap``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import prng

Tensor = torch.Tensor


def greedy_verify(draft_tokens: Tensor,
                  target_logits: Tensor) -> Tuple[Tensor, Tensor]:
    """draft_tokens (B, K); target_logits (B, K+1, V) for positions c..c+K
    (position c+i predicts token c+i+1).

    Returns (accept_len (B,) int32 in [0, K], t_star (B, K+1) int32):
    t_star[:, :accept_len+1] are the tokens to append, the accepted drafts
    (equal to the target argmax) plus the bonus/correction token."""
    t_star = target_logits.argmax(-1).to(torch.int32)
    K = draft_tokens.shape[1]
    match = (draft_tokens == t_star[:, :K]).to(torch.int32)
    accept_len = match.cumprod(1).sum(1).to(torch.int32)
    return accept_len, t_star


# ---------------------------------------------------------------------------
# logit warping (per-row temperature / top-k / top-p)
# ---------------------------------------------------------------------------

def warp_probs(logits: Tensor, temperature: Tensor, top_k: Tensor,
               top_p: Tensor) -> Tensor:
    """Per-row warped distributions: logits (B, T, V); temperature, top_k,
    top_p (B,). Rows with ``temperature <= 0`` are warped at 1.0 (greedy
    rows never read them). top-k keeps every logit >= the k-th highest
    (ties all kept; 0 disables); top-p keeps the smallest
    probability-sorted prefix reaching the mass, through the smallest kept
    probability (ties kept; the top-1 token always, so a blank slot's
    top_p 0 cannot empty the support). Returns (B, T, V) float32
    probabilities renormalized over the kept support."""
    B, T, V = logits.shape
    t = torch.where(temperature > 0, temperature, 1.0)[:, None, None]
    z = logits.float() / t
    k = torch.where(top_k > 0, top_k.clamp(max=V), V).long()
    z_sorted = z.sort(dim=-1, descending=True).values
    kth = z_sorted.gather(-1, (k - 1)[:, None, None].expand(B, T, 1))
    z = torch.where(z >= kth, z, -torch.inf)
    p = torch.softmax(z, dim=-1)
    p_sorted = p.sort(dim=-1, descending=True).values
    csum = p_sorted.cumsum(-1)
    keep = (csum - p_sorted) < top_p[:, None, None]
    keep[..., 0] = True
    p_min = torch.where(keep, p_sorted, torch.inf).amin(-1, keepdim=True)
    p = torch.where(p >= p_min, p, 0.0)
    return p / p.sum(-1, keepdim=True)


def sample_token(keys: Tensor, logits: Tensor, temperature: Tensor,
                 top_k: Tensor, top_p: Tensor) -> Tensor:
    """One token per row of logits (B, V): the argmax for ``temperature
    <= 0`` rows, else a draw from the warped distribution with the row's
    key (B, 2). Returns (B,) int32."""
    greedy_tok = logits.argmax(-1).to(torch.int32)
    probs = warp_probs(logits[:, None], temperature, top_k, top_p)[:, 0]
    drawn = prng.categorical(keys, torch.log(probs)).to(torch.int32)
    return torch.where(temperature > 0, drawn, greedy_tok)


# ---------------------------------------------------------------------------
# lossless rejection verification (seeded, per row)
# ---------------------------------------------------------------------------

def _residual(p_rej: Tensor, q_rej: Tensor) -> Tensor:
    """norm(max(p - q, 0)); a zero residual (p == q) falls back to p."""
    resid = (p_rej - q_rej).clamp_min(0.0)
    mass = resid.sum(-1, keepdim=True)
    return torch.where(mass > 0,
                       resid / torch.where(mass > 0, mass, 1.0), p_rej)


def rejection_verify_rows(keys: Tensor, draft_tokens: Tensor,
                          draft_probs: Tensor, target_probs: Tensor,
                          k_row: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Lossless stochastic verification with per-row keys (B, 2).

    draft_tokens (B, K); draft_probs (B, K, V), the distributions the
    drafts were drawn from; target_probs (B, K+1, V). Draft i is accepted
    with probability min(1, p_i(d_i) / q_i(d_i)) (``u q < p``, exact at
    q == 0); at the first rejection the replacement is drawn from
    norm(max(p - q, 0)); with every draft accepted, a bonus token from
    p_K. The row's key splits into three: the K uniforms, the resample and
    the bonus. ``k_row`` (B,) force-rejects slots >= k_row[b], and q is
    zeroed at a forced rejection, so the resample there draws from the
    full target row (None: every row's full K).

    Returns (accept_len (B,) int32, committed (B, K+1) int32): the first
    accept_len + 1 entries of ``committed`` are the tokens to append."""
    B, K = draft_tokens.shape
    dev = draft_tokens.device
    if k_row is None:
        k_row = torch.full((B,), K, dtype=torch.int32, device=dev)
    ks = prng.split(keys, 3)
    if K == 0:
        bonus = prng.categorical(ks[:, 2], torch.log(target_probs[:, K]))
        return (torch.zeros((B,), dtype=torch.int32, device=dev),
                bonus.to(torch.int32)[:, None])
    u = prng.uniform(ks[:, 0], (K,))
    ar = torch.arange(K, device=dev)
    d = draft_tokens.long()[..., None]
    q_d = draft_probs.gather(-1, d)[..., 0]
    p_d = target_probs[:, :K].gather(-1, d)[..., 0]
    ok = (u * q_d < p_d) & (ar[None] < k_row[:, None])
    accept_len = ok.to(torch.int32).cumprod(1).sum(1).to(torch.int32)

    rows = torch.arange(B, device=dev)
    idx = accept_len.clamp(max=K - 1).long()
    p_rej = target_probs[rows, idx]
    q_rej = torch.where((idx < k_row)[:, None], draft_probs[rows, idx], 0.0)
    # the resample (key 1) and the bonus (key 2) in one call
    resample, bonus = prng.categorical(ks[:, 1:], torch.log(torch.stack(
        [_residual(p_rej, q_rej), target_probs[:, K]], 1))).unbind(1)

    committed = torch.where(ar[None] < accept_len[:, None], draft_tokens, 0)
    committed = torch.cat([committed, committed.new_zeros((B, 1))], 1)
    fix = torch.where(accept_len == K, bonus, resample).to(committed.dtype)
    committed[rows, accept_len.long()] = fix
    return accept_len, committed.to(torch.int32)


def rejection_verify(key: Tensor, draft_tokens: Tensor, draft_probs: Tensor,
                     target_probs: Tensor,
                     k_row: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Whole-batch form: ``key`` (2,) splits into the rows' keys."""
    keys = prng.split(key, draft_tokens.shape[0])
    return rejection_verify_rows(keys, draft_tokens, draft_probs,
                                 target_probs, k_row)


def mixed_verify(keys: Tensor, draft_tokens: Tensor, draft_probs: Tensor,
                 target_logits: Tensor, temperature: Tensor, top_k: Tensor,
                 top_p: Tensor,
                 k_row: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per-row mixed policy in one step: ``temperature == 0`` rows take the
    greedy prefix match on the raw target logits (their matched prefix
    clipped at ``k_row``); the rest run :func:`rejection_verify_rows` of
    the drafts against the row-warped target. ``draft_probs`` must be the
    distribution the drafts were drawn from: a one-hot for argmax drafts,
    the warped drafter distribution for sampled ones.

    Returns (accept_len (B,), committed (B, K+1))."""
    acc_g, t_star = greedy_verify(draft_tokens, target_logits)
    if k_row is not None:
        acc_g = torch.minimum(acc_g, k_row)
    p = warp_probs(target_logits, temperature, top_k, top_p)
    acc_s, comm_s = rejection_verify_rows(keys, draft_tokens, draft_probs, p,
                                          k_row)
    is_greedy = temperature <= 0
    return (torch.where(is_greedy, acc_g, acc_s),
            torch.where(is_greedy[:, None], t_star, comm_s))


# ---------------------------------------------------------------------------
# acceptance-length bookkeeping
# ---------------------------------------------------------------------------

def update_acceptance_stats(stats: dict, accept_len: Tensor,
                            active: Optional[Tensor] = None,
                            iters: Optional[Tensor] = None) -> dict:
    """Running mean of tokens committed per iteration (accept_len + 1, the
    paper's acceptance length). ``active`` masks frozen rows out (they
    contribute zero iterations and tokens); ``iters`` (B,) weights a row as
    that many iterations, ``accept_len`` then being its accepted drafts
    over them. An all-False mask leaves the mean finite."""
    w = torch.ones_like(accept_len) if iters is None else iters
    if active is not None:
        w = torch.where(active, w, 0)
    tok = accept_len + w
    if active is not None:
        tok = torch.where(active, tok, 0)
    iters_tot = stats.get("iters", 0) + w.sum()
    tokens = stats.get("tokens", 0) + tok.sum()
    return {"iters": iters_tot, "tokens": tokens,
            "mean": tokens / torch.clamp(torch.as_tensor(iters_tot), min=1)}



def acceptance_length(stats: dict) -> float:
    return float(stats["tokens"]) / max(float(stats["iters"]), 1.0)

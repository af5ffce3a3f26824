"""Greedy speculative verification and acceptance-length bookkeeping
(counterpart of the JAX package's ``core/spec_decode.py``, greedy lane).
Sampled (rejection) verification is not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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


"""How close each sampled decision of a serving run came to going the
other way, for comparing two runs' streams.

Two runs of one request whose logits are computed in a different order
(another batch composition, KV layout, kernel, or the JAX package) agree
token for token except where a decision sits within float noise of its
threshold. A sampled row makes three kinds of decision, each with a
margin:
- a draw (``categorical``): the gap between the two largest perturbed
  log-probabilities ``log p + gumbel``;
- an acceptance: ``|u q(d) - p(d)|``;
- (greedy rows: the top-2 logit gap, read from the logits directly).

:class:`MarginLog` records, while it is active, the smallest margin of
every sampled row's step (``spec_decode.mixed_verify``) and first-token
draw (``spec_decode.sample_token``), keyed by the row's step key
``fold_in(seed, position)``. ``min_margin(seed, lo, hi)`` is then the
smallest margin of that stream's decisions at positions lo..hi: a stream
may part from another run's only after a decision whose margin is below
the comparison's threshold.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import prng
from repro_torch.core import spec_decode as SD

Tensor = torch.Tensor


def _draw_gap(keys: Tensor, logp: Tensor) -> Tensor:
    """Top-2 gap of ``logp + gumbel`` per key: (B,); inf with one
    candidate."""
    z = (logp + prng.gumbel(keys, logp.shape[-1:])).topk(2, dim=-1).values
    gap = z[..., 0] - z[..., 1]
    return torch.where(torch.isfinite(z[..., 1]), gap, torch.inf)


def sample_margins(keys: Tensor, logits: Tensor, temperature: Tensor,
                   top_k: Tensor, top_p: Tensor) -> Tensor:
    """(B,) margins of ``SD.sample_token``'s draws (inf for greedy rows)."""
    probs = SD.warp_probs(logits[:, None], temperature, top_k, top_p)[:, 0]
    gap = _draw_gap(keys, torch.log(probs))
    return torch.where(temperature > 0, gap, torch.inf)


def verify_margins(keys: Tensor, draft_tokens: Tensor, draft_probs: Tensor,
                   target_logits: Tensor, temperature: Tensor, top_k: Tensor,
                   top_p: Tensor, k_row=None) -> Tensor:
    """(B,) smallest margin of each sampled row's decisions in one
    ``SD.mixed_verify`` call: its acceptance tests up to the first
    rejection and the draw that fixed its last token (inf for greedy
    rows)."""
    B, K = draft_tokens.shape
    p = SD.warp_probs(target_logits, temperature, top_k, top_p)
    if k_row is None:
        k_row = torch.full((B,), K, dtype=torch.int32, device=p.device)
    acc, _ = SD.rejection_verify_rows(keys, draft_tokens, draft_probs, p,
                                      k_row)
    ks = prng.split(keys, 3)
    rows = torch.arange(B, device=p.device)
    margin = _draw_gap(ks[:, 2], torch.log(p[:, K]))           # the bonus
    if K > 0:
        u = prng.uniform(ks[:, 0], (K,))
        d = draft_tokens.long()[..., None]
        q_d = draft_probs.gather(-1, d)[..., 0]
        p_d = p[:, :K].gather(-1, d)[..., 0]
        ar = torch.arange(K, device=p.device)[None]
        tested = (ar <= acc[:, None]) & (ar < k_row[:, None])
        accept = torch.where(tested, (u * q_d - p_d).abs(), torch.inf)
        idx = acc.clamp(max=K - 1).long()
        q_rej = torch.where((idx < k_row)[:, None], draft_probs[rows, idx],
                            0.0)
        resid = SD._residual(p[rows, idx], q_rej)
        resample = _draw_gap(ks[:, 1], torch.log(resid))
        margin = torch.where(acc == K, margin, resample)
        margin = torch.minimum(margin, accept.amin(-1))
    return torch.where(temperature > 0, margin, torch.inf)


class MarginLog:
    """Records sampled decisions' margins while active (``with
    MarginLog() as log:``), keyed by step key."""

    def __init__(self):
        self.margins: Dict[Tuple[int, int], float] = {}

    def _note(self, keys: Tensor, margins: Tensor):
        for k, m in zip(keys.tolist(), margins.tolist()):
            if m != float("inf"):
                key = tuple(k)
                self.margins[key] = min(m, self.margins.get(key, m))

    def __enter__(self):
        self._saved = (SD.mixed_verify, SD.sample_token)
        mixed, sample = self._saved

        def mixed_verify(keys, *args):
            self._note(keys, verify_margins(keys, *args))
            return mixed(keys, *args)

        def sample_token(keys, *args):
            self._note(keys, sample_margins(keys, *args))
            return sample(keys, *args)

        SD.mixed_verify, SD.sample_token = mixed_verify, sample_token
        return self

    def __exit__(self, *exc):
        SD.mixed_verify, SD.sample_token = self._saved

    def min_margin(self, seed: int, lo: int, hi: int) -> float:
        """Smallest recorded margin of stream ``seed``'s decisions whose
        step key is at positions lo..hi (inf when none was recorded)."""
        pos = torch.arange(lo, hi + 1)
        keys = prng.fold_in(prng.PRNGKey(seed)[None], pos)
        found = [self.margins[tuple(k)] for k in keys.tolist()
                 if tuple(k) in self.margins]
        return min(found, default=float("inf"))

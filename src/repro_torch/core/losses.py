"""Training losses: MTP cross-entropy (per-depth weighted), the EAGLE-3 TTT
unroll for the AR baseline, and HCA (harmonized context alignment).

Counterpart of the JAX package's ``core/losses.py``. Labels use -1 as
ignore (padding / positions whose target falls off the sequence end).
Metrics are 0-dim tensors; the trainer reads them as floats.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Per-position CE with -1 ignore; returns (B, M) with 0 at ignored."""
    valid = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(valid, ce, 0.0)


def mtp_loss(logits: Tensor, labels: Tensor, depth: Tensor, *,
             depth_weight_decay: float = 1.0) -> Tuple[Tensor, dict]:
    """logits (B,M,V), labels (B,M), depth (M,) or (B,M). Mean CE over valid
    positions, optionally down-weighting deeper prediction depths.
    Metrics: overall/NTP/MTP token accuracy and the valid-token count."""
    if depth.dim() == 1:
        depth = depth[None, :]
    ce = cross_entropy(logits, labels)
    valid = (labels >= 0) & (depth >= 0)
    w = torch.where(depth >= 0,
                    depth_weight_decay ** depth.clamp_min(0).float(), 0.0)
    w = torch.where(valid, w, 0.0)
    loss = (ce * w).sum() / w.sum().clamp_min(1e-9)

    with torch.no_grad():
        hit = (logits.argmax(-1) == labels) & valid
        is_ntp = depth == 0
        is_mtp = depth > 0

        def rate(num, den):
            return num.sum().float() / den.sum().clamp_min(1).float()

        metrics = {
            "loss": loss.detach(),
            "acc": rate(hit, valid),
            "ntp_acc": rate(hit & is_ntp, valid & is_ntp),
            "mtp_acc": rate(hit & is_mtp, valid & is_mtp),
            "valid_tokens": valid.sum(),
        }
    return loss, metrics


def hca_loss(hidden: Tensor, target_feat: Tensor, valid: Tensor) -> Tensor:
    """Harmonized context alignment (Zhang et al. 2024), adapted: align the
    drafter's pre-head hidden at p with the target-conditioned feature the
    *next* drafter position consumes (fc(taps)[p+1]) — smooth-L1."""
    d = hidden.float() - target_feat.float()
    ad = d.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).mean(-1)
    return (sl1 * valid).sum() / valid.sum().clamp_min(1e-9)


def ttt_forward_loss(dcfg, tcfg, params: dict, tokens: Tensor, taps: Tensor,
                     *, steps: Optional[int] = None,
                     hca_weight: float = 0.1) -> Tuple[Tensor, dict]:
    """EAGLE-3 training-time test for the AR baseline (paper footnote 2).

    Step 0 feeds true target features; step j >= 1 replaces the hidden input
    at position p with the drafter's own step-(j-1) hidden at p-1 — the
    mismatch the drafter sees when chaining autoregressively at inference.
    Tokens stay teacher-forced. Losses sum across steps."""
    from repro_torch.core import drafter as D
    steps = steps or dcfg.ttt_steps
    B, n = tokens.shape
    dev = tokens.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(B, n)
    depth = torch.zeros((B, n), dtype=torch.int32, device=dev)
    labels = torch.cat([tokens[:, 2:], tokens.new_full((B, 2), -1)], dim=1)

    fc_all = taps.to(params["fc"].dtype) @ params["fc"]
    tok_in = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    emb = D.embed_tokens(dcfg, params, tok_in)
    # causal attention: the MTP predicate with depth 0 everywhere (the JAX
    # package runs the plain blocked attention here, never the flash path)
    meta = (pos.contiguous(), depth, False)

    total = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = {}
    hid_in = fc_all
    for j in range(steps):
        x = torch.cat([emb, hid_in], dim=-1) @ params["fuse"]
        x = D._run_blocks(dcfg, params, x, positions=pos, cache=None,
                          mode="train", meta=meta)
        logits, hidden = D._head(dcfg, params, x)
        loss, m = mtp_loss(logits, labels, depth)
        if dcfg.hca:
            valid = (labels >= 0).float()
            tgt = torch.cat([fc_all[:, 1:], fc_all[:, -1:]], dim=1)
            loss = loss + hca_weight * hca_loss(hidden, tgt, valid)
        total = total + loss
        metrics[f"step{j}_acc"] = m["acc"]
        # the next step consumes its own hiddens, shifted right by one
        hid_in = torch.cat([fc_all[:, :1], hidden[:, :-1].to(fc_all.dtype)],
                           dim=1)
    metrics["loss"] = total.detach()
    metrics["acc"] = metrics[f"step{steps - 1}_acc"]
    return total, metrics

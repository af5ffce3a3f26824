"""MTP attention masks — the paper's §3.1 plus the closed form.

Parametrization (paper Figs. 3–4): an MTP *position* is a pair (g, p) of
prediction depth g ∈ [0, K) and RoPE position p. Its *anchor* a = p − g is
the end of the real context it drafts from, and it predicts token[p + 1].

Attention predicate (closed form):

    attend((g, p) → (g', p'))  ⇔  (g' = 0 ∧ p' ≤ p − g)            # real ctx
                               ∨  (p' − g' = p − g ∧ g' ≤ g)       # own chain

i.e. a position sees its anchor's real context plus the lower-depth positions
of its *own* chain (same anchor). Depth 0 reduces to plain causal attention.

Three implementations, used as baseline → paper → closed form:

1. ``pard_style_mask``      — O(M²) per-example construction (PARD baseline).
2. ``precompute_full_mask`` + ``extract_mask`` — the paper's amortized
   construction: one max-length mask at init, per-example retrieval by
   row/col gather in the interleaved (p·K + g) layout.
3. ``mtp_mask_predicate``   — the closed form evaluated from int32 metadata;
   what the plain attention and the CUDA ``mtp_attention`` kernel use.

A copy of the JAX package's ``core/masks.py``; ``mtp_mask_predicate`` takes
numpy arrays or torch tensors, shared (M,) or per-row (B, M).

Padding convention: depth < 0 marks padding; it attends nothing and nothing
attends it.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# 3) closed form
# ---------------------------------------------------------------------------

def mtp_mask_predicate(q_depth, q_pos, k_depth, k_pos):
    """Boolean (..., len(q), len(k)) of the closed-form predicate.

    numpy arrays or torch tensors; (Sq,)/(Bk,) give (Sq, Bk), per-row
    (B, Sq)/(B, Bk) give (B, Sq, Bk)."""
    qg = q_depth[..., :, None]
    qp = q_pos[..., :, None]
    kg = k_depth[..., None, :]
    kp = k_pos[..., None, :]
    anchor_q = qp - qg
    anchor_k = kp - kg
    real_ctx = (kg == 0) & (kp <= anchor_q)
    own_chain = (anchor_k == anchor_q) & (kg <= qg)
    valid = (qg >= 0) & (kg >= 0)
    return (real_ctx | own_chain) & valid


# ---------------------------------------------------------------------------
# 2) paper: amortized construction + retrieval
# ---------------------------------------------------------------------------

def interleaved_index(pos, depth, K: int):
    """Layout index p*K + g — appending tokens only appends indices, so the
    mask of any sequence is the top-left submatrix of the max-length mask."""
    return pos * K + depth


def precompute_full_mask(n_max: int, K: int) -> np.ndarray:
    """One-time (n_max·K)² bool mask in interleaved layout (paper §3.1)."""
    idx = np.arange(n_max * K)
    pos, depth = idx // K, idx % K
    return mtp_mask_predicate(depth, pos, depth, pos)


def extract_mask(full: np.ndarray, pos: np.ndarray, depth: np.ndarray,
                 K: int) -> np.ndarray:
    """Per-example retrieval: row/col gather of the precomputed mask at the
    COD-sampled positions."""
    idx = interleaved_index(pos, depth, K)
    return full[np.ix_(idx, idx)]


# ---------------------------------------------------------------------------
# 1) PARD-style per-example construction (the baseline the paper beats)
# ---------------------------------------------------------------------------

def pard_style_mask(pos: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Rebuilds the mask from scratch for one example, the way a per-batch
    mask constructor does: multiple O(M²) predicate passes + allocations.
    Matches ``extract_mask`` output exactly."""
    M = len(pos)
    mask = np.zeros((M, M), dtype=bool)
    anchors = pos - depth
    # pass 1: real-context visibility, one depth at a time
    for g in sorted(set(depth.tolist())):
        qsel = depth == g
        ctx = (depth[None, :] == 0) & (pos[None, :] <= anchors[qsel][:, None])
        mask[qsel] |= ctx
    # pass 2: chain visibility
    for g in sorted(set(depth.tolist())):
        qsel = depth == g
        chain = (anchors[None, :] == anchors[qsel][:, None]) & \
                (depth[None, :] <= g)
        mask[qsel] |= chain
    pad = depth < 0
    mask[pad] = False
    mask[:, pad] = False
    return mask


# ---------------------------------------------------------------------------
# helpers for training batches
# ---------------------------------------------------------------------------

def sort_by_layout(pos: np.ndarray, depth: np.ndarray, K: int):
    """Order positions by interleaved index (p, then g). Returns the
    permutation."""
    return np.argsort(interleaved_index(pos, depth, K), kind="stable")


def labels_for(pos: np.ndarray, tokens_row: np.ndarray,
               pad_id: int = -1) -> np.ndarray:
    """Every MTP position (g, p) predicts token[p+1]."""
    n = len(tokens_row)
    tgt = pos + 1
    ok = (tgt >= 0) & (tgt < n)
    return np.where(ok, tokens_row[np.clip(tgt, 0, n - 1)], pad_id)

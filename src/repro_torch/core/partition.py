"""Sequence partitioning for within-sequence gradient accumulation
(paper §3.2, Algorithm 1).

Splits one COD-expanded sequence into S segments such that every position's
cross-depth dependency ((g, p) → (g-1, p-1)) lands in the same segment, then
augments each segment's *key* set with the cumulative depth-0 positions up to
its boundary so causal attention over real context is preserved. Each segment
is a separate forward/backward; gradients accumulate across segments
(optim/accumulate.py), cutting peak attention memory O(L²) → O(L²/S²).

A numpy copy of the JAX package's ``core/partition.py``; the same inputs
give the same segments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Segment:
    """One gradient-accumulation micro-step of a single sequence.

    ``q_*``   — positions whose loss/gradient this segment owns.
    ``kv_*``  — attention key set: q positions ∪ cumulative depth-0 context
                (N_s in Algorithm 1). Sorted in interleaved layout order.
    ``q_in_kv`` — indices of the q positions inside the kv arrays.
    """
    q_pos: np.ndarray
    q_depth: np.ndarray
    kv_pos: np.ndarray
    kv_depth: np.ndarray
    q_in_kv: np.ndarray


def assign_segments(pos: np.ndarray, depth: np.ndarray, L: int,
                    S: int) -> np.ndarray:
    """Algorithm 1 Phases 1–2: segment id per expanded position.

    Phase 1: depths 0 and 1 assigned by position against uniform boundaries
    B_s = s·L/S. Phase 2: depth g ≥ 2 inherits the assignment of its
    dependency (g-1, p-1) — propagated iteratively, so a whole chain follows
    its depth-1 member and never straddles a boundary.
    """
    bounds = (np.arange(S + 1) * L) // S                    # B_0..B_S
    seg_of_pos = np.searchsorted(bounds, np.arange(L), side="right") - 1
    seg_of_pos = np.clip(seg_of_pos, 0, S - 1)

    A = np.full(len(pos), -1, np.int64)
    # index lookup: (g, p) -> row
    lut = {}
    for i, (g, p) in enumerate(zip(depth.tolist(), pos.tolist())):
        lut[(g, p)] = i

    order = np.argsort(depth, kind="stable")                # by depth g asc
    for i in order.tolist():
        g, p = int(depth[i]), int(pos[i])
        if g < 0:
            continue
        if g <= 1:
            A[i] = seg_of_pos[p]                            # Phase 1
        else:
            dep = lut.get((g - 1, p - 1))                   # Phase 2
            if dep is None:                                 # (chain-closed COD
                A[i] = seg_of_pos[p]                        #  never hits this)
            else:
                A[i] = A[dep]
    return A


def build_segments(pos: np.ndarray, depth: np.ndarray, L: int,
                   S: int) -> List[Segment]:
    """Algorithm 1 Phase 3 + segment materialization."""
    A = assign_segments(pos, depth, L, S)
    bounds = (np.arange(S + 1) * L) // S
    segs: List[Segment] = []
    d0 = depth == 0
    for s in range(S):
        qsel = A == s
        if not qsel.any():
            continue
        # N_s: cumulative depth-0 positions below the segment's upper boundary
        ctx = d0 & (pos < bounds[s + 1])
        kv_sel = qsel | ctx
        kv_idx = np.nonzero(kv_sel)[0]
        # keep interleaved layout order (input is already sorted that way)
        kv_pos, kv_depth = pos[kv_idx], depth[kv_idx]
        q_idx = np.nonzero(qsel)[0]
        lookup = {int(i): j for j, i in enumerate(kv_idx.tolist())}
        q_in_kv = np.array([lookup[int(i)] for i in q_idx.tolist()], np.int64)
        segs.append(Segment(q_pos=pos[q_idx], q_depth=depth[q_idx],
                            kv_pos=kv_pos, kv_depth=kv_depth,
                            q_in_kv=q_in_kv))
    return segs


def check_dependencies_preserved(segs: List[Segment], pos: np.ndarray,
                                 depth: np.ndarray) -> bool:
    """Every key a query may attend (per the closed-form predicate) that
    exists in the example must be present in that segment's kv set — the
    invariant Algorithm 1 guarantees. Used by property tests."""
    exists = set(zip(depth.tolist(), pos.tolist()))
    for seg in segs:
        kv = set(zip(seg.kv_depth.tolist(), seg.kv_pos.tolist()))
        for g, p in zip(seg.q_depth.tolist(), seg.q_pos.tolist()):
            a = p - g
            for gk in range(1, g + 1):          # own chain members (depth>=1)
                member = (gk, a + gk)
                if member != (g, p) and member in exists and member not in kv:
                    return False
            # real context: all sampled depth-0 positions <= anchor
            need = {(0, q) for q in range(0, a + 1) if (0, q) in exists}
            if not need.issubset(kv):
                return False
    return True

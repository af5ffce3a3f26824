"""Conditional Drop-token (COD) sampling — PARD's geometric position decay,
made *chain-closed* and *fixed-count* so that (a) Algorithm 1's dependency
propagation (core/partition.py) is always well defined, and (b) batch shapes
are static for jit/pjit.

Depth g retains round(n·r^g) positions. We sample nested anchor sets
A_0 ⊇ A_1 ⊇ … ⊇ A_{K-1} and set P_g = {a + g : a ∈ A_g, a + g + 1 < n};
nesting guarantees every (g, p) has its dependency (g-1, p-1) present —
the property the paper's partitioning relies on (§3.2). Counts depend only on
(n, K, r), so the total expanded length M is deterministic.

A numpy copy of the JAX package's ``core/cod.py`` (the port imports nothing
of that package); the same seed gives the same arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def depth_counts(n: int, K: int, r: float) -> np.ndarray:
    """Retained positions per depth: c_0 = n, c_g = round(n·r^g), adjusted so
    c_g is non-increasing and depth-g anchors fit (a + g + 1 <= n - 1)."""
    c = np.round(n * (r ** np.arange(K))).astype(np.int64)
    c[0] = n
    for g in range(1, K):
        c[g] = min(c[g], c[g - 1], max(n - g - 1, 0))
    return np.maximum(c, 0)


def expanded_length(n: int, K: int, r: float) -> int:
    return int(depth_counts(n, K, r).sum())


def sample_cod(rng: np.random.Generator, n: int, K: int,
               r: float) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (pos, depth) int32 arrays of length expanded_length(n, K, r),
    sorted in interleaved layout order (p, then g)."""
    c = depth_counts(n, K, r)
    anchors = np.arange(n, dtype=np.int64)
    positions, depths = [anchors.copy()], [np.zeros(n, np.int64)]
    current = anchors[: max(n - 2, 0)]  # depth>=1 anchors need a+g+1 <= n-1
    for g in range(1, K):
        limit = n - g - 1               # a + g + 1 <= n - 1  =>  a <= n-g-2
        current = current[current <= max(limit, -1)]
        take = min(int(c[g]), len(current))
        if take <= 0:
            break
        sel = rng.choice(len(current), size=take, replace=False)
        current = np.sort(current[sel])
        positions.append(current + g)
        depths.append(np.full(take, g, np.int64))
    pos = np.concatenate(positions)
    depth = np.concatenate(depths)
    order = np.argsort(pos * K + depth, kind="stable")
    return pos[order].astype(np.int32), depth[order].astype(np.int32)


def pad_to(pos: np.ndarray, depth: np.ndarray, M: int):
    """Pad with (pos=-1, depth=-1) to static length M (mask & loss ignore)."""
    m = len(pos)
    if m > M:
        raise ValueError(f"expanded length {m} exceeds static budget {M}")
    ppos = np.full(M, -1, np.int32)
    pdep = np.full(M, -1, np.int32)
    ppos[:m] = pos
    pdep[:m] = depth
    return ppos, pdep

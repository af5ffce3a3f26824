"""Cache commit after speculative verification (counterpart of the JAX
package's ``serving/cache_ops.commit``, attention caches only).

Attention caches roll back by position invalidation: a slot holding a
position beyond the last accepted token is marked empty (-1), and the next
write reuses it. Dense targets have no recurrent snapshots to select."""
from __future__ import annotations

import torch


def commit(cache: dict, commit_pos: torch.Tensor) -> dict:
    """Invalidate, in place, every ``positions`` leaf of ``cache`` (a tree
    of dicts and lists) beyond ``commit_pos`` (B,), the last valid absolute
    position of each row. Returns the cache."""
    if isinstance(cache, dict):
        for name, leaf in cache.items():
            if name == "positions":
                leaf.masked_fill_(leaf > commit_pos[:, None], -1)
            elif isinstance(leaf, (dict, list)):
                commit(leaf, commit_pos)
    elif isinstance(cache, list):
        for sub in cache:
            commit(sub, commit_pos)
    return cache

"""Gradient accumulation across micro-batches *and within a sequence* (the
paper's §3.2: one COD-expanded sequence is split into segments, each a
separate forward/backward, summed here before one optimizer step).

Counterpart of the JAX package's ``optim/accumulate.py``: the state is a
float32 grads tree plus the summed weight. ``add`` updates the state in
place (a full-width drafter's accumulator is 2.5 GB) and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


class GradAccumulator:
    def __init__(self, params_like):
        self._like = params_like

    def init(self) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = leaves(self._like)[0].device
        return {"grads": tree_map(zeros, self._like),
                "weight": torch.zeros((), dtype=torch.float32, device=dev)}

    @staticmethod
    def add(acc: dict, grads, weight) -> dict:
        """Accumulate `weight`-weighted gradient sums (weight = number of
        valid target tokens in the segment, so the final average is exact
        regardless of segment sizes)."""
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=acc["weight"].device)
        for a, g in zip(leaves(acc["grads"]), leaves(grads)):
            a.add_(g.float() * w)
        acc["weight"] = acc["weight"] + w
        return acc

    @staticmethod
    def mean(acc: dict):
        w = acc["weight"].clamp_min(1e-9)
        return tree_map(lambda a: a / w, acc["grads"])

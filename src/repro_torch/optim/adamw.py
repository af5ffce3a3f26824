"""AdamW + schedule as functions on trees of tensors (PyTorch).

Counterpart of the JAX package's ``optim/adamw.py``, matched step for step
(not ``torch.optim.AdamW``): linear LR schedule with warmup (paper §5.1:
peak 1e-4, warmup ratio 0.0025), b2 = 0.95, global-norm clipping, and
weight decay added to the normalized update before the learning rate, on
every leaf. Moments are float32 and mirror the parameter tree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import leaves, tree_map, unflatten

Tensor = torch.Tensor


class AdamWState(NamedTuple):
    step: Tensor            # int32 scalar
    m: dict
    v: dict


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def linear_warmup_schedule(peak: float, total_steps: int,
                           warmup_ratio: float = 0.0025) -> Callable:
    warmup = max(int(total_steps * warmup_ratio), 1)

    def sched(step: Tensor) -> Tensor:
        s = step.float()
        up = peak * s / warmup
        down = peak * (total_steps - s).clamp_min(0.0) / max(
            total_steps - warmup, 1)
        return torch.where(s < warmup, up, down)
    return sched


def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(grads, state: AdamWState, params, *,
                 lr: Union[Callable, float], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01,
                 max_grad_norm: float = 1.0) -> Tuple[dict, AdamWState, dict]:
    """Returns (updates, new state, {"grad_norm", "lr"}); add the updates to
    the parameters with ``apply_updates``."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    s = step.float()
    lr_t = lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=s.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=s.device), s)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=s.device), s)

    out = []
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        g32 = g.float()
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * g32.square()
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        u = u + weight_decay * p.float()
        out.append(((-lr_t * u).to(p.dtype), m2, v2))
    updates = unflatten(params, [o[0] for o in out])
    new = AdamWState(step=step, m=unflatten(params, [o[1] for o in out]),
                     v=unflatten(params, [o[2] for o in out]))
    return updates, new, {"grad_norm": gnorm, "lr": lr_t}


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)



"""Mixture-of-Experts FFN (PyTorch): dbrx's 16 experts top-4 on every layer,
llama4's 128 experts top-1 on the odd layers beside a shared expert.

Counterpart of the JAX package's ``models/moe.py``, step for step: a
float32 router, top-K in ``lax.top_k``'s order (descending, ties to the
lower expert), gates normalised by their sum, then the sort-based capacity
dispatch: each expert takes at most ``C = int(T*K/E * capacity_factor) + 1``
of the call's ``T = B*S`` tokens, in token order (a stable sort of the
flat expert ids), and a token past an expert's capacity is dropped for
that expert. Capacity couples the tokens of one call: a row's output
depends on the call's shape and on the rows in front of it.

The combine is float32 and uses no atomics: each token gathers its kept
slots and adds them in ascending expert order, from zero, the order in
which the reference's serial scatter-add adds them, so two runs on the
card give the same bits. The expert products are batched matrix products
(the reference computes them outside any Pallas kernel too).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Tensor = torch.Tensor


def moe_init(d: int, f: int, n_experts: int, n_shared: int, variant: str,
             generator: torch.Generator, *, device, dtype) -> dict:
    """``{router (d, E) float32, w_gate / w_up (E, d, f), w_down (E, f, d)
    [, shared: an MLP of width f * n_shared]}`` (``w_gate`` whatever the
    variant, as the JAX package's)."""
    def dense(shape, **kw):
        return L.dense_init(shape, generator, device=device, **kw)

    p = {"router": dense((d, n_experts), dtype=torch.float32, scale=0.02),
         "w_gate": dense((n_experts, d, f), dtype=dtype),
         "w_up": dense((n_experts, d, f), dtype=dtype),
         "w_down": dense((n_experts, f, d), dtype=dtype)}
    if n_shared:
        p["shared"] = L.mlp_init(d, f * n_shared, generator, device=device,
                                 dtype=dtype, variant=variant)
    return p


def _expert_ffn(xg: Tensor, p: dict, variant: str) -> Tensor:
    """xg (E, C, D) -> (E, C, D), one batched product per weight."""
    if variant in ("swiglu", "geglu"):
        g = torch.bmm(xg, p["w_gate"])
        act = (F.silu(g) if variant == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = act * torch.bmm(xg, p["w_up"])
    elif variant == "relu2":
        h = torch.square(F.relu(torch.bmm(xg, p["w_up"])))
    else:
        h = F.gelu(torch.bmm(xg, p["w_up"]), approximate="tanh")
    return torch.bmm(h, p["w_down"])


def route(p: dict, xf: Tensor, top_k: int):
    """(logits (T, E) float32, probs, gate values (T, K), expert ids (T,
    K)): top-K of the softmax in ``lax.top_k``'s order (a stable descending
    sort puts tied experts lower index first), gates normalised."""
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, experts = vals[:, :top_k], idx[:, :top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate, experts


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert, the reference's expression in its order."""
    return int((T * top_k) / n_experts * capacity_factor) + 1


def moe_apply(p: dict, x: Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, variant: str,
              n_shared: int = 0) -> Tuple[Tensor, dict]:
    """x (B, S, D) -> (out (B, S, D), aux {lb_loss, z_loss, drop_frac})."""
    B, S, D = x.shape
    T = B * S
    E, K = n_experts, top_k
    xf = x.reshape(T, D)
    logits, probs, gate, experts = route(p, xf, K)

    # capacity-based sort dispatch: slots in token order, per expert
    C = capacity(T, K, E, capacity_factor)
    flat_e = experts.reshape(-1)                               # (T*K,)
    se, order = torch.sort(flat_e, stable=True)
    st = order // K                                            # token of slot
    # bincount(minlength=E), without the host sync bincount makes on CUDA
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(0) - counts                        # exclusive
    pos_in_e = torch.arange(T * K, device=x.device) - offsets[se]
    valid = pos_in_e < C
    dest = torch.where(valid, se * C + pos_in_e, E * C)        # E*C = trash
    table = torch.full((E * C + 1,), T, dtype=torch.long,
                       device=x.device).scatter_(0, dest, st)[:E * C]

    x_pad = torch.cat([xf, xf.new_zeros(1, D)])
    yg = _expert_ffn(x_pad[table].reshape(E, C, D), p, variant)

    # combine: each (token, k)'s slot (E*C, a zero row, when dropped), its
    # experts in ascending order, added from zero in float32
    slot = torch.empty_like(dest)
    slot[order] = dest
    by_e = experts.argsort(dim=-1)
    slot = slot.view(T, K).gather(1, by_e)
    g = gate.gather(1, by_e)
    y_pad = torch.cat([yg.reshape(E * C, D).float(),
                       yg.new_zeros(1, D, dtype=torch.float32)])
    y = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + g[:, j:j + 1] * y_pad[slot[:, j]]
    out = y.to(x.dtype)
    if n_shared:
        out = out + L.mlp_apply(p["shared"], xf, variant)
    out = out.reshape(B, S, D)

    # aux losses / metrics (Switch/GShard load balance + z-loss)
    frac_tokens = counts.float() / max(T * K, 1)
    aux = {"lb_loss": E * (frac_tokens * probs.mean(0)).sum(),
           "z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
           "drop_frac": 1.0 - valid.float().mean()}
    return out, aux

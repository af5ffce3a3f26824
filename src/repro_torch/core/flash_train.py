"""Memory-efficient training attention for the drafter's MTP attention: the
MTP kernel forward with a recompute-by-block backward.

Counterpart of the JAX package's ``core/flash_train.py``. The forward is
``kernels.ops.mtp_attention(..., return_stats=True)``: the CUDA kernel of
``csrc/mtp_attention.cu`` on a CUDA tensor, the plain blocked attention on
a CPU tensor. It saves only (q, k, v, pos, depth, out, m, l); the backward
recomputes the probabilities one block of keys at a time, so training
attention memory is O(M·block) instead of the O(M²) probabilities autograd
would keep. The JAX backward is jnp, not Pallas, so the backward here is
plain PyTorch too.

The backward walks fixed blocks of ``block_k`` keys and the last block
holds the ragged remainder: unlike the JAX version, it never shrinks the
block to a divisor of M (M = 8522 = 2·4261 would give 2-key blocks).
Integer metadata gets no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core.masks import mtp_mask_predicate
from repro_torch.kernels import ops
from repro_torch.models.layers import NEG_INF

Tensor = torch.Tensor


class MTPFlashAttention(torch.autograd.Function):
    """out = MTP attention of q (B,M,H,hd) over k/v (B,M,KV,hd) with per-row
    pos/depth (B,M) int32; ``scale`` and ``block_k`` are Python numbers."""

    @staticmethod
    def forward(ctx, q, k, v, pos, depth, scale, block_k):
        out, m, l = ops.mtp_attention(q, k, v, pos, depth, scale=scale,
                                      return_stats=True)
        ctx.save_for_backward(q, k, v, pos, depth, out, m, l)
        ctx.scale, ctx.block_k = scale, block_k
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos, depth, out, m, l = ctx.saved_tensors
        scale, bk = ctx.scale, ctx.block_k
        B, M, H, hd = q.shape
        KV = k.shape[2]
        G = H // KV
        f32 = torch.float32
        qr = q.reshape(B, M, KV, G, hd).to(f32)
        dor = do.reshape(B, M, KV, G, hd).to(f32)
        # D_i = rowsum(dO * O)
        drow = torch.einsum("bqkgd,bqkgd->bkgq", dor,
                            out.reshape(B, M, KV, G, hd).to(f32))
        linv = 1.0 / l.clamp_min(1e-30)
        dq = torch.zeros((B, M, KV, G, hd), dtype=f32, device=q.device)
        dk = torch.empty((B, M, KV, hd), dtype=f32, device=q.device)
        dv = torch.empty_like(dk)
        for j0 in range(0, M, bk):
            j1 = min(j0 + bk, M)
            kj, vj = k[:, j0:j1].to(f32), v[:, j0:j1].to(f32)
            s = torch.einsum("bqkgd,bjkd->bkgqj", qr, kj) * scale
            ok = mtp_mask_predicate(depth, pos, depth[:, j0:j1],
                                    pos[:, j0:j1])[:, None, None]
            s = torch.where(ok, s, NEG_INF)
            # normalized probabilities; rows that see no key keep p = 0
            p = torch.where(ok, torch.exp(s - m[..., None]), 0.0) \
                * linv[..., None]
            dv[:, j0:j1] = torch.einsum("bkgqj,bqkgd->bjkd", p, dor)
            dp = torch.einsum("bqkgd,bjkd->bkgqj", dor, vj)
            ds = p * (dp - drow[..., None]) * scale
            dq += torch.einsum("bkgqj,bjkd->bqkgd", ds, kj)
            dk[:, j0:j1] = torch.einsum("bkgqj,bqkgd->bjkd", ds, qr)
        return (dq.reshape(B, M, H, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def mtp_flash_attention(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                        depth: Tensor, *, scale: float,
                        block_k: int = 512) -> Tensor:
    """q (B,M,H,hd); k/v (B,M,KV,hd); pos/depth (M,) or (B,M) int32
    (-1 pad). Differentiable in q, k and v."""
    B = q.shape[0]
    pos, depth = ops.row_metadata(pos, B), ops.row_metadata(depth, B)
    return MTPFlashAttention.apply(q.contiguous(), k.contiguous(),
                                   v.contiguous(), pos, depth, float(scale),
                                   int(block_k))

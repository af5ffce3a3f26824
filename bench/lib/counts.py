"""Operations and bytes, counted from shapes, and the card's peaks.

The yardstick of every roofline and utilization share: a kernel's least
time is the larger of its FLOPs over the peak rate of the precision it
computes in and its bytes over the memory bandwidth. Each input byte is
read once and each output byte written once, for the keys the inputs hold
live; FLOPs count multiply and add as two.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at
the full 700 W; a card set lower reports its limit beside the share).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2
F32 = 4
I32 = 4


@dataclass(frozen=True)
class Work:
    """A call's FLOPs (bfloat16 products, the served precision) and the
    bytes it moves."""
    flops: float
    bytes: float

    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS["bfloat16"],
                   self.bytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

def paged_decode_attention(B: int, T: int, H: int, KV: int, hd: int,
                           nb: int, keys: Sequence[int],
                           elt: int = BF16) -> Work:
    """One paged decode call: q (B, T, H, hd) against each row's live keys
    ``keys[b]`` (positions below the block) in the pool, through a block
    table (B, nb). Every query of row b sees keys[b] keys: QK and PV are
    4 FLOPs a (query head, key, head-dim element). Bytes: K and V and the
    position of each live key, q and out, the f32 (m, l) stats, the table
    and the query positions."""
    live = float(sum(keys))
    flops = 4.0 * T * H * hd * live
    byts = (live * (2 * KV * hd * elt + I32)
            + 2 * B * T * H * hd * elt + 2 * B * H * T * F32
            + B * nb * I32 + B * T * I32)
    return Work(flops, byts)


def flash_attention(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int,
                    causal: bool = True, kv_len: int = 0,
                    elt: int = BF16) -> Work:
    """One flash call, q (B, Sq, H, hd) against k/v (B, Skv, KV, hd) by
    index, keys at index >= kv_len masked (0: all real). Causal: query i
    (aligned to the end of the keys) sees keys up to Skv - Sq + i."""
    n = kv_len or Skv
    if causal:
        off = Skv - Sq
        seen = sum(max(0, min(off + i + 1, n)) for i in range(Sq))
    else:
        seen = Sq * n
    flops = 4.0 * B * H * hd * seen
    byts = (2 * B * Sq * H * hd + 2 * B * n * KV * hd) * elt
    return Work(flops, byts)


# ---------------------------------------------------------------------------
# the model's matrix products a token
# ---------------------------------------------------------------------------

def target_linear_flops(t: dict) -> float:
    """A target token's projection and MLP FLOPs over every layer (no
    head, no attention scores). ``t``: the configuration's ``target``
    group. An MoE layer counts its router and the top-k experts a token is
    routed to, not the capacity padding."""
    d, H, KV, hd = t["d_model"], t["n_heads"], t["n_kv_heads"], t["head_dim"]
    attn = 2.0 * d * hd * (2 * H + 2 * KV)
    moe = t.get("moe") or {}
    if moe.get("n_experts"):
        mlp = (2.0 * 3 * d * t["d_ff"] * moe["top_k"]
               + 2.0 * d * moe["n_experts"])
    else:
        mlp = 2.0 * 3 * d * t["d_ff"]
    return t["n_layers"] * (attn + mlp)


def head_flops(d: int, vocab: int) -> float:
    return 2.0 * d * vocab


def attention_flops(layers: int, H: int, hd: int, keys: float) -> float:
    """Scores and weighted values of one query over ``keys`` keys."""
    return 4.0 * layers * H * hd * keys


def drafter_fc_flops(dr: dict, t: dict) -> float:
    """``fc``: the drafter's projection of a position's taps."""
    return 2.0 * dr["num_taps"] * t["d_model"] * dr["d_model"]


def drafter_linear_flops(dr: dict) -> float:
    """A drafter token's fusion (``fuse`` over [embedding; hidden]) and
    its blocks' projections and MLPs (no fc, no head, no scores)."""
    d, H, KV = dr["d_model"], dr["n_heads"], dr["n_kv_heads"]
    hd = dr["head_dim"]
    block = 2.0 * d * hd * (2 * H + 2 * KV) + 2.0 * 3 * d * dr["d_ff"]
    return 2.0 * 2 * d * d + dr["n_layers"] * block


class ServeFlops:
    """The model FLOPs of a serving run, counted from the shapes of each
    admission and each step, all in bfloat16 (the served
    precision of target and drafter): the target over every prompt
    and verify token of the live rows, the drafter over its extend and
    draft tokens, attention over the keys each query sees. Padding
    (bucketed prompts, frozen rows) is not counted."""

    def __init__(self, config: dict, K: int):
        self.t, self.dr, self.K = config["target"], config["drafter"], K
        self.t_lin = target_linear_flops(self.t)
        self.t_head = head_flops(self.t["d_model"], self.t["vocab_size"])
        self.d_fc = drafter_fc_flops(self.dr, self.t)
        self.d_lin = drafter_linear_flops(self.dr)
        self.d_head = head_flops(self.dr["d_model"], self.t["vocab_size"])

    def admission(self, P: int) -> float:
        """A P-token prompt: the target's prefill with its head at the
        last position, the drafter's extend over P - 1 positions."""
        t, dr = self.t, self.dr
        f = (P * self.t_lin + self.t_head
             + attention_flops(t["n_layers"], t["n_heads"], t["head_dim"],
                               P * (P + 1) / 2)
             + (P - 1) * (self.d_fc + self.d_lin)
             + attention_flops(dr["n_layers"], dr["n_heads"], dr["head_dim"],
                               (P - 1) * P / 2))
        return f

    def step(self, lengths: Sequence[int]) -> float:
        """One speculative step over live rows whose last committed
        position is ``lengths[b]``: verify K + 1 tokens (their logits
        too), draft K (fc once a row: its MTP slots take no taps), extend
        K + 1. Query i of a block at position c sees
        c keys in the cache plus i + 1 in the block (the draft: c - 1)."""
        t, dr, K = self.t, self.dr, self.K
        A = len(lengths)
        keys = float(sum(lengths))
        blk = (K + 1) * (K + 2) / 2
        f = A * (K + 1) * (self.t_lin + self.t_head)
        f += attention_flops(t["n_layers"], t["n_heads"], t["head_dim"],
                             (K + 1) * keys + A * blk)
        f += A * (self.d_fc + K * (self.d_lin + self.d_head))
        f += attention_flops(dr["n_layers"], dr["n_heads"], dr["head_dim"],
                             K * (keys - A) + A * K * (K + 1) / 2)
        f += A * (K + 1) * (self.d_fc + self.d_lin)
        f += attention_flops(dr["n_layers"], dr["n_heads"], dr["head_dim"],
                             (K + 1) * keys + A * blk)
        return f

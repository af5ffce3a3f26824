#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one card: builds the attention
kernels from the sources in this checkout, holds each against its plain
PyTorch version, serves the full-width qwen2-1.5b with the 4-layer
parallel drafter through the kernels (whole batch, and continuous batching
over the paged KV layout), checks greedy losslessness, serves sampled
requests (seeded rejection verification) and checks their streams, and
trains the full-width drafter (whole-sequence and Algorithm-1 segmented)
through the MTP kernel.

    python3 chip_smoke.py            # from the root of a checkout, on the card

Phases, in order; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then the
   four kernels built with nvcc, all at once (build seconds, -Xptxas -v
   report);
2. kernels: each kernel against its plain version on the card at the
   serving path's shapes and at the JAX kernel sweep's shapes, on inputs
   whose scores spread as a trained model's do (tolerance: two bfloat16
   rounding steps of the output, 1e-4 + 2^-6 |plain|, in bfloat16; 1e-4 in
   float32; the worst share of the limit is printed per kernel), with the
   kernel, the plain version
   and one PyTorch call for the same function (scaled_dot_product_attention,
   a yardstick the port never calls) timed with CUDA events, beside the
   least time the card could take (bytes over 3.35 TB/s or FLOPs over the
   dtype's peak, whichever is larger). The bfloat16 decode, paged decode
   and flash kernels and the MTP kernel run tensor-core bodies (split-K
   decode, the same body through a block table for paged, FlashAttention-2
   style flash, a depth-split key walk in 3xTF32 for MTP), so their edges
   are checked too: decode with S not a multiple of the split chunk, chunks
   holding no live key, rows seeing no key (zeros, l 0, m -1e30), a window
   across chunks and T 511; paged with 64-key tiles over 8, 4 and 2 pages,
   nb x page not a multiple of 64, -1 and out-of-pool ids inside live
   tiles, one split and many, and tables all -1, one launch count a call;
   flash with ragged query and key tiles (500 tokens), one token,
   Sq != Skv and kv_len < Skv.
   Flash is timed at the prefill (B 8 x 512), a training tap (B 1 x 2048)
   and an admission bucket (B 1 x 512), decode at every serving phase.
   The MTP kernel is held against its plain version, output and stats
   (m, l), at the training shape (n 2048, K 8, r 0.8: M 8522, the
   drafter's 12/12 heads), at the largest Algorithm-1 segment of n 4096 in
   4 segments (its depth-0 context before an interleaved block), at the
   JAX kernel sweep's shapes (per-row layouts, GQA, pad rows), on a COD
   layout in random order, on GQA segments, on a layout with no chain keys
   (K 1) and on a padding-rows case; its SDPA yardstick takes the dense
   predicate mask, built outside the timed call, and its time stands beside
   two bounds, both logged: f32 FLOPs at the f32 FMA peak, and the 3xTF32
   split's three TF32 products at the TF32 tensor-core peak; the kernels
   line's bound_ms is the smaller (for float32, the tensor-core one). The
   paged decode kernel is held against its plain version (which gathers
   each row's pages) at the serving path's phase-1 shapes (batch 8,
   page 16, 64 table entries a row, pages drawn at random from the pool, so
   tables are fragmented) and at the JAX kernel sweep's shapes; no single
   PyTorch call computes it, so its yardstick is a gather of the pages and
   SDPA on the view, two calls. Then the gradients of the flash training
   attention (kernel forward, recompute-by-block backward) against autograd
   through the plain version at M 1998, float32;
3. main path: Engine.run of full-width qwen2-1.5b in bfloat16, batch 8,
   512-token prompts, 128 new tokens, K 5, a 1024-slot bfloat16 cache,
   after a cold run of 8 steps; the warm run is reported (OTPS, prefill seconds, decode seconds
   per step, acceptance length, peak memory) with the kernels' launch
   counts, which must be 28 flash launches per prefill and 8 + 72 decode
   launches per step (drafter prefill extend; target verify 28x2, draft
   4x2, extend 4x2). The drafter is untrained, so AL ~ 1 is expected;
3b. continuous batching: Scheduler.serve of the same model over the paged
   layout (batch 8, max_len 1024, page 16, a 256-page pool: half of what 8
   full rows need, so requests are preempted), incremental growth,
   bucketed admission prefill; 24 requests, prompts of 256-640 tokens and
   budgets of 64-192 drawn from seed 0, Exp(1) arrival gaps on the
   virtual clock, no EOS; after a cold serve of the first 8 prompts with
   8-token budgets, the warm run reported (OTPS, virtual
   clock OTPS and p50/p99 latency, wall seconds, peak pages, preemptions)
   and checked: every request finishes once with its budget, preemptions
   occur, the pool ends empty, and every decode step launched the paged
   kernel 36 times (28 target verify, 4 draft, 4 extend, phase 1);
4. losslessness, at full width in float32: the target's logits through the
   kernels against the same forward with the plain attention, for a
   prefill into the cache (flash) and a verify block read against it
   (decode); then parallel, ar and none on the same prompts, and parallel
   again with oracle drafts (the none run's own tokens, a seeded fifth of
   them spoiled) so that drafts are accepted (AL must exceed 2), and a
   paged Scheduler.serve of the same prompts under pool pressure. A token
   that differs from none must sit at a near-tie of the none run;
3c / 4b. sampled serving: the threefry PRNG's known answers (JAX 0.9.0's
   words) on the card and the CPU, and 3 x 2^20 uniforms bitwise equal
   between them; then, bfloat16 at phase 3's shapes, Engine.run under
   temperature 0.8, top-k 50, top-p 0.95, seed 0 with draft sampling off
   and on, and Scheduler.serve of phase 3b's traffic with even requests
   greedy and odd ones sampled (seed = index): OTPS, ms/step or
   ms/iteration and AL beside phase 3 / 3b's greedy numbers, and the
   attention launch counts of the greedy path's formula (sampling adds no
   attention launch); then, float32 full width (phase 4's prompts): two
   seeded runs identical, each sampled request's stream the same served
   alone and in a mixed batch, contiguous and paged under pool pressure
   that preempts sampled requests, greedy rows equal to phase 4's greedy
   run (a stream may part only after a decision of margin < 1e-4 for
   sampled ones, a top-2 logit gap < 1e-3 for greedy ones), and the
   chi-square losslessness check of rejection_verify_rows on the card
   (first committed token over 2^14 rows against the warped target, one-hot
   and sampled drafts, at the 0.999 quantile);
5. training at full width: qwen2-1.5b bfloat16 target (seeded weights), the
   4-layer full-width drafter in float32, markov_corpus, batch 1, through
   Trainer.train_batch: (a) 3 whole-sequence steps at n 2048 (M 8522) and
   (b) 3 segmented steps at n 4096 in 4 Algorithm-1 segments, each with
   s/step, label tokens/s, peak memory, a CUDA-event split of each step
   into target taps / drafter forward / backward / optimizer, and launch
   counts (mtp_attention = drafter layers x forward passes, flash = 28 per
   target forward); then segmented grads against whole-sequence grads at
   n 1024, the loss over 4 steps on one repeated batch, a checkpoint round
   trip, and the training launcher (python -m repro_torch.launch.train).

The second-to-last line is a JSON object of the kernels' numbers, the last
line the result.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# dense peaks: bf16 and TF32 on the tensor cores, f32 on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
L2_BYTES = 50e6
SLEEP_CYCLES_PER_S = 2e9        # torch.cuda._sleep counts SM clock cycles
# (atol, rtol) of |kernel - plain| <= atol + rtol * |plain|, elementwise.
# The kernels and the plain versions both compute in float32 and round the
# output once, so in bfloat16 they differ by at most one rounding step of
# the output (2^-7 of its magnitude); the limit allows two. Float32 sums
# differ in order only.
KERNEL_TOL = {"bfloat16": (1e-4, 2 ** -6), "float32": (1e-4, 0.0)}
# Query scale of the kernel inputs: q ~ 2 N(0, 1), k, v ~ N(0, 1), so scores
# q.k / sqrt(hd) have a std of 2 and attention is peaked, as in a trained
# model: a dropped or misplaced key tile moves the output by far more than
# the tolerance.
Q_SCALE = 2.0
# Oracle drafts must lift the acceptance length above this (a fifth of the
# drafts are spoiled, so about 3.7 is expected at K 5).
ORACLE_MIN_AL = 2.0
# A greedy token may differ between modes only where the reference's top-2
# logit gap is below this: the float32 verify (K+1 queries) and the plain
# decode (1 query) run GEMMs of other shapes, whose sums reorder and move
# logits by about 1e-5 at full width.
NEAR_TIE = 1e-3
# Full-width float32 logits through the kernels against the same forward
# with the plain attention: the two differ only in the order of float32
# sums inside attention, carried through 28 layers.
REF_TOL = 1e-3
# The flash kernel's timed shapes, one per path that runs it: the serving
# prefill (phase 3), a training tap (phase 5, n 2048) and an admission
# prefill of the scheduler (phase 3b: batch 1, a prompt of 256-640 tokens
# padded to the next power of two).
FLASH_MAIN = [("target prefill", (8, 512, 512, 12, 2, 128)),
              ("training tap", (1, 2048, 2048, 12, 2, 128)),
              ("admission bucket 512", (1, 512, 512, 12, 2, 128))]
# MTP stats (m, l) against the plain version's: |got - want| / (1 + |want|).
STATS_TOL = 1e-4
# Gradients of the flash training attention (kernel forward, plain
# backward) against autograd through the plain version, float32: each
# element within this share of its tensor's largest |gradient|. Both sides
# run f32 with TF32 off; they differ in the order of the sums only.
GRAD_TOL = 1e-4
# Segmented (Algorithm 1) against whole-sequence drafter gradients at full
# width, float32: each leaf within this share of its largest |gradient|.
# The segments change the shapes of every product (and the kernel's tiles),
# so the f32 sums run in another order; nothing else differs.
SEG_GRAD_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, sets, iters, host_us=200):
    """Mean device ms per call of fn(*inputs), cycling over input sets so
    the working set exceeds the L2 cache, after one warm-up call per set.

    The host enqueues a call more slowly than the card runs a small one, so
    the start event is queued behind a sleep kernel long enough for every
    call to be enqueued before the card reaches them: the events then
    bracket the calls back to back, the device time alone."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * host_us * 1e-6 * SLEEP_CYCLES_PER_S))
    a.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def n_sets(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def qkv(g, dev, dtype, q_shape, kv_shape):
    dt = getattr(torch, dtype)
    return tuple((scale * torch.randn(s, generator=g, device=dev)).to(dt)
                 for scale, s in ((Q_SCALE, q_shape), (1.0, kv_shape),
                                  (1.0, kv_shape)))


def decode_case(dev, dtype, B, T, H, KV, hd, S, valid):
    """Inputs shaped like one decode call: a cache of S slots whose first
    `valid` hold positions 0..valid-1 (the rest empty), queries at the next
    T positions. For the phase-2 shapes (S == T) the keys are the block."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = qkv(g, dev, dtype, (B, T, H, hd), (B, S, KV, hd))
    kpos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    if S == T and valid == S:
        qpos = kpos.clone()
    else:
        kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32)
        qpos = (valid + torch.arange(T, dtype=torch.int32, device=dev))[
            None].repeat(B, 1)
    return q, k, v, kpos.contiguous(), qpos.contiguous()


def decode_work(q, k, kpos, qpos):
    """Bytes and FLOPs a decode call needs for this data: q, out and the
    (m, l) stats once, positions once, K/V of the keys some query of the row
    can see, and 4·hd FLOPs per visible (query head, key) pair."""
    B, T, H, hd = q.shape
    KV, es = k.shape[2], q.element_size()
    vis = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    live_keys = int(vis.any(1).sum())
    nbytes = (2 * B * T * H * hd * es + 2 * B * T * H * 4
              + 4 * (kpos.numel() + qpos.numel()) + 2 * live_keys * KV * hd * es)
    flops = 4 * hd * H * int(vis.sum())
    return nbytes, flops


def flash_work(q, k):
    """Bytes and FLOPs of a causal flash call: q, k, v and out once, 4·hd
    FLOPs per visible (query head, key) pair."""
    B, Sq, H, hd = q.shape
    Skv, KV, es = k.shape[1], k.shape[2], q.element_size()
    nbytes = 2 * B * Sq * H * hd * es + 2 * B * Skv * KV * hd * es
    pairs = sum(min(t + 1, Skv) for t in range(Sq))
    return nbytes, 4 * hd * H * B * pairs


def sdpa_decode(q, k, v, kpos, qpos):
    """One PyTorch call for the decode function: SDPA with a boolean mask,
    in SDPA's (B, H, L, hd) layout, prepared outside the timed call."""
    mask = ((kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None]))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            mask[:, None])
    return lambda: F.scaled_dot_product_attention(
        args[0], args[1], args[2], attn_mask=args[3], enable_gqa=True)


def sdpa_flash(q, k, v):
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return lambda: F.scaled_dot_product_attention(*args, is_causal=True,
                                                  enable_gqa=True)


def paged_case(dev, dtype, B, T, H, KV, hd, page, nb, c, seed=0):
    """Inputs shaped like one phase-1 call of the paged serving path: a pool
    of B * nb pages and the sink, each row's table naming pages drawn at
    random from it (enough for positions up to c + T), the row holding
    positions 0..c-1, queries at c..c+T-1. Pages no table names hold stale
    positions the kernel must not see."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    NP = B * nb + 1
    q, k, v = qkv(g, dev, dtype, (B, T, H, hd), (NP, page, KV, hd))
    pos = rng.integers(0, nb * page, (NP, page)).astype(np.int32)
    table = np.full((B, nb), -1, np.int32)
    n = -(-(c + T) // page)
    perm = rng.permutation(NP - 1)
    for b in range(B):
        table[b, :n] = perm[b * n:(b + 1) * n]
        logical = np.arange(n * page).reshape(n, page)
        pos[table[b, :n]] = np.where(logical < c, logical, -1)
    qpos = np.broadcast_to(c + np.arange(T), (B, T)).astype(np.int32)
    return (q, k, v) + tuple(torch.as_tensor(a, device=dev).contiguous()
                             for a in (pos, table, qpos))


def paged_sweep_case(dev, dtype, B, T, H, KV, hd, NP, page, nb, seed):
    """The JAX paged kernel sweep's layout: rows of random lengths owning
    distinct random pages, later table entries -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    q, k, v = qkv(g, dev, dtype, (B, T, H, hd), (NP, page, KV, hd))
    pos = np.full((NP, page), -1, np.int32)
    table = np.full((B, nb), -1, np.int32)
    qpos = np.zeros((B, T), np.int32)
    perm, used = rng.permutation(NP), 0
    for b in range(B):
        n = int(rng.integers(1, nb + 1))
        table[b, :n] = perm[used:used + n]
        used += n
        length = int(rng.integers(1, n * page + 1))
        logical = np.arange(n * page).reshape(n, page)
        pos[table[b, :n]] = np.where(logical < length, logical, -1)
        qpos[b] = length - 1 + np.arange(T)
    return (q, k, v) + tuple(torch.as_tensor(a, device=dev).contiguous()
                             for a in (pos, table, qpos))


def paged_work(q, k, pos, table, qpos):
    """Bytes and FLOPs a paged call needs for this data: q, out and the
    (m, l) stats once, the table and query positions once, the positions of
    the pages the tables name once, K/V of the keys some query of the row
    can see, and 4·hd FLOPs per visible (query head, key) pair."""
    from repro_torch.models.layers import paged_view
    B, T, H, hd = q.shape
    KV, es = k.shape[2], q.element_size()
    kpos = paged_view(pos, table, empty=-1)
    vis = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    live_keys = int(vis.any(1).sum())
    named = int((table >= 0).sum()) * pos.shape[1]
    nbytes = (2 * B * T * H * hd * es + 2 * B * T * H * 4
              + 4 * (table.numel() + qpos.numel() + named)
              + 2 * live_keys * KV * hd * es)
    return nbytes, 4 * hd * H * int(vis.sum())


def gather_sdpa(q, k, v, pos, table, qpos):
    """The paged function in two PyTorch calls: gather each row's pages
    into a view, then SDPA with a boolean mask on it."""
    from repro_torch.models.layers import paged_view

    def run():
        kpos = paged_view(pos, table, empty=-1)
        mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), paged_view(k, table).transpose(1, 2),
            paged_view(v, table).transpose(1, 2), attn_mask=mask[:, None],
            enable_gqa=True)
    return run


def check_kernels(ops, dev):
    """Every kernel against its plain version; returns the per-kernel
    measurements of the main-path shapes (the MTP kernel's keyed by
    (label, dtype))."""
    worst = {"decode_attention": 0.0, "paged_decode_attention": 0.0,
             "flash_attention": 0.0}
    shares = {}      # (kernel, dtype) -> the worst share of the limit
    rows = {}

    def compare(name, got, want, dtype, label):
        atol, rtol = KERNEL_TOL[dtype]
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # the worst element's share of its own limit: <= 1 passes
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        shares[(name, dtype)] = max(shares.get((name, dtype), 0.0), used)
        ok = used <= 1.0
        log(f"  {name:22s} {dtype:8s} {label:46s} max_abs_err {err:.3e} "
            f"(max |plain| {want.float().abs().max().item():.3f}, "
            f"{used:.2f} of the limit) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {label} {dtype}: an element differs by {used:.2f} "
                 f"times its limit {atol} + {rtol} |plain| (max abs err "
                 f"{err})")
        return err

    # serving path shapes: full-width qwen2-1.5b (12 heads over 2 KV heads)
    # and its drafter (12 heads, no GQA), batch 8, cache 1024, K 5, a row
    # 576 tokens in (512 prompt + 64 generated), prompt 512
    c = 576
    decode_main = [
        ("target verify phase 1", (8, 6, 12, 2, 128, 1024, c)),
        ("target verify phase 2", (8, 6, 12, 2, 128, 6, 6)),
        ("drafter draft phase 1", (8, 5, 12, 12, 128, 1024, c - 1)),
        ("drafter draft phase 2", (8, 5, 12, 12, 128, 5, 5)),
        ("drafter extend phase 1", (8, 6, 12, 12, 128, 1024, c)),
        ("drafter extend phase 2", (8, 6, 12, 12, 128, 6, 6)),
        ("drafter prefill extend phase 1", (8, 511, 12, 12, 128, 1024, 0)),
        ("drafter prefill extend phase 2", (8, 511, 12, 12, 128, 511, 511)),
        # phase 3b's batch-1 admission prefill: the drafter's extend over a
        # bucket of 512 or 256, or over an exact-length prompt of up to 640
        # (a bucket of 1024 would reach max_len); 4 splits over 4-10 row tiles
        ("admission extend phase 1", (1, 511, 12, 12, 128, 1024, 0)),
        ("admission extend phase 2", (1, 511, 12, 12, 128, 511, 511)),
        ("admission extend 256 phase 2", (1, 255, 12, 12, 128, 255, 255)),
        ("admission extend exact phase 2", (1, 638, 12, 12, 128, 638, 638)),
    ]
    def check_stats(name, label, dtype, got, want):
        # stats: relative to 1 + |value| (l grows with the visible keys)
        for stat, g_, w_ in zip("ml", got, want):
            rel = ((g_ - w_).abs() / (1 + w_.abs())).max().item()
            if not rel <= KERNEL_TOL["float32"][0]:
                fail(f"{name} {label} {dtype}: {stat} relative err {rel}")

    log("phase 2: kernels against their plain versions on the card")
    for dtype in ("bfloat16", "float32"):
        for label, (B, T, H, KV, hd, S, valid) in decode_main:
            inp = decode_case(dev, dtype, B, T, H, KV, hd, S, valid)
            o, m, l = ops.decode_attention(*inp, scale=hd ** -0.5,
                                           return_stats=True)
            torch.cuda.synchronize()
            po, pm, pl = ops.decode_attention_plain(*inp, scale=hd ** -0.5,
                                                    return_stats=True)
            err = compare("decode_attention", o, po, dtype, label)
            check_stats("decode_attention", label, dtype, (m, l), (pm, pl))
            if dtype == "bfloat16":
                worst["decode_attention"] = max(worst["decode_attention"], err)
                rows[("decode_attention", label)] = inp
        # the JAX kernel sweep's shapes, then the edges of the split-K body:
        # at target verify phase 1 (16 chunks of 64 slots) the chunks past
        # the 576 live slots hold no live key
        sweep = [("sweep", (2, 6, 4, 2, 64, 256, 192, 0)),
                 ("sweep", (1, 1, 4, 4, 32, 512, 384, 0)),
                 ("sweep", (2, 6, 4, 2, 64, 256, 192, 64)),
                 ("sweep", (1, 8, 2, 1, 128, 96, 72, 0)),
                 ("S not a multiple of the chunk",
                  (8, 6, 12, 2, 128, 1000, 600, 0)),
                 ("every key empty", (8, 6, 12, 2, 128, 1024, 0, 0)),
                 ("window across chunks", (8, 6, 12, 2, 128, 1024, 600, 100)),
                 ("row tiles x splits, live keys",
                  (1, 200, 12, 2, 128, 1024, 600, 0)),
                 ("row tiles x splits, window",
                  (1, 200, 12, 2, 128, 1024, 600, 150))]
        for what, (B, T, H, KV, hd, S, valid, window) in sweep:
            label = f"{what} {(B, T, H, KV, hd, S)} w{window}"
            inp = decode_case(dev, dtype, B, T, H, KV, hd, S, valid)
            o, m, l = ops.decode_attention(*inp, scale=hd ** -0.5,
                                           window=window, return_stats=True)
            torch.cuda.synchronize()
            po, pm, pl = ops.decode_attention_plain(
                *inp, scale=hd ** -0.5, window=window, return_stats=True)
            compare("decode_attention", o, po, dtype, label)
            check_stats("decode_attention", label, dtype, (m, l), (pm, pl))
            if valid == 0 and not (o.abs().max().item() == 0.0
                                   and (l == 0).all() and (m == -1e30).all()):
                fail(f"decode_attention {label} {dtype}: rows that see no "
                     f"key are not zeros with l 0, m -1e30")

        # paged phase 1 at the serving shapes: the drafter's draft block
        # sits one position back (anchor c - 1), its cache below it
        paged_main = [("target verify phase 1", (8, 6, 12, 2, c)),
                      ("drafter draft phase 1", (8, 5, 12, 12, c - 1)),
                      ("drafter extend phase 1", (8, 6, 12, 12, c))]
        cases = [(label, paged_case(dev, dtype, B, T, H, KV, 128, 16, 64,
                                    cc, seed=i))
                 for i, (label, (B, T, H, KV, cc)) in enumerate(paged_main)]
        for i, shp in enumerate([(2, 6, 4, 2, 64, 12, 16, 4),
                                 (1, 1, 4, 4, 32, 8, 32, 3),
                                 (3, 4, 2, 1, 128, 16, 8, 6)]):
            cases.append((f"sweep {shp}",
                          paged_sweep_case(dev, dtype, *shp, seed=10 + i)))
        # the edges of the split-K body: a 64-key tile over 8 or 2 pages,
        # nb x page not a multiple of 64, one split (row tiles fill the
        # card), -1 and out-of-pool ids inside live tiles, tables all -1
        for label, (B, T, page, nb, cc) in [
                ("edge: tile over 8 pages, page 8", (8, 6, 8, 128, c)),
                ("edge: tile over 2 pages, page 32", (8, 6, 32, 32, c)),
                ("edge: nb x page 592", (8, 6, 16, 37, c)),
                ("edge: one split, T 200", (4, 200, 16, 40, 300))]:
            cases.append((label, paged_case(dev, dtype, B, T, 12, 2, 128,
                                            page, nb, cc, seed=20)))
        q, k, v, pos, table, qpos = paged_case(dev, dtype, 8, 6, 12, 2, 128,
                                               16, 64, c, seed=21)
        holes = table.clone()
        n_live = -(-(c + 6) // 16)
        holes[:, 0] = -1
        holes[:, n_live // 2] = k.shape[0] + 7
        holes[:, n_live - 1] = 2 ** 30
        cases += [("edge: -1, out-of-pool ids in live tiles",
                   (q, k, v, pos, holes, qpos)),
                  ("edge: every table entry -1",
                   (q, k, v, pos, torch.full_like(table, -1), qpos))]
        for label, inp in cases:
            hd = inp[0].shape[-1]
            before = ops.launches["paged_decode_attention"]
            o, m, l = ops.paged_decode_attention(*inp, scale=hd ** -0.5,
                                                 return_stats=True)
            torch.cuda.synchronize()
            if ops.launches["paged_decode_attention"] != before + 1:
                fail(f"paged_decode_attention {label}: a call moved the "
                     f"launch count by "
                     f"{ops.launches['paged_decode_attention'] - before}")
            po, pm, pl = ops.paged_decode_attention_plain(
                *inp, scale=hd ** -0.5, return_stats=True)
            err = compare("paged_decode_attention", o, po, dtype, label)
            check_stats("paged_decode_attention", label, dtype, (m, l),
                        (pm, pl))
            if "every table entry -1" in label and not (
                    o.abs().max().item() == 0.0 and (l == 0).all()
                    and (m == -1e30).all()):
                fail(f"paged_decode_attention {label} {dtype}: not zeros "
                     f"with l 0, m -1e30")
            if dtype == "bfloat16" and label in dict(paged_main):
                worst["paged_decode_attention"] = max(
                    worst["paged_decode_attention"], err)
                rows[("paged_decode_attention", label)] = inp

        g = torch.Generator(device=dev).manual_seed(1)
        # the paths' shapes (prefill, training tap, an admission bucket)
        # first, then the JAX kernel sweep's and the edges of the
        # tensor-core body: ragged query and key tiles, one token, Sq != Skv
        # and keys at index >= kv_len
        flash = [(label, shp, True, 0, 0.0, 0) for label, shp in FLASH_MAIN]
        for shp in [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 32),
                    (1, 64, 192, 2, 1, 128), (2, 96, 96, 6, 2, 64)]:
            for causal, window, cap in [(True, 0, 0.0), (True, 64, 0.0),
                                        (True, 0, 50.0), (False, 0, 0.0)]:
                flash.append((f"sweep {shp} c{int(causal)} w{window} cap{cap:g}",
                              shp, causal, window, cap, 0))
        for shp, causal, kv_len in [((8, 500, 500, 12, 2, 128), True, 0),
                                    ((1, 1, 1, 12, 2, 128), True, 0),
                                    ((2, 100, 300, 4, 2, 64), True, 0),
                                    ((2, 300, 100, 4, 2, 64), True, 0),
                                    ((2, 256, 256, 4, 2, 64), True, 200),
                                    ((2, 200, 256, 4, 2, 128), False, 150)]:
            flash.append((f"edge {shp} c{int(causal)} kv_len {kv_len}", shp,
                          causal, 0, 0.0, kv_len))
        for label, shp, causal, window, cap, kv_len in flash:
            B, Sq, Skv, H, KV, hd = shp
            q, k, v = qkv(g, dev, dtype, (B, Sq, H, hd), (B, Skv, KV, hd))
            kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                      softcap=cap, kv_len=kv_len)
            o = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = compare("flash_attention", o,
                          ops.flash_attention_plain(q, k, v, **kw), dtype,
                          label)
            if dtype == "bfloat16" and label in dict(FLASH_MAIN):
                if label == "target prefill":
                    worst["flash_attention"] = err
                rows[("flash_attention", label)] = (q, k, v)

    log("phase 2: timing at the serving shapes (bfloat16; CUDA events)")
    measured = {}
    for (name, label), inp in rows.items():
        if name == "decode_attention":
            q, k, v, kpos, qpos = inp
            nbytes, flops = decode_work(q, k, kpos, qpos)
            hd = q.shape[-1]
            sets = [inp] + [tuple(x.clone() for x in inp)
                            for _ in range(n_sets(nbytes) - 1)]
            ms = time_ms(lambda *a: ops.decode_attention(
                *a, scale=hd ** -0.5, return_stats=True), sets, 200)
            plain_ms = time_ms(lambda *a: ops.decode_attention_plain(
                *a, scale=hd ** -0.5, return_stats=True), sets[:2], 10,
                host_us=5000)
            lib = sdpa_decode(*inp)
            lib_ms = time_ms(lambda: lib(), [()], 100)
        elif name == "paged_decode_attention":
            q, k, v, pos, table, qpos = inp
            nbytes, flops = paged_work(q, k, pos, table, qpos)
            hd = q.shape[-1]
            sets = [inp] + [tuple(x.clone() for x in inp)
                            for _ in range(n_sets(nbytes) - 1)]
            ms = time_ms(lambda *a: ops.paged_decode_attention(
                *a, scale=hd ** -0.5, return_stats=True), sets, 200)
            plain_ms = time_ms(lambda *a: ops.paged_decode_attention_plain(
                *a, scale=hd ** -0.5, return_stats=True), sets[:2], 10,
                host_us=5000)
            # no single PyTorch call computes it: library_ms stays null and
            # the two-call yardstick is reported beside it
            if label == "target verify phase 1":
                log("  paged_decode_attention: no single PyTorch call computes"
                    " it (library_ms null); yardstick: gather + SDPA, two "
                    "calls")
            two = gather_sdpa(*inp)
            lib_ms = None
            gather_sdpa_ms = time_ms(lambda: two(), [()], 50, host_us=1000)
        else:
            q, k, v = inp
            nbytes, flops = flash_work(q, k)
            hd = q.shape[-1]
            sets = [inp] + [tuple(x.clone() for x in inp)
                            for _ in range(n_sets(nbytes) - 1)]
            ms = time_ms(lambda *a: ops.flash_attention(
                *a, scale=hd ** -0.5), sets, 50)
            plain_ms = time_ms(lambda *a: ops.flash_attention_plain(
                *a, scale=hd ** -0.5), sets[:2], 5, host_us=5000)
            lib = sdpa_flash(*inp)
            lib_ms = time_ms(lambda: lib(), [()], 50)
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        measured[(name, label)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, bytes=nbytes,
                                       flops=flops)
        lib_txt = (f"sdpa {lib_ms * 1e3:8.1f} us" if lib_ms is not None else
                   f"gather + sdpa (two calls) {gather_sdpa_ms * 1e3:8.1f} us")
        if lib_ms is None:
            measured[(name, label)]["gather_sdpa_ms"] = gather_sdpa_ms
        log(f"  {name:22s} {label:32s} {ms * 1e3:9.1f} us  plain "
            f"{plain_ms * 1e3:9.1f} us  {lib_txt}  bound "
            f"{bound_ms * 1e3:6.2f} us ({bound_by}; {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
    log("phase 2: the MTP kernel against its plain version")
    measured["mtp_attention"] = check_mtp(ops, dev, compare)
    log("phase 2: the worst share of the limit, per kernel: " + ", ".join(
        f"{name} {dtype} {share:.3f}"
        for (name, dtype), share in sorted(shares.items())))
    log("phase 2: flash training attention gradients (float32, TF32 off)")
    check_mtp_backward(dev)
    return worst, measured


# ---------------------------------------------------------------------------
# phase 2: the MTP kernel
# ---------------------------------------------------------------------------

def mtp_layout(n, K, r, seed, pad_to=64):
    """A COD layout (pos, depth) of length expanded_length(n, K, r), padded
    with -1 to a multiple of ``pad_to`` (1: no padding)."""
    from repro_torch.core import cod
    pos, dep = cod.sample_cod(np.random.default_rng(seed), n, K, r)
    M = int(np.ceil(len(pos) / pad_to) * pad_to)
    return cod.pad_to(pos, dep, M)


def mtp_segment_layout(n, K, r, S, seed):
    """The largest Algorithm-1 segment of one n-token sequence: its kv set
    (the segment's queries and the depth-0 context below its boundary),
    padded to a multiple of 64 as the pipeline pads it."""
    from repro_torch.core import cod, partition
    pos, dep = cod.sample_cod(np.random.default_rng(seed), n, K, r)
    seg = max(partition.build_segments(pos, dep, n, S),
              key=lambda sg: len(sg.kv_pos))
    M = int(np.ceil(len(seg.kv_pos) / 64) * 64)
    return cod.pad_to(seg.kv_pos, seg.kv_depth, M)


def shuffled(layout, seed):
    """A layout in random order (pad rows among the real ones)."""
    perm = np.random.default_rng(seed).permutation(len(layout[0]))
    return layout[0][perm], layout[1][perm]


def mtp_case(dev, dtype, B, H, KV, hd, layouts, seed):
    """q, k, v and per-row (B, M) pos/depth on the card, one layout a row
    (padded with -1 to the longest)."""
    from repro_torch.core import cod
    g = torch.Generator(device=dev).manual_seed(seed)
    M = max(len(p) for p, _ in layouts)
    layouts = [cod.pad_to(p, d, M) for p, d in layouts]
    q, k, v = qkv(g, dev, dtype, (B, M, H, hd), (B, M, KV, hd))
    pos = torch.as_tensor(np.stack([p for p, _ in layouts]), device=dev)
    dep = torch.as_tensor(np.stack([d for _, d in layouts]), device=dev)
    return q, k, v, pos.contiguous(), dep.contiguous()


def mtp_visible(pos, dep, chunk=1024):
    """(query, key) pairs the predicate allows, per row: (B,) int64,
    counted in row chunks on the card (never an M x M mask at once)."""
    from repro_torch.core.masks import mtp_mask_predicate
    M = pos.shape[1]
    n = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for i in range(0, M, chunk):
        n += mtp_mask_predicate(dep[:, i:i + chunk], pos[:, i:i + chunk],
                                dep, pos).sum((1, 2))
    return n


def mtp_work(q, k, pos, dep):
    """Bytes and FLOPs of an MTP call for this data: q and out once, K/V of
    the live keys (depth >= 0; each sees itself) once, pos/depth once, the
    (m, l) stats once, and 4·hd FLOPs per visible (query head, key) pair
    (the 3xTF32 split does three TF32 products of each: 3x these FLOPs on
    the tensor cores)."""
    B, M, H, hd = q.shape
    KV, es = k.shape[2], q.element_size()
    live = int((dep >= 0).sum())
    nbytes = (2 * B * M * H * hd * es + 2 * live * KV * hd * es
              + 2 * 4 * B * M + 2 * 4 * B * H * M)
    return nbytes, 4 * hd * H * int(mtp_visible(pos, dep).sum())


def sdpa_mtp(q, k, v, pos, dep):
    """One PyTorch call for the MTP function: SDPA with the dense predicate
    mask (B, 1, M, M), built here, outside the timed call."""
    from repro_torch.core.masks import mtp_mask_predicate
    mask = mtp_mask_predicate(dep, pos, dep, pos)[:, None]
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask)
    return lambda: F.scaled_dot_product_attention(
        args[0], args[1], args[2], attn_mask=args[3], enable_gqa=True)


def check_mtp(ops, dev, compare):
    """The MTP kernel against its plain version at every listed shape, in
    bfloat16 and float32, with its stats; returns the worst error per dtype
    at the training shape and the timed rows."""
    timed_labels = ("training shape n 2048 K 8 r 0.8",
                    "segment n 4096 K 8 r 0.8 S 4 (largest)")
    cases = [(timed_labels[0], 1, 12, 12, 128,
              [mtp_layout(2048, 8, 0.8, seed=0, pad_to=1)]),
             (timed_labels[1], 1, 12, 12, 128,
              [mtp_segment_layout(4096, 8, 0.8, 4, seed=0)])]
    for n, K, r in [(48, 4, 0.7), (32, 8, 0.8), (24, 2, 0.5)]:
        for B, H, KV, hd in [(2, 4, 2, 64), (1, 2, 2, 32)]:
            cases.append((f"sweep n{n} K{K} r{r} {(B, H, KV, hd)}", B, H, KV,
                          hd, [mtp_layout(n, K, r, seed=b) for b in range(B)]))
    # the edges of the depth-split walk: rows in random order, GQA segments
    # (context before an interleaved block), no chain keys at all (K 1)
    cases += [("edge: COD n 512 K 8 in random order", 1, 12, 12, 128,
               [shuffled(mtp_layout(512, 8, 0.8, seed=5), seed=5)]),
              ("edge: segments n 1024 S 4, GQA 4/2", 2, 4, 2, 64,
               [mtp_segment_layout(1024, 8, 0.8, 4, seed=b)
                for b in range(2)]),
              ("edge: no chain keys, n 700 K 1", 1, 12, 12, 128,
               [mtp_layout(700, 1, 0.8, seed=6)])]
    worst, timed = {}, {}
    for dtype in ("bfloat16", "float32"):
        for label, B, H, KV, hd, layouts in cases:
            inp = mtp_case(dev, dtype, B, H, KV, hd, layouts, seed=2)
            o, m, l = ops.mtp_attention(*inp, scale=hd ** -0.5,
                                        return_stats=True)
            torch.cuda.synchronize()
            po, pm, pl = ops.mtp_attention_plain(*inp, scale=hd ** -0.5,
                                                 return_stats=True)
            err = compare("mtp_attention", o, po, dtype, label)
            for stat, got, want in (("m", m, pm), ("l", l, pl)):
                rel = ((got - want).abs() / (1 + want.abs())).max().item()
                if not rel <= STATS_TOL:
                    fail(f"mtp_attention {label} {dtype}: {stat} relative "
                         f"err {rel}")
            if label in timed_labels:
                worst[(label, dtype)] = err
                timed[(label, dtype)] = inp
        # pad rows (depth -1) attend nothing and are written as zeros
        layout = mtp_layout(16, 3, 0.6, seed=0)
        inp = mtp_case(dev, dtype, 1, 2, 2, 32, [layout], seed=3)
        o, m, l = ops.mtp_attention(*inp, scale=1.0, return_stats=True)
        torch.cuda.synchronize()
        pad = torch.as_tensor(layout[1] < 0, device=dev)
        compare("mtp_attention", o, ops.mtp_attention_plain(*inp, scale=1.0),
                dtype, "padding rows n 16 K 3 r 0.6 in 64")
        if (o[:, pad].abs().max().item() != 0.0 or (l[..., pad] != 0).any()
                or (m[..., pad] != -1e30).any()):
            fail(f"mtp_attention {dtype}: pad rows are not zero (l 0, m "
                 f"-1e30)")
    log("  mtp_attention pad rows: out exactly 0, l 0, m -1e30 (bf16, f32)")

    log("phase 2: MTP timing (CUDA events; main path dtype float32)")
    measured = {}
    for (label, dtype), inp in timed.items():
        q, k, v, pos, dep = inp
        hd = q.shape[-1]
        nbytes, flops = mtp_work(q, k, pos, dep)
        sets = [inp] + [tuple(x.clone() for x in inp)
                        for _ in range(n_sets(nbytes) - 1)]
        ms = time_ms(lambda *a: ops.mtp_attention(
            *a, scale=hd ** -0.5, return_stats=True), sets, 5, host_us=2000)
        plain_ms = time_ms(lambda *a: ops.mtp_attention_plain(
            *a, scale=hd ** -0.5, return_stats=True), sets[:1], 3,
            host_us=200000)
        lib = sdpa_mtp(*inp)
        lib_ms = time_ms(lambda: lib(), [()], 5, host_us=2000)
        del lib
        # of the kernel's time: the wrapper's index lists (one int32 sort)
        lists_ms = time_ms(ops.mtp_key_lists, [(pos, dep)], 20, host_us=500)
        dt_ms, dt_by = bound(nbytes, flops, dtype)
        # float32 runs as three TF32 products on the tensor cores, bfloat16
        # (exact in TF32) as one for S and two for P·V
        tc_flops = flops * (3 if dtype == "float32" else 1.5)
        tc_ms, tc_by = bound(nbytes, tc_flops, "tf32")
        # the least time the card could take: the smaller of the two
        bound_ms, bound_by = min((dt_ms, dt_by), (tc_ms, tc_by))
        measured[(label, dtype)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, bound_dtype_ms=dt_ms, bound_tc_ms=tc_ms,
            lists_ms=lists_ms, bytes=nbytes, flops=flops,
            max_abs_err=worst[(label, dtype)], M=q.shape[1])
        log(f"  mtp_attention {label:38s} {dtype:8s} {ms:8.3f} ms (index "
            f"lists {lists_ms:.3f} ms of it)  plain "
            f"{plain_ms:8.3f} ms  sdpa {lib_ms:8.3f} ms  bound {bound_ms:7.4f}"
            f" ms ({bound_by}; {nbytes / 1e6:.1f} MB, M {q.shape[1]}): "
            f"{dt_ms:7.4f} ms ({dt_by}; {flops / 1e9:.2f} GFLOP at the "
            f"{dtype} peak), {tc_ms:7.4f} ms ({tc_by}; {tc_flops / 1e9:.2f} "
            f"GFLOP of 3xTF32 products at the TF32 tensor-core peak)")
        torch.cuda.empty_cache()
    return measured


def check_mtp_backward(dev):
    """Gradients of the flash training attention (the kernel's forward and
    its saved m, l; the plain recompute-by-block backward) against autograd
    through the plain version, float32 at M 1998 (n 480, K 8, r 0.8), the
    drafter's 12/12 heads, hd 128."""
    from repro_torch.core.flash_train import mtp_flash_attention
    from repro_torch.kernels import ops
    layout = mtp_layout(480, 8, 0.8, seed=4, pad_to=1)
    q, k, v, pos, dep = mtp_case(dev, "float32", 1, 12, 12, 128, [layout],
                                 seed=5)
    g = torch.Generator(device=dev).manual_seed(6)
    cot = torch.randn(q.shape, generator=g, device=dev)
    before = ops.launches["mtp_attention"]
    grads = {}
    for name, fn in (("kernel", mtp_flash_attention),
                     ("plain", ops.mtp_attention_plain)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, pos, dep, scale=128 ** -0.5)
        grads[name] = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    if ops.launches["mtp_attention"] != before + 1:
        fail("the flash training attention did not launch the MTP kernel")
    for t, got, want in zip("qkv", grads["kernel"], grads["plain"]):
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        log(f"  d{t}: max abs err {err:.3e} (max |grad| {scale:.3e}, "
            f"{err / (GRAD_TOL * scale):.2f} of the limit)")
        if not err <= GRAD_TOL * scale:
            fail(f"flash training attention d{t} differs from autograd "
                 f"through the plain version by {err} > {GRAD_TOL} x {scale}")


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention(ops):
    """Route the model's attention through the plain versions (on the card)
    to make a reference run; the kernels' counters do not move."""
    saved = (ops.decode_attention, ops.paged_decode_attention,
             ops.flash_attention)
    ops.decode_attention = ops.decode_attention_plain
    ops.paged_decode_attention = ops.paged_decode_attention_plain
    ops.flash_attention = ops.flash_attention_plain
    try:
        yield
    finally:
        (ops.decode_attention, ops.paged_decode_attention,
         ops.flash_attention) = saved


def main_path(ops, dev):
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN = 8, 512, 128, 5, 1024
    log(f"phase 3: full-width qwen2-1.5b bfloat16, 4-layer parallel drafter, "
        f"batch {B}, prompt {P}, max_new {NEW}, K {K}, max_len {MAX_LEN}")
    t0 = time.perf_counter()
    eng = build_engine(mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    torch.cuda.synchronize()
    cfg = eng.tcfg
    log(f"  weights built in {time.perf_counter() - t0:.1f} s "
        f"(layers {cfg.n_layers}, d {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}, drafter d "
        f"{eng.dcfg.d_model} heads {eng.dcfg.n_heads}/{eng.dcfg.n_kv_heads} "
        f"d_ff {eng.dcfg.d_ff})")
    prompts = random_prompts(cfg.vocab_size, B, P, seed=0)
    eng.run(prompts, max_iters=8)                      # cold run, 8 steps
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    r = eng.run(prompts)
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = r["steps"]
    log(f"  warm run: otps {r['otps']:.1f} tok/s, prefill {r['prefill_s']:.4f}"
        f" s, decode {r['decode_s']:.4f} s over {steps} steps "
        f"({r['decode_s'] / steps * 1e3:.2f} ms/step), AL "
        f"{r['acceptance_length']:.4f}, new tokens {r['new_tokens']}, peak "
        f"memory {peak_gb:.2f} GB")
    log(f"  launches: {counts}")
    n_d = eng.dcfg.n_layers
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": 2 * n_d + steps * (2 * cfg.n_layers + 4 * n_d),
            "paged_decode_attention": 0, "mtp_attention": 0}
    if counts != want:
        fail(f"launch counts {counts} != expected {want}")
    state = r["state"]
    if not bool((state["new_count"] == NEW).all()):
        fail(f"new_count {state['new_count'].tolist()} != {NEW}")
    toks = torch.as_tensor(r["tokens"])
    gen = toks[:, P:P + NEW]
    if toks.shape != (B, MAX_LEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        fail("generated tokens out of range")
    lp = state["logprobs"][:, P:P + NEW]
    if not bool(torch.isfinite(lp).all()) or float(lp.max()) > 0:
        fail("logprobs are not finite log-probabilities")
    if not (1.0 <= r["acceptance_length"] <= K + 1):
        fail(f"acceptance length {r['acceptance_length']} out of [1, K+1]")

    result = dict(otps=r["otps"], prefill_s=r["prefill_s"],
                  decode_s=r["decode_s"], steps=steps,
                  decode_ms_per_step=r["decode_s"] / steps * 1e3,
                  acceptance_length=r["acceptance_length"],
                  peak_memory_gb=peak_gb, launches=counts)
    del eng, state, r
    torch.cuda.empty_cache()
    return result


def scheduler_path(ops, dev):
    """Phase 3b: continuous batching over the paged layout at full width."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.scheduler import Request, Scheduler
    B, MAX_LEN, PAGE, POOL, N, K = 8, 1024, 16, 256, 24, 5
    log(f"phase 3b: Scheduler.serve, full-width qwen2-1.5b bfloat16, "
        f"parallel K {K}, batch {B}, max_len {MAX_LEN}, paged: page {PAGE}, "
        f"pool {POOL} pages, incremental growth; {N} requests, prompts "
        f"256-640, budgets 64-192, Exp(1) arrival gaps, sync_every 1")
    eng = build_engine(mode="parallel", K=K, max_new=192, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev, kv_layout="paged",
                       page_size=PAGE, pool_pages=POOL)
    cfg, V = eng.tcfg, eng.tcfg.vocab_size
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 641, N)
    budgets = rng.integers(64, 193, N)
    arrivals = np.cumsum(rng.exponential(1.0, N))
    prompts = [rng.integers(0, V - 1, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(p, max_new_tokens=int(b), arrival_time=float(t))
                for p, b, t in zip(prompts, budgets, arrivals)]

    sched = Scheduler(eng, sync_every=1)
    # cold run: the first 8 requests with 8-token budgets, all at once
    sched.serve([Request(p, max_new_tokens=8) for p in prompts[:8]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng.allocator.reset_stats()
    ops.reset_launches()
    rep = sched.serve(requests())
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    it, pre = rep["iterations"], rep["preemptions"]
    admissions = N + pre
    log(f"  warm run: otps {rep['otps']:.1f} tok/s, wall {rep['wall_s']:.3f} s"
        f" ({rep['wall_s'] / it * 1e3:.2f} ms/iteration over {it}), otps_vt "
        f"{rep['otps_vt']:.4f}, p50/p99 latency_vt {rep['p50_latency_vt']:.2f}"
        f"/{rep['p99_latency_vt']:.2f}, p50/p99 wait_vt "
        f"{rep['p50_wait_vt']:.2f}/{rep['p99_wait_vt']:.2f}, makespan_vt "
        f"{rep['makespan_vt']:.2f}, AL {rep['weighted_acceptance_length']:.4f}"
        f", preemptions {pre}, peak pages {rep['peak_pages']}/{POOL}, new "
        f"tokens {rep['total_new_tokens']}, peak memory {peak_gb:.2f} GB")
    log(f"  launches: {counts}")
    n_d = eng.dcfg.n_layers
    want = sched_launches_want(cfg, n_d, it, admissions)
    if counts != want:
        fail(f"scheduler launch counts {counts} != expected {want} "
             f"({it} iterations, {admissions} admissions)")
    res = rep["results"]
    if len(res) != N or len({r["rid"] for r in res}) != N:
        fail(f"{len(res)} results for {N} requests")
    for r, b in zip(res, budgets):
        toks = r["tokens"]
        if r["n_new"] != b or len(toks) != b:
            fail(f"request {r['rid']} emitted {r['n_new']} tokens, budget {b}")
        if toks.min() < 0 or toks.max() >= V:
            fail(f"request {r['rid']} emitted tokens out of range")
        if not (np.isfinite(r["logprobs"]).all() and r["logprobs"].max() <= 0):
            fail(f"request {r['rid']} logprobs are not log-probabilities")
    if not pre > 0:
        fail("no request was preempted: the pool was meant to run out")
    if eng.allocator.n_used != 0:
        fail(f"{eng.allocator.n_used} pages still allocated after serve")
    result = {k: rep[k] for k in (
        "otps", "otps_vt", "wall_s", "iterations", "total_new_tokens",
        "weighted_acceptance_length", "makespan_vt", "p50_latency_vt",
        "p99_latency_vt", "p50_wait_vt", "p99_wait_vt", "preemptions",
        "peak_pages")}
    result.update(ms_per_iteration=rep["wall_s"] / it * 1e3,
                  admissions=admissions, peak_memory_gb=peak_gb,
                  launches=counts)
    del eng, sched, rep
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def oracle_drafts(table):
    """Replace the parallel drafter's K drafts at anchor c-1 with
    table[:, c+1 .. c+K]; the drafter still runs, so its cache is updated
    as usual."""
    from repro_torch.core import drafter as D
    saved = D.draft_parallel

    def draft(*args, **kw):
        _, logits, cache = saved(*args, **kw)
        anchor, k = args[6], args[7]
        idx = (anchor[:, None] + 2 + torch.arange(k, device=anchor.device)
               ).clamp(max=table.shape[1] - 1)
        return table.gather(1, idx.long()), logits, cache

    D.draft_parallel = draft
    try:
        yield
    finally:
        D.draft_parallel = saved


def kernel_logits_vs_plain(ops, eng, prompts, block, max_len):
    """Full-width float32 target logits through the kernels against the same
    forward with the plain attention: a prefill into a fresh cache (flash)
    and a verify block at the next positions read against it (decode, both
    phases)."""
    B, P = prompts.shape
    T = block.shape[1]
    positions = (P + torch.arange(T, dtype=torch.int32, device=block.device)
                 )[None].repeat(B, 1)
    logits = {}
    for name, ctx in (("kernels", contextlib.nullcontext()),
                      ("plain", plain_attention(ops))):
        with ctx, torch.no_grad():
            cache = eng.model.make_cache(B, max_len, dtype=torch.float32,
                                         device=block.device)
            pre = eng.model.forward(eng.tparams, prompts, mode="prefill",
                                    cache=cache, collect_taps=False)
            ver = eng.model.forward(eng.tparams, block, mode="decode",
                                    positions=positions, cache=pre.cache,
                                    collect_taps=False)
            logits[name] = (pre.logits, ver.logits)
            del cache, pre, ver
    for i, what in enumerate((f"prefill {tuple(prompts.shape)} (flash)",
                              f"verify {tuple(block.shape)} against the "
                              f"cache (decode)")):
        got, want = logits["kernels"][i], logits["plain"][i]
        err = (got - want).abs().max().item()
        log(f"  float32 logits, {what}, kernels vs plain attention: max abs "
            f"err {err:.3e} (max |logit| {want.abs().max().item():.3f})")
        if not err <= REF_TOL:
            fail(f"{what} logits through the kernels differ from the plain "
                 f"reference by {err} > {REF_TOL}")


def losslessness(ops, dev):
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN = 4, 128, 32, 5, 256
    log(f"phase 4: greedy losslessness, full width float32, batch {B}, "
        f"prompt {P}, max_new {NEW}, K {K}")
    toks, engines = {}, {}
    for mode in ("none", "parallel", "ar"):
        eng = build_engine(mode=mode, dtype="float32", K=K, max_new=NEW,
                           max_len=MAX_LEN, batch=B, seed=0, device=dev)
        prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=1)
        runs = [(mode, eng.run(prompts))]
        if mode == "parallel":
            # oracle drafts: the none run's tokens, a seeded fifth spoiled
            ref = none_full
            bad = np.random.default_rng(2).random(ref.shape) < 0.2
            table = np.where(bad, (ref + 1) % (eng.tcfg.vocab_size - 1), ref)
            with oracle_drafts(torch.as_tensor(table, dtype=torch.int32,
                                               device=dev)):
                runs.append(("oracle", eng.run(prompts)))
        for name, r in runs:
            toks[name] = r["tokens"][:, :P + NEW]
            log(f"  {name:8s} steps {r['steps']:3d} AL "
                f"{r['acceptance_length']:.3f} decode {r['decode_s']:.3f} s")
        if mode == "none":
            none_full = r["tokens"]
            engines["none"] = eng
        else:
            del eng
        if mode == "parallel" and not r["acceptance_length"] > ORACLE_MIN_AL:
            fail(f"oracle drafts reached AL {r['acceptance_length']}, not "
                 f"above {ORACLE_MIN_AL}: the accept path did not run")
    # paged Scheduler.serve under pool pressure: 30 pages of 16 hold three
    # of the four requests' prompts, and their growth preempts
    from repro_torch.serving.scheduler import Request, Scheduler
    eng = build_engine(mode="parallel", dtype="float32", K=K, max_new=NEW,
                       max_len=MAX_LEN, batch=B, seed=0, device=dev,
                       kv_layout="paged", page_size=16, pool_pages=30)
    rep = Scheduler(eng).serve([Request(p, max_new_tokens=NEW)
                                for p in prompts])
    toks["paged"] = np.concatenate(
        [prompts, np.stack([r["tokens"] for r in rep["results"]])], 1)
    log(f"  paged    iterations {rep['iterations']:3d} preemptions "
        f"{rep['preemptions']} peak pages {rep['peak_pages']}/30")
    if not (rep["preemptions"] > 0 and eng.allocator.n_used == 0):
        fail(f"paged serve: {rep['preemptions']} preemptions, "
             f"{eng.allocator.n_used} pages left allocated")
    del eng
    ref_eng = engines["none"]
    kernel_logits_vs_plain(
        ops, ref_eng, torch.as_tensor(prompts, device=dev),
        torch.as_tensor(toks["none"][:, P:P + K + 1], device=dev), MAX_LEN)
    for mode in ("parallel", "ar", "oracle", "paged"):
        diff = (toks[mode] != toks["none"])
        if not diff.any():
            log(f"  {mode}: all {B * NEW} generated tokens equal to none")
            continue
        for b in range(B):
            where = diff[b].nonzero()[0]
            if not len(where):
                continue
            pos = int(where[0])
            ctx = torch.as_tensor(toks["none"][b:b + 1, :pos], device=dev)
            with torch.no_grad():
                logits = ref_eng.model.forward(ref_eng.tparams, ctx,
                                               head_last_only=True).logits[0, -1]
            top2 = logits.topk(2).values
            gap = float(top2[0] - top2[1])
            log(f"  {mode}: row {b} first differs at position {pos}; none's "
                f"top-2 logit gap there {gap:.3e}")
            if gap >= NEAR_TIE:
                fail(f"{mode} row {b} differs from none at {pos} with top-2 "
                     f"gap {gap} >= {NEAR_TIE}")
    del engines, ref_eng
    torch.cuda.empty_cache()
    return {"prompts": prompts, "none": toks["none"]}


# ---------------------------------------------------------------------------
# phase 3c / 4b: sampled serving
# ---------------------------------------------------------------------------

# threefry words from JAX 0.9.0 (jax_threefry_partitionable=True), the
# reference the port's PRNG is bitwise equal to on the CPU
PRNG_KNOWN = {
    "fold_in(PRNGKey(7), 3)": [276534068, 1641862660],
    "split(PRNGKey(7), 3)": [[3625411723, 1954958720],
                             [195045567, 4062205631],
                             [966301609, 1948237315]],
    "bits(PRNGKey(1234), (4,))": [3715183467, 3461522409, 1578076316,
                                  3641478021],
    "uniform(PRNGKey(1234), (4,)) bits": [1063088434, 1062097570, 1052516112,
                                          1062800522],
    "categorical(PRNGKey(1234), log [.1 .2 .3 .4])": 3,
    "step_keys(seed 1234, [517, 518])": [[4162650630, 3893356881],
                                         [3651137254, 884596093]],
    "draft_keys(seed 1234, 517, K 3)": [[1546567615, 1943629236],
                                        [3829688118, 1817850175],
                                        [1043616496, 743150992]],
}
# the sampled phase's policy; a sampled decision's margin below this may
# part two runs (the near-tie rule of the CPU parity tests)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLED_NEAR_TIE = 1e-4


def prng_answers(dev):
    from repro_torch import prng
    from repro_torch.serving import sampling as S
    k7, k1234 = prng.PRNGKey(7, device=dev), prng.PRNGKey(1234, device=dev)
    samp = S.batch_sampling_state(S.SamplingParams(seed=1234), 2, device=dev)
    return {
        "fold_in(PRNGKey(7), 3)": prng.fold_in(k7, 3).tolist(),
        "split(PRNGKey(7), 3)": prng.split(k7, 3).tolist(),
        "bits(PRNGKey(1234), (4,))": prng.bits(k1234, (4,)).tolist(),
        "uniform(PRNGKey(1234), (4,)) bits":
            prng.uniform(k1234, (4,)).view(torch.int32).tolist(),
        "categorical(PRNGKey(1234), log [.1 .2 .3 .4])": prng.categorical(
            k1234, torch.log(torch.tensor([.1, .2, .3, .4], device=dev))
        ).item(),
        "step_keys(seed 1234, [517, 518])": S.step_keys(
            samp, torch.tensor([517, 518], device=dev)).tolist(),
        "draft_keys(seed 1234, 517, K 3)": S.draft_keys(samp, 517, 3)[0]
        .tolist(),
    }


def check_prng(dev):
    from repro_torch import prng
    for where in (torch.device("cpu"), dev):
        got = prng_answers(where)
        for name, want in PRNG_KNOWN.items():
            if got[name] != want:
                fail(f"prng on {where}: {name} = {got[name]}, want {want}")
    n = 1 << 20
    keys = prng.split(prng.PRNGKey(5), 3)
    for i, k in enumerate(keys):
        cpu = prng.uniform(k, (n,)).view(torch.int32)
        card = prng.uniform(k.to(dev), (n,)).view(torch.int32).cpu()
        if not torch.equal(cpu, card):
            fail(f"prng: 2^20 uniforms of key {i} differ between the card "
                 f"and the CPU at {int((cpu != card).sum())} places")
    log(f"  prng: known answers equal on the CPU and the card; 3 x 2^20 "
        f"uniforms bitwise equal between them")


def first_token_chi2(dev, sampled_drafts, N=1 << 14):
    """(statistic, threshold, draws outside the support) of the first
    committed token of rejection_verify_rows over N seeded rows against
    the warped target (the CPU test's check, on the card)."""
    from scipy.stats import chi2
    from repro_torch import prng
    from repro_torch.core import spec_decode as SD
    V, K = 8, 3
    g = np.random.default_rng(0)
    logits = torch.from_numpy((1.5 * g.standard_normal((1, K + 1, V)))
                              .astype(np.float32)).to(dev)
    p = SD.warp_probs(logits, torch.tensor([0.8], device=dev),
                      torch.tensor([6], device=dev),
                      torch.tensor([1.0], device=dev))[0]
    q = torch.softmax(torch.from_numpy(g.standard_normal((K, V)).astype(
        np.float32)).to(dev), -1)
    keys = prng.split(prng.PRNGKey(0, device=dev), N)
    kd, kv = prng.split(keys, 2).unbind(1)
    if sampled_drafts:
        drafts = prng.categorical(prng.split(kd, K), torch.log(q)[None])
        dprobs = q.expand(N, K, V)
    else:
        drafts = q.argmax(-1).expand(N, K)
        dprobs = F.one_hot(drafts, V).float()
    _, committed = SD.rejection_verify_rows(
        kv, drafts.to(torch.int32), dprobs, p.expand(N, K + 1, V))
    obs = torch.bincount(committed[:, 0].long(), minlength=V).cpu().numpy()
    exp = p[0].cpu().numpy().astype(np.float64) * N
    live = exp > 0
    stat = float((((obs - exp) ** 2)[live] / exp[live]).sum())
    return stat, float(chi2.ppf(0.999, live.sum() - 1)), int(obs[~live].sum())


def sched_launches_want(cfg, n_d, iterations, admissions):
    return {"paged_decode_attention": iterations * (cfg.n_layers + 2 * n_d),
            "decode_attention": iterations * (cfg.n_layers + 2 * n_d)
            + admissions * 2 * n_d,
            "flash_attention": admissions * cfg.n_layers, "mtp_attention": 0}


def sampled_throughput(ops, dev, path, sched):
    """bfloat16 full width: Engine.run under the sampled policy with draft
    sampling off and on (phase 3's shapes), and a mixed Scheduler.serve
    (phase 3b's traffic, odd requests sampled); launch counts as greedy."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K, MAX_LEN = 8, 512, 128, 5, 1024
    sp = SamplingParams(seed=0, **SAMPLED)
    log(f"  Engine.run, {SAMPLED}, seed 0, phase 3's shapes")
    eng = build_engine(mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev, sampling=sp)
    cfg, n_d = eng.tcfg, eng.dcfg.n_layers
    prompts = random_prompts(cfg.vocab_size, B, P, seed=0)
    out = {}
    for ds in (False, True):
        e = Engine(cfg, eng.dcfg, eng.tparams, eng.dparams,
                   dataclasses.replace(eng.ecfg, draft_sampling=ds), B,
                   device=dev)
        e.run(prompts, max_iters=4)                    # warm-up
        ops.reset_launches()
        r = e.run(prompts)
        counts = dict(ops.launches)
        steps = r["steps"]
        want = {"flash_attention": cfg.n_layers,
                "decode_attention": 2 * n_d + steps * (2 * cfg.n_layers
                                                       + 4 * n_d),
                "paged_decode_attention": 0, "mtp_attention": 0}
        if counts != want:
            fail(f"sampled Engine.run (draft_sampling {ds}): launch counts "
                 f"{counts} != the greedy path's {want}")
        if not bool((r["state"]["new_count"] == NEW).all()):
            fail(f"sampled run: new_count {r['state']['new_count'].tolist()}")
        gen = r["tokens"][:, P:P + NEW]
        if gen.min() < 0 or gen.max() >= cfg.vocab_size:
            fail("sampled run: tokens out of range")
        row = dict(otps=r["otps"], decode_ms_per_step=r["decode_s"] / steps
                   * 1e3, steps=steps, acceptance_length=r["acceptance_length"],
                   prefill_s=r["prefill_s"], launches=counts)
        out[f"engine_run_draft_sampling_{'on' if ds else 'off'}"] = row
        log(f"    draft_sampling {'on ' if ds else 'off'}: otps "
            f"{row['otps']:.1f} tok/s, {row['decode_ms_per_step']:.2f} ms/step"
            f" over {steps}, AL {row['acceptance_length']:.4f} (greedy, "
            f"phase 3: {path['otps']:.1f} tok/s, "
            f"{path['decode_ms_per_step']:.2f} ms/step, AL "
            f"{path['acceptance_length']:.4f}); launches as greedy")
        del e, r
    del eng
    torch.cuda.empty_cache()

    POOL, N = 256, 24
    log(f"  Scheduler.serve, paged, pool {POOL}, phase 3b's {N} requests, "
        f"even greedy, odd sampled ({SAMPLED}, seed = index)")
    eng = build_engine(mode="parallel", K=K, max_new=192, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev, kv_layout="paged",
                       page_size=16, pool_pages=POOL)
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 641, N)
    budgets = rng.integers(64, 193, N)
    arrivals = np.cumsum(rng.exponential(1.0, N))
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32)
               for n in lens]
    reqs = [Request(p, max_new_tokens=int(b), arrival_time=float(t),
                    sampling=None if i % 2 == 0
                    else SamplingParams(seed=i, **SAMPLED))
            for i, (p, b, t) in enumerate(zip(prompts, budgets, arrivals))]
    torch.cuda.synchronize()
    ops.reset_launches()
    rep = Scheduler(eng, sync_every=1).serve(reqs)
    counts = dict(ops.launches)
    it, pre = rep["iterations"], rep["preemptions"]
    want = sched_launches_want(cfg, n_d, it, N + pre)
    if counts != want:
        fail(f"sampled scheduler launch counts {counts} != the greedy "
             f"path's {want} ({it} iterations, {N + pre} admissions)")
    for r, b in zip(rep["results"], budgets):
        if r["n_new"] != b:
            fail(f"sampled serve: request {r['rid']} emitted {r['n_new']}, "
                 f"budget {b}")
    if eng.allocator.n_used:
        fail(f"{eng.allocator.n_used} pages allocated after the sampled serve")
    row = {k: rep[k] for k in ("otps", "otps_vt", "wall_s", "iterations",
                               "total_new_tokens", "preemptions",
                               "weighted_acceptance_length", "peak_pages",
                               "p50_latency_vt", "p99_latency_vt")}
    row.update(ms_per_iteration=rep["wall_s"] / it * 1e3, launches=counts,
               sampled_preempted=sum(r["n_preempt"] for r in rep["results"]
                                     if r["rid"] % 2))
    out["scheduler_mixed"] = row
    log(f"    otps {rep['otps']:.1f} tok/s, {row['ms_per_iteration']:.2f} "
        f"ms/iteration over {it}, AL {rep['weighted_acceptance_length']:.4f}"
        f", preemptions {pre} (greedy, phase 3b: {sched['otps']:.1f} tok/s, "
        f"{sched['ms_per_iteration']:.2f} ms/iteration over "
        f"{sched['iterations']}, preemptions {sched['preemptions']}); "
        f"launches as greedy")
    del eng, rep
    torch.cuda.empty_cache()
    return out


def greedy_gap(eng, context):
    with torch.no_grad():
        ids = torch.as_tensor(np.asarray(context, np.int32)[None],
                              device=eng.device)
        logits = eng.model.forward(eng.tparams, ids,
                                   head_last_only=True).logits[0, -1]
    top2 = logits.topk(2).values
    return float(top2[0] - top2[1])


def streams_agree(what, eng, log_, req, got, want):
    """Fail unless ``got`` equals ``want`` up to where they part after a
    decision of margin below the near-tie limit (then compare no further);
    returns the position they part at, or None."""
    n = min(len(got), len(want))
    diff = np.flatnonzero(np.asarray(got[:n]) != np.asarray(want[:n]))
    if not len(diff) and len(got) == len(want):
        return None
    j = int(diff[0]) if len(diff) else n
    P = req.prompt.size
    if req.sampling is None or req.sampling.is_greedy:
        margin = greedy_gap(eng, np.concatenate([req.prompt, want[:j]]))
        limit = NEAR_TIE
    else:
        margin = log_.min_margin(req.sampling.seed, P, P + j)
        limit = SAMPLED_NEAR_TIE
    log(f"    {what}: request {req.rid} parts at token {j}, margin "
        f"{margin:.3e}")
    if not margin < limit:
        fail(f"{what}: request {req.rid} differs at token {j} with margin "
             f"{margin} >= {limit}")
    return P + j


def sampled_correctness(dev, greedy_ref):
    """float32 full width: seeded reproducibility, a sampled stream the
    same alone, in a mixed batch, contiguous and paged, preempted or not;
    greedy rows equal to phase 4's greedy run."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.margins import MarginLog
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K, MAX_LEN = 4, 128, 32, 5, 256
    prompts, none = greedy_ref["prompts"], greedy_ref["none"]
    log(f"  float32 full width, batch {B}, prompt {P}, max_new {NEW}, K {K}")
    eng = build_engine(mode="parallel", dtype="float32", K=K, max_new=NEW,
                       max_len=MAX_LEN, batch=B, seed=0, device=dev,
                       sampling=SamplingParams(seed=3, **SAMPLED))
    a, b = eng.run(prompts)["tokens"], eng.run(prompts)["tokens"]
    if not np.array_equal(a, b):
        fail("two sampled runs with the same seeds differ")
    log("    two seeded Engine.run calls: identical tokens")

    # even requests sampled, odd ones greedy: all arrive at once, and the
    # pool's growth preempts the lowest-priority runner, request 2
    def requests():
        return [Request(p, max_new_tokens=NEW,
                        sampling=SamplingParams.greedy() if i % 2
                        else SamplingParams(seed=10 + i, **SAMPLED))
                for i, p in enumerate(prompts)]

    paged = build_engine(mode="parallel", dtype="float32", K=K, max_new=NEW,
                         max_len=MAX_LEN, batch=B, seed=0, device=dev,
                         kv_layout="paged", page_size=16, pool_pages=30)
    runs, parted = {}, 0
    with MarginLog() as margins:
        for i in (0, 2):                           # each sampled one alone
            r = requests()[i]
            runs[f"alone {i}"] = Scheduler(eng).serve([r])["results"][0]
        for name, e in (("contiguous", eng), ("paged", paged)):
            reqs = requests()
            runs[name] = Scheduler(e).serve(reqs)
        pre = [r["n_preempt"] for r in runs["paged"]["results"]]
    if not any(pre[i] for i in (0, 2)):
        fail(f"paged mixed serve preempted no sampled request ({pre})")
    if paged.allocator.n_used:
        fail("pages left allocated after the paged mixed serve")
    reqs = requests()
    for name in ("contiguous", "paged"):
        for i, req in enumerate(reqs):
            got = runs[name]["results"][i]["tokens"]
            if i % 2:
                want = none[i, P:P + NEW]
            else:
                want = runs[f"alone {i}"]["tokens"]
            parted += streams_agree(f"{name} mixed vs "
                                    f"{'greedy' if i % 2 else 'alone'}",
                                    eng, margins, req, got, want) is not None
    log(f"    sampled requests alone == in the mixed batch (contiguous, "
        f"paged with preemptions {pre}); greedy rows == phase 4's greedy "
        f"run; {parted} streams parted at a near-tie")
    out = {"reproducible": True, "paged_preemptions": pre,
           "parted_at_near_tie": parted, "chi2": {}}
    del eng, paged
    torch.cuda.empty_cache()
    for sampled_drafts in (False, True):
        stat, limit, outside = first_token_chi2(dev, sampled_drafts)
        name = "sampled drafts" if sampled_drafts else "one-hot drafts"
        log(f"    rejection_verify_rows on the card, {name}: chi-square "
            f"{stat:.2f} < {limit:.2f} over 2^14 rows, {outside} outside "
            f"the support")
        if outside or not stat < limit:
            fail(f"chi-square of {name}: {stat} (limit {limit}), {outside} "
                 f"draws outside the support")
        out["chi2"][name] = stat
    return out


def sampled_path(ops, dev, path, sched, greedy_ref):
    log("phase 3c / 4b: sampled serving")
    check_prng(dev)
    out = sampled_throughput(ops, dev, path, sched)
    out["correctness"] = sampled_correctness(dev, greedy_ref)
    return out


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

class StageTimer:
    """CUDA events around a Trainer's four stage methods (taps, loss, grads,
    apply), set on the instance so train_batch runs through them; removed
    on exit, so the trainer holds no reference to itself afterwards."""
    STAGES = ("taps", "loss", "grads", "apply")

    def __init__(self, tr):
        self.tr = tr
        self.events = []

    def __enter__(self):
        for name in self.STAGES:
            setattr(self.tr, name, self._wrap(name, getattr(self.tr, name)))
        return self

    def __exit__(self, *exc):
        for name in self.STAGES:
            delattr(self.tr, name)

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.events.append((name, start, end))
            return out
        return timed

    def split_ms(self):
        """Device-clock ms per stage, summed over the recorded calls."""
        torch.cuda.synchronize()
        out = dict.fromkeys(self.STAGES, 0.0)
        for name, a, b in self.events:
            out[name] += a.elapsed_time(b)
        self.events.clear()
        return out


def train_steps(ops, dev, tr, batches, label):
    """Run train_batch over ``batches`` with launch counts from 0 and a
    stage split per step; returns the path's numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    steps = []
    with StageTimer(tr) as timer:
        for batch in batches:
            segs = batch if isinstance(batch, list) else [batch]
            t0 = time.perf_counter()
            m = tr.train_batch(batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            split = timer.split_ms()
            steps.append(dict(s=sec, loss=m["loss"], grad_norm=m["grad_norm"],
                              labels=sum(int((sg.labels >= 0).sum())
                                         for sg in segs),
                              segments=len(segs), split_ms=split))
            log(f"  {label} step {len(steps)}: {sec:.3f} s, loss "
                f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, stages "
                "(ms) " + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_forward = sum(st["segments"] for st in steps)
    want = {"mtp_attention": tr.dcfg.n_layers * n_forward
            * (2 if tr.dcfg.remat else 1),
            "flash_attention": tr.tcfg.n_layers * len(steps),
            "decode_attention": 0, "paged_decode_attention": 0}
    log(f"  {label} launches: {counts}")
    if counts != want:
        fail(f"{label}: launch counts {counts} != expected {want}")
    for st in steps:
        if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
            fail(f"{label}: loss {st['loss']} / grad_norm {st['grad_norm']}")
    warm = steps[1:]                     # step 1 warms up cuBLAS and caches
    sec = sum(st["s"] for st in warm) / len(warm)
    result = dict(
        s_per_step=sec, s_first_step=steps[0]["s"],
        label_tokens_per_s=sum(st["labels"] for st in warm)
        / sum(st["s"] for st in warm),
        labels_per_step=warm[-1]["labels"], peak_memory_gb=peak_gb,
        stage_ms={k: sum(st["split_ms"][k] for st in warm) / len(warm)
                  for k in StageTimer.STAGES},
        losses=[st["loss"] for st in steps], launches=counts)
    log(f"  {label}: {sec:.3f} s/step, {result['label_tokens_per_s']:.1f} "
        f"label tokens/s, peak memory {peak_gb:.2f} GB")
    return result


def training_path(ops, dev):
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.data import MTPPipeline, markov_corpus
    from repro_torch.launch import train as train_launch
    from repro_torch.models.registry import get_model
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.tree import leaves_with_paths

    tcfg = get_config("qwen2-1.5b")
    dcfg = DrafterConfig().resolve(tcfg)
    log(f"phase 5: training, full-width qwen2-1.5b {tcfg.dtype} target, "
        f"{dcfg.n_layers}-layer drafter float32 (d {dcfg.d_model}, heads "
        f"{dcfg.n_heads}/{dcfg.n_kv_heads}, K {dcfg.k_train}, r "
        f"{dcfg.cod_rate}), markov_corpus, batch 1")
    gen = torch.Generator(device=dev).manual_seed(0)
    tparams = get_model(tcfg).init(gen, device=dev)
    V = tcfg.vocab_size

    def pipe(n, segments=1, seed=0, n_seqs=3):
        return MTPPipeline(markov_corpus(seed, n_seqs, n, V), k_train=8,
                           cod_rate=0.8, batch=1, seed=seed,
                           segments=segments)

    def trainer(**kw):
        return Trainer(tcfg, dcfg, tparams, TrainConfig(**kw), seed=0,
                       device=dev)

    paths = {}
    for label, n, S in (("(a) whole n 2048", 2048, 1),
                        ("(b) segmented n 4096 S 4", 4096, 4)):
        tr = trainer()
        paths[label] = train_steps(ops, dev, tr, list(pipe(n, S)), label)
        paths[label].update(n=n, segments=S)
        del tr
        torch.cuda.empty_cache()

    log("  segmented vs whole-sequence grads at n 1024, float32")
    tr = trainer()
    whole = next(iter(pipe(1024, 1, seed=1, n_seqs=1)))
    segs = next(iter(pipe(1024, 4, seed=1, n_seqs=1)))
    gw, _ = tr.batch_grads(whole)
    gs, _ = tr.batch_grads(segs)
    worst = 0.0
    for (path, a), (_, b) in zip(leaves_with_paths(gs),
                                 leaves_with_paths(gw)):
        scale = b.abs().max().item()
        share = (a - b).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, share)
        if not share <= SEG_GRAD_TOL:
            fail(f"segmented grads differ from whole at {path}: "
                 f"{share:.3e} of max |grad| {scale:.3e}")
    log(f"  worst leaf: {worst:.3e} of its max |grad| (limit {SEG_GRAD_TOL})")
    del gw, gs

    batch = next(iter(pipe(1024, 1, seed=2, n_seqs=1)))
    losses = [tr.train_batch(batch)["loss"] for _ in range(4)]
    log(f"  loss on one repeated batch, 4 steps: "
        + ", ".join(f"{x:.4f}" for x in losses))
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on a repeated batch: {losses}")

    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(tr.dparams, tmp, "drafter", step=4)
        back = load_pytree(tr.dparams, tmp, "drafter")
        for (path, a), (_, b) in zip(leaves_with_paths(tr.dparams),
                                     leaves_with_paths(back)):
            if not torch.equal(a, b):
                fail(f"checkpoint round trip changed {path}")
    log("  checkpoint round trip: every leaf equal")
    # the launcher builds its own target: free this one first, so its peak
    # memory is its own
    del tr, back, tparams
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        rep = train_launch.main(["--data", "markov", "--seq-len", "512",
                                 "--batch", "1", "--n-seqs", "2",
                                 "--epochs", "1", "--ckpt", tmp])
    if not (rep["steps"] == 2 and math.isfinite(rep["loss"])):
        fail(f"the training launcher reported {rep}")
    return dict(paths=paths, seg_grad_worst=worst, repeated_losses=losses,
                launcher=rep)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(card)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = build.build()
    log(f"phase 1: built {sorted(built) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in build.ptxas_reports.items():
        keep = [ln.strip() for ln in report.splitlines()
                if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        log(f"  -Xptxas -v {name}:\n    " + "\n    ".join(keep))

    kernels = run_phases(ops, dev)
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(ops, dev) -> list:
    """Phases 2-5 on ``dev``; returns the kernels' JSON rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, measured = check_kernels(ops, dev)
    path = main_path(ops, dev)
    sched = scheduler_path(ops, dev)
    greedy_ref = losslessness(ops, dev)
    sampled = sampled_path(ops, dev, path, sched, greedy_ref)
    train = training_path(ops, dev)

    csrc = "src/repro_torch/kernels/csrc"
    sources = {name: f"{csrc}/{name}.cu" for name in (
        "decode_attention", "paged_decode_attention", "flash_attention")}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:73",
                "paged_decode_attention":
                    "src/repro/kernels/decode_attention.py:165",
                "flash_attention": "src/repro/kernels/flash_attention.py:79"}
    main_shape = {"decode_attention": "target verify phase 1",
                  "paged_decode_attention": "target verify phase 1",
                  "flash_attention": "target prefill"}
    # launches: the paged kernel's from the scheduler phase, the others'
    # from the whole-batch serving phase
    launches = dict(path["launches"],
                    paged_decode_attention=sched["launches"][
                        "paged_decode_attention"])
    kernels = []
    for name in ("decode_attention", "paged_decode_attention",
                 "flash_attention"):
        m = measured[(name, main_shape[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": main_shape[name]})
    # the MTP kernel: timed at the training shape in float32, the dtype the
    # training path gives it; launches over both training paths of phase 5
    mtp_shape = ("training shape n 2048 K 8 r 0.8", "float32")
    m = measured["mtp_attention"][mtp_shape]
    kernels.append({
        "name": "mtp_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mtp_attention.cu",
        "replaces": "src/repro/kernels/mtp_attention.py:77",
        "launches": sum(p["launches"]["mtp_attention"]
                        for p in train["paths"].values()),
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "shape": f"{mtp_shape[0]}, {mtp_shape[1]} (M {m['M']})"})
    log(f"serving: {json.dumps({k: v for k, v in path.items()})}")
    log(f"scheduler serving: {json.dumps(sched)}")
    log(f"sampled serving: {json.dumps(sampled)}")
    log("paged_decode_attention timing: " + json.dumps(
        {key[1]: v for key, v in measured.items()
         if key[0] == "paged_decode_attention"}))
    log(f"training: {json.dumps(train)}")
    log("mtp_attention timing: " + json.dumps(
        {f"{k[0]} {k[1]}": v for k, v in measured["mtp_attention"].items()}))
    return kernels


if __name__ == "__main__":
    sys.exit(main())

"""Card-only tests of the port: each CUDA kernel against its plain version
on the card, the engine's greedy losslessness through the kernels, paged
scheduler serving through the paged decode kernel, greedy and sampled,
the prefix cache, swap to pinned host memory and adaptive K (the decode
kernel at a hit's chunk shapes, the paged kernel over shared pages, a
bitwise swap round trip), the streaming front end (streamed equals its
virtual twin, an abort frees pages and pinned bytes) and the round-based
baseline's flash launches, the threefry PRNG's words on the card against
the CPU's, the chi-square
losslessness of rejection verification on the card, the verify forward
replayed from CUDA graphs in pieces bitwise equal to eager (dense, MoE and
recurrent targets, both layouts, both drafters, greedy and mixed; the
paged calls still seen by a wrapper on ``ops``),
gemma2's softcap in the decode and paged kernels at its shapes (a
wrapped ring too) and flash with softcap and window past 4096, reduced
gemma2's rings through the kernels, the flash training
attention's gradients, and reduced training steps through the MTP kernel;
on a machine with 2 or 4 cards, storage-sharded serving, the sharded
train step and ``AsyncEngine`` with rank 0 deciding over ``nccl``, one
card a rank, and on 4 cards llama4-maverick at full width on 4 of its
layers drawn leaf by leaf into its slices (skipped where the card count
does not reach the world size).

Marked ``gpu``; each test decides inside the ``card`` fixture whether a
card exists and skips without one. The card's machine has no JAX, which
``tests/conftest.py`` imports, so run them there without the conftest:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Inputs: q ~ 2 N(0, 1), k, v ~ N(0, 1), so scores have a std of 2 and
attention is peaked, as in a trained model. Tolerances, elementwise
|kernel - plain| <= atol + rtol |plain|: in bfloat16 atol 1e-4, rtol 2^-6
(both compute in float32 and round the output once, so they differ by at
most one rounding step of the output; two are allowed); in float32 atol
1e-4 (sums in another order)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(g, q_shape, kv_shape, dtype, device):
    return tuple((scale * torch.randn(s, generator=g, device=device)).to(dtype)
                 for scale, s in ((2.0, q_shape), (1.0, kv_shape),
                                  (1.0, kv_shape)))


def _tol(dtype):
    """(atol, rtol) of the kernel against its plain version."""
    return (1e-4, 2 ** -6) if dtype == torch.bfloat16 else (1e-4, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,hd,S,valid,window", [
    (8, 6, 12, 2, 128, 1024, 600, 0),      # target verify, phase 1
    (8, 5, 12, 12, 128, 1024, 600, 0),     # drafter draft, phase 1
    (8, 511, 12, 12, 128, 511, 511, 0),    # drafter prefill extend, phase 2
    (8, 511, 12, 12, 128, 1024, 0, 0),     # ... phase 1: empty cache
    (2, 6, 4, 2, 64, 256, 192, 64),        # window
    (1, 8, 2, 1, 128, 96, 72, 0),          # ragged key tail
    (1, 1, 4, 4, 32, 512, 384, 0),
    (8, 6, 12, 2, 128, 1000, 600, 0),      # S not a multiple of the chunk
    (8, 6, 12, 2, 128, 1024, 0, 0),        # every key empty: zeros, l 0
    (8, 6, 12, 2, 128, 1024, 600, 100),    # window across chunk edges
    (8, 6, 12, 12, 128, 1024, 600, 0),     # drafter extend, phase 1
    # batch-1 admission extend: several row tiles, each split 4 ways
    (1, 511, 12, 12, 128, 1024, 0, 0),     # phase 1: empty cache
    (1, 511, 12, 12, 128, 511, 511, 0),    # phase 2, bucket 512
    (1, 255, 12, 12, 128, 255, 255, 0),    # phase 2, bucket 256
    (1, 638, 12, 12, 128, 638, 638, 0),    # phase 2, exact length
    (1, 200, 12, 2, 128, 1024, 600, 0),    # row tiles x splits, live keys
    (1, 200, 12, 2, 128, 1024, 600, 150),  # ... and a window
    # a prefix-cache hit's suffix chunks against the cached system prompt
    (1, 256, 12, 2, 128, 1024, 320, 0),    # target hit chunk, phase 1
    (1, 256, 12, 2, 128, 256, 256, 0),     # ... phase 2
    (1, 255, 12, 12, 128, 1024, 320, 0),   # drafter hit extend, phase 1
    (1, 512, 12, 2, 128, 1024, 64, 0),     # the widest chunk, phase 1
    # head dim 256 (gemma-7b: MHA 16/16): 16 rows a block, four warps
    # splitting O's columns
    (8, 6, 16, 16, 256, 1024, 576, 0),     # target verify, phase 1
    (8, 6, 16, 16, 256, 6, 6, 0),          # ... phase 2
    (8, 6, 8, 2, 256, 1024, 600, 100),     # GQA, window across chunks
    (2, 40, 4, 2, 256, 1000, 600, 0),      # several row tiles, ragged S
    (2, 40, 4, 2, 256, 1024, 0, 0),        # every key empty: zeros, l 0
    (1, 128, 16, 16, 256, 1024, 512, 0),   # an admission chunk, phase 1
    # recurrentgemma-2b: MQA, 10 query heads on 1 KV head of 256 (60 rows a
    # KV head at the verify: four 16-row tiles re-read one KV head)
    (8, 6, 10, 1, 256, 1024, 576, 0),      # target verify, phase 1
    (8, 6, 10, 1, 256, 6, 6, 0),           # ... phase 2
    (1, 128, 10, 1, 256, 1024, 512, 0),    # an admission chunk, phase 1
    # dbrx-132b: GQA 48/8 (6 query heads a KV head), its drafter 48/48
    (8, 6, 48, 8, 128, 1024, 600, 0),      # target verify, phase 1
    (8, 6, 48, 8, 128, 6, 6, 0),           # ... phase 2
    (8, 5, 48, 48, 128, 1024, 600, 0),     # drafter draft, phase 1
    # llama4-maverick: GQA 40/8 (a ratio of 5), local window 8192, its
    # drafter 40/40
    (8, 6, 40, 8, 128, 1024, 600, 0),      # target verify, phase 1
    (2, 6, 40, 8, 128, 9000, 8800, 8192),  # a local layer past its window
    (8, 5, 40, 40, 128, 1024, 600, 0),     # drafter draft, phase 1
    # internvl2-1b: GQA 14/2 at head dim 64, its rows 256 vision positions
    # in; its drafter 7/7 of 128
    (8, 6, 14, 2, 64, 1024, 832, 0),       # target verify, phase 1
    (8, 6, 14, 2, 64, 6, 6, 0),            # ... phase 2
    (8, 5, 7, 7, 128, 1024, 831, 0),       # drafter draft, phase 1
    # whisper-base's decoder: MHA 8/8 at head dim 64 over 448 slots; its
    # drafter 4/4 of 128
    (8, 6, 8, 8, 64, 448, 320, 0),         # self-attention verify, phase 1
    (8, 5, 4, 4, 128, 448, 319, 0),        # drafter draft, phase 1
])
def test_decode_kernel_matches_plain(card, dtype, B, T, H, KV, hd, S, valid,
                                     window):
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = _qkv(g, (B, T, H, hd), (B, S, KV, hd), dtype, card)
    kpos = torch.arange(S, dtype=torch.int32, device=card)[None].repeat(B, 1)
    kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32).contiguous()
    qpos = (max(valid, T) - T + torch.arange(T, dtype=torch.int32,
                                             device=card))[None].repeat(B, 1)
    before = ops.launches["decode_attention"]
    out, m, l = ops.decode_attention(q, k, v, kpos, qpos, scale=hd ** -0.5,
                                     window=window, return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["decode_attention"] == before + 1
    po, pm, pl = ops.decode_attention_plain(q, k, v, kpos, qpos,
                                            scale=hd ** -0.5, window=window,
                                            return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)
    dead = (l == 0).permute(0, 3, 1, 2).reshape(B, T, H)   # rows seeing no key
    if dead.any():
        assert out[dead].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,qpos0", [(8, 6, 192), (1, 128, 0), (2, 1, 447)])
def test_decode_kernel_keys_at_position_zero(card, dtype, B, T, qpos0):
    """whisper's decode-mode cross-attention: every one of 1500 encoder keys
    at position 0 (8/8 heads of 64), so ``0 <= kp <= qp`` admits them all
    (a verify's 6 queries, an admission chunk's 128, one query at the
    decoder's last position): the kernel equals its plain version and the
    unmasked attention (``layers.full_attention``)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = _qkv(g, (B, T, 8, 64), (B, 1500, 8, 64), dtype, card)
    kpos = torch.zeros((B, 1500), dtype=torch.int32, device=card)
    qpos = (qpos0 + torch.arange(T, dtype=torch.int32, device=card))[
        None].repeat(B, 1).contiguous()
    out = ops.decode_attention(q, k, v, kpos, qpos, scale=0.125)
    torch.cuda.synchronize()
    atol, rtol = _tol(dtype)
    for want in (ops.decode_attention_plain(q, k, v, kpos, qpos, scale=0.125),
                 L.full_attention(q, k, v, scale=0.125)):
        torch.testing.assert_close(out.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("T,H,KV,valid", [
    (6, 12, 2, 576),       # target verify, phase 1
    (5, 12, 12, 575),      # drafter draft, phase 1
    (6, 12, 12, 576),      # drafter extend, phase 1
])
def test_decode_serving_shapes_split_and_count_once(card, T, H, KV, valid):
    """At the serving path's phase-1 shapes the bfloat16 kernel splits the
    1024 cache slots across blocks, and a call (pass 1 and its combine)
    still moves the launch counter by one."""
    B, hd, S = 8, 128, 1024
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    row_blocks = -(-(H // KV) * T // ops.DECODE_ROW_TILE) * B * KV
    splits, _ = ops.decode_split(S, row_blocks, n_sm)
    assert splits > 1
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = _qkv(g, (B, T, H, hd), (B, S, KV, hd), torch.bfloat16, card)
    kpos = torch.arange(S, dtype=torch.int32, device=card)[None].repeat(B, 1)
    kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32).contiguous()
    qpos = (valid + torch.arange(T, dtype=torch.int32, device=card))[
        None].repeat(B, 1)
    before = ops.launches["decode_attention"]
    out = ops.decode_attention(q, k, v, kpos, qpos, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert ops.launches["decode_attention"] == before + 1
    want = ops.decode_attention_plain(q, k, v, kpos, qpos, scale=hd ** -0.5)
    torch.testing.assert_close(out.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,cap,kv_len", [
    (8, 512, 512, 12, 2, 128, True, 0, 0.0, 0),    # target prefill
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, 0),
    (1, 256, 256, 4, 4, 32, True, 64, 0.0, 0),
    (1, 64, 192, 2, 1, 128, False, 0, 0.0, 0),
    (2, 96, 96, 6, 2, 64, True, 0, 50.0, 0),
    (8, 500, 500, 12, 2, 128, True, 0, 0.0, 0),    # ragged query and key tiles
    (1, 1, 1, 12, 2, 128, True, 0, 0.0, 0),
    (1, 2048, 2048, 12, 2, 128, True, 0, 0.0, 0),  # training tap
    (2, 100, 300, 4, 2, 64, True, 0, 0.0, 0),      # Sq < Skv
    (2, 300, 100, 4, 2, 64, True, 0, 0.0, 0),      # Sq > Skv
    (2, 256, 256, 4, 2, 64, True, 0, 0.0, 200),    # kv_len < Skv
    (2, 200, 256, 4, 2, 128, False, 0, 0.0, 150),
    (2, 160, 160, 4, 2, 32, True, 64, 0.0, 0),     # window, each head dim
    (2, 160, 160, 4, 2, 64, True, 64, 0.0, 0),
    (2, 160, 160, 4, 2, 128, True, 64, 0.0, 0),
    (2, 160, 160, 4, 2, 32, True, 0, 50.0, 0),     # softcap, each head dim
    (2, 160, 160, 4, 2, 128, True, 0, 50.0, 0),
    (2, 160, 160, 4, 2, 32, False, 0, 0.0, 0),     # non-causal
    (2, 160, 160, 4, 2, 64, False, 0, 0.0, 0),
    # head dim 256 (gemma-7b): two blocks a (b, h, 64 queries), each 128 of
    # O's columns
    (8, 512, 512, 16, 16, 256, True, 0, 0.0, 0),   # gemma-7b prefill
    (2, 500, 500, 8, 2, 256, True, 0, 0.0, 0),     # ragged tiles, GQA
    (2, 160, 160, 4, 2, 256, True, 64, 50.0, 0),   # window and softcap
    (2, 100, 300, 4, 2, 256, True, 0, 0.0, 0),     # Sq < Skv
    (2, 200, 256, 4, 2, 256, False, 0, 0.0, 150),  # kv_len, non-causal
    # recurrentgemma-2b's local layers: MQA 10/1 at 256, window 2048
    (8, 512, 512, 10, 1, 256, True, 2048, 0.0, 0),  # its prefill
    (2, 2400, 2400, 10, 1, 256, True, 2048, 0.0, 0),  # past the window
    (8, 512, 512, 48, 8, 128, True, 0, 0.0, 0),    # dbrx-132b prefill
    (8, 512, 512, 40, 8, 128, True, 8192, 0.0, 0),  # llama4 local prefill
    (1, 8400, 8400, 40, 8, 128, True, 8192, 0.0, 0),  # ... past the window
    (8, 512, 512, 40, 8, 128, True, 0, 0.0, 0),    # ... its global layer
    # whisper-base, 8/8 heads of 64, not causal over its 1500 frames (a
    # ragged query and key tile): the encoder, a prefill's cross-attention
    # and a verify's 6 queries
    (8, 1500, 1500, 8, 8, 64, False, 0, 0.0, 0),
    (8, 128, 1500, 8, 8, 64, False, 0, 0.0, 0),
    (8, 6, 1500, 8, 8, 64, False, 0, 0.0, 0),
    (8, 768, 768, 14, 2, 64, True, 0, 0.0, 0),     # internvl2's fused prefill
])
def test_flash_kernel_matches_plain(card, dtype, B, Sq, Skv, H, KV, hd,
                                    causal, window, cap, kv_len):
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = _qkv(g, (B, Sq, H, hd), (B, Skv, KV, hd), dtype, card)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=cap,
              kv_len=kv_len)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(),
                               ops.flash_attention_plain(q, k, v, **kw).float(),
                               atol=atol, rtol=rtol)


# gemma2-27b's attention: 32 query heads over 16 KV heads (its drafter 36 /
# 36), head dim 128, query scale 144^-0.5, softcap 50, local window 4096
GEMMA2_SCALE, GEMMA2_CAP, GEMMA2_WINDOW = 144 ** -0.5, 50.0, 4096


def _ring_positions(B, ring, last, device):
    """Slot s of a ring of ``ring`` slots holds the last position p <= last
    with p % ring == s: wrapped, not monotone in the slot index."""
    s = torch.arange(ring, dtype=torch.int32, device=device)
    kpos = last - torch.remainder(last - s, ring)
    return kpos[None].repeat(B, 1).to(torch.int32).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,B,T,H,KV,S,valid,window,qscale", [
    ("target verify, phase 1", 8, 6, 32, 16, 1024, 576, 0, 2.0),
    ("target verify, phase 2", 8, 6, 32, 16, 6, 6, 0, 2.0),
    ("drafter draft, phase 1", 8, 5, 36, 36, 1024, 575, 0, 2.0),
    ("drafter extend, phase 1", 8, 6, 36, 36, 1024, 576, 0, 2.0),
    ("local ring, wrapped", 8, 6, 32, 16, 4102, -1, 4096, 2.0),
    ("cap bites: q scale 16", 8, 6, 32, 16, 1024, 576, 0, 16.0),
])
def test_softcap_decode_kernel_matches_plain(card, dtype, label, B, T, H, KV,
                                             S, valid, window, qscale):
    """The decode kernel with gemma2's softcap at its shapes, against the
    plain version (``blocked_attention`` with ``logit_cap``). ``valid`` -1:
    the cache is a local layer's ring of window + 6 slots after position
    4700 (wrapped, the window crossing chunk boundaries)."""
    hd = 128
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = _qkv(g, (B, T, H, hd), (B, S, KV, hd), dtype, card)
    q = (q.float() * (qscale / 2.0)).to(dtype)
    if valid < 0:
        kpos = _ring_positions(B, S, 4700, card)
        qpos = (4701 + torch.arange(T, dtype=torch.int32, device=card)
                )[None].repeat(B, 1)
    else:
        kpos = torch.arange(S, dtype=torch.int32, device=card)[None].repeat(
            B, 1)
        kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32)
        qpos = (max(valid, T) - T + torch.arange(
            T, dtype=torch.int32, device=card))[None].repeat(B, 1)
    kw = dict(scale=GEMMA2_SCALE, window=window, softcap=GEMMA2_CAP)
    out, m, l = ops.decode_attention(q, k, v, kpos, qpos.contiguous(),
                                     return_stats=True, **kw)
    torch.cuda.synchronize()
    po, pm, pl = ops.decode_attention_plain(q, k, v, kpos, qpos,
                                            return_stats=True, **kw)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,KV", [(6, 32, 16), (5, 36, 36), (6, 36, 36)])
def test_softcap_paged_kernel_matches_plain(card, dtype, T, H, KV):
    """The paged kernel with gemma2's softcap at its phase-1 shapes (global
    layers and the drafter: page 16, 64 table entries a row)."""
    q, k, v, pos, table, qpos = _paged_inputs(card, dtype, 8, T, H, KV, 128,
                                              513, 16, 64)
    kw = dict(scale=GEMMA2_SCALE, softcap=GEMMA2_CAP)
    out, m, l = ops.paged_decode_attention(q, k, v, pos, table, qpos,
                                           return_stats=True, **kw)
    torch.cuda.synchronize()
    po, pm, pl = ops.paged_decode_attention_plain(q, k, v, pos, table, qpos,
                                                  return_stats=True, **kw)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,last", [(6, 2600), (6, 4700), (128, 3000)])
def test_mqa_hd256_ring_decode_matches_plain(card, dtype, T, last):
    """recurrentgemma-2b's local layers on a ring of 2048 + 6 slots (K 5)
    after position ``last`` (wrapped; the window's edge falls inside a
    split chunk): MQA 10/1 at head dim 256, window 2048, a verify block and
    a decode-mode admission chunk of 128."""
    B, H, KV, hd, window = 8 if T == 6 else 1, 10, 1, 256, 2048
    ring = window + 6
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = _qkv(g, (B, T, H, hd), (B, ring, KV, hd), dtype, card)
    kpos = _ring_positions(B, ring, last, card)
    qpos = (last + 1 + torch.arange(T, dtype=torch.int32, device=card)
            )[None].repeat(B, 1).contiguous()
    kw = dict(scale=hd ** -0.5, window=window)
    out, m, l = ops.decode_attention(q, k, v, kpos, qpos, return_stats=True,
                                     **kw)
    torch.cuda.synchronize()
    po, pm, pl = ops.decode_attention_plain(q, k, v, kpos, qpos,
                                            return_stats=True, **kw)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_softcap_and_window_past_4096(card, dtype):
    """gemma2's local-layer prefill at S 4608 > its window: softcap 50 and
    window 4096 both bite."""
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = _qkv(g, (1, 4608, 32, 128), (1, 4608, 16, 128), dtype, card)
    kw = dict(scale=GEMMA2_SCALE, causal=True, window=GEMMA2_WINDOW,
              softcap=GEMMA2_CAP)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(),
                               ops.flash_attention_plain(q, k, v, **kw).float(),
                               atol=atol, rtol=rtol)


def test_gemma2_rings_lossless_through_kernels(card):
    """Reduced gemma2 (window 64, rings of 64 + 4 slots at max_len 160) on
    the card through the kernels: parallel equals none over a run past the
    window, and a paged serve (per-slot rings beside the pools) equals the
    contiguous run."""
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.scheduler import Request, Scheduler
    kw = dict(arch="gemma2-27b", reduced=True, K=3, max_new=80, max_len=160,
              batch=2, seed=0, device=card)
    none = build_engine(mode="none", **kw)
    par = build_engine(mode="parallel", **kw)
    assert par.ring
    prompts = random_prompts(par.tcfg.vocab_size, 2, 40, seed=1)
    want = none.run(prompts)["tokens"][:, :120]
    np.testing.assert_array_equal(par.run(prompts)["tokens"][:, :120], want)
    paged = build_engine(mode="parallel", kv_layout="paged", page_size=16,
                         **kw)
    rep = Scheduler(paged).serve([Request(p, max_new_tokens=80)
                                  for p in prompts])
    got = np.stack([r["tokens"] for r in rep["results"]])
    np.testing.assert_array_equal(got, want[:, 40:])


def test_cuda_tensor_never_takes_the_plain_path(card):
    q = torch.zeros((1, 2, 2, 48), device=card)       # hd 48: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :1].contiguous(),
                            q[:, :, :1].contiguous(), scale=1.0)


def _paged_inputs(card, dtype, B, T, H, KV, hd, NP, page, nb, seed=0):
    """q, pools and a fragmented table: each row owns a random set of pool
    pages (later table entries -1) holding positions 0..length-1; pages of
    other rows and free pages hold positions the row must not see."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = _qkv(g, (B, T, H, hd), (NP, page, KV, hd), dtype, card)
    table = np.full((B, nb), -1, np.int32)
    pos_pool = rng.integers(0, nb * page, (NP, page)).astype(np.int32)
    qpos = np.zeros((B, T), np.int32)
    perm, used = rng.permutation(NP), 0
    for b in range(B):
        n_alloc = int(rng.integers(1, min(nb, (NP - used) // (B - b)) + 1))
        pages = perm[used:used + n_alloc]
        used += n_alloc
        table[b, :n_alloc] = pages
        length = int(rng.integers(1, n_alloc * page + 1))
        for i, p in enumerate(pages):
            fill = int(np.clip(length - i * page, 0, page))
            pos_pool[p] = -1
            pos_pool[p, :fill] = i * page + np.arange(fill)
        qpos[b] = length + np.arange(T)
    as_t = lambda a: torch.as_tensor(a, device=card).contiguous()
    return q, k, v, as_t(pos_pool), as_t(table), as_t(qpos)


def _paged_check(inp, dtype):
    """One kernel call (one launch count, combine included) against the
    plain version, output and stats."""
    hd = inp[0].shape[-1]
    before = ops.launches["paged_decode_attention"]
    out, m, l = ops.paged_decode_attention(*inp, scale=hd ** -0.5,
                                           return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["paged_decode_attention"] == before + 1
    po, pm, pl = ops.paged_decode_attention_plain(*inp, scale=hd ** -0.5,
                                                  return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)
    return out, m, l


# splits on a 132-SM H100 (ops.decode_split) in the comments: the bfloat16
# kernel's 64-key tiles span 8, 4 or 2 pages at page 8, 16 or 32
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,hd,NP,page,nb", [
    (8, 6, 12, 2, 128, 513, 16, 64),    # target verify, phase 1 (16)
    (8, 5, 12, 12, 128, 513, 16, 64),   # drafter draft, phase 1 (4)
    (8, 6, 12, 12, 128, 513, 16, 64),   # drafter extend, phase 1 (4)
    (2, 6, 4, 2, 64, 12, 16, 4),        # the JAX kernel sweep's shapes (1)
    (1, 1, 4, 4, 32, 8, 32, 3),         # (2)
    (3, 4, 2, 1, 128, 16, 8, 6),        # (1)
    (8, 6, 12, 2, 128, 1025, 8, 128),   # page 8 (16)
    (8, 6, 12, 2, 128, 257, 32, 32),    # page 32 (16)
    (8, 6, 12, 2, 128, 600, 16, 37),    # nb * page 592, not a multiple of 64
    (4, 200, 12, 2, 128, 160, 16, 40),  # row tiles fill the card (1)
    (8, 6, 16, 16, 256, 513, 16, 64),   # gemma-7b verify, hd 256
    (3, 4, 2, 1, 256, 16, 8, 6),        # the JAX sweep's layout at hd 256
    (8, 6, 10, 1, 256, 513, 16, 64),    # recurrentgemma verify, MQA 10/1
    (8, 6, 48, 8, 128, 513, 16, 64),    # dbrx-132b verify, GQA 48/8
    (8, 5, 48, 48, 128, 513, 16, 64),   # ... its drafter's draft
    (8, 6, 40, 8, 128, 513, 16, 64),    # llama4 verify, GQA 40/8
    (8, 5, 40, 40, 128, 513, 16, 64),   # ... its drafter's draft
    (8, 6, 14, 2, 64, 641, 16, 80),     # internvl2 verify at max_len 1280
    (8, 5, 7, 7, 128, 641, 16, 80),     # ... its drafter's draft
    (8, 6, 8, 8, 64, 225, 16, 28),      # whisper self-attention verify
    (8, 5, 4, 4, 128, 225, 16, 28),     # ... its drafter's draft
])
def test_paged_kernel_matches_plain(card, dtype, B, T, H, KV, hd, NP, page,
                                    nb):
    _paged_check(_paged_inputs(card, dtype, B, T, H, KV, hd, NP, page, nb),
                 dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_over_shared_pages_matches_plain(card, dtype):
    """Rows whose tables name the same first pages (a shared prefix, as the
    prefix cache maps them): each row reads them as its own."""
    q, k, v, pos, table, qpos = _paged_inputs(card, dtype, 8, 6, 12, 2, 128,
                                              513, 16, 64, seed=5)
    length = 20 * 16 + 64
    pages = torch.randperm(512, generator=torch.Generator().manual_seed(1))
    shared, own = pages[:20], pages[20:].view(-1)
    table = torch.full_like(table, -1)
    pos = torch.full_like(pos, -1)
    for b in range(8):
        row = torch.cat([shared, own[4 * b:4 * b + 4]]).to(card)
        table[b, :24] = row
        pos[row] = torch.arange(24 * 16, dtype=torch.int32,
                                device=card).view(24, 16)
    qpos = (length + torch.arange(6, dtype=torch.int32, device=card))[
        None].repeat(8, 1).contiguous()
    pos = torch.where(pos < length, pos, -1).to(torch.int32).contiguous()
    _paged_check((q, k, v, pos, table.contiguous(), qpos), dtype)


def test_paged_holes_inside_live_tiles_are_never_read(card):
    """-1 and out-of-pool page ids inside a row's live range read as empty
    pages (the plain version's view), never as another row's page; and a
    batch whose tables are all -1 gives zeros with l 0, m -1e30."""
    B, T, H, KV, hd, NP, page, nb = 8, 6, 12, 2, 128, 513, 16, 64
    q, k, v, pos, table, qpos = _paged_inputs(card, torch.bfloat16, B, T, H,
                                              KV, hd, NP, page, nb, seed=3)
    holes = table.clone()
    for b in range(B):
        n = int((table[b] >= 0).sum())
        holes[b, 0] = -1
        if n > 2:
            holes[b, n // 2] = NP + 7          # past the pool
            holes[b, n - 1] = 2 ** 30
    _paged_check((q, k, v, pos, holes, qpos), torch.bfloat16)
    empty = torch.full_like(table, -1)
    out, m, l = _paged_check((q, k, v, pos, empty, qpos), torch.bfloat16)
    assert out.abs().max().item() == 0.0
    assert (l == 0).all() and (m == -1e30).all()


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_f32_decode_and_paged_each_opt_in(card, hd):
    """The float32 decode and paged kernels, two libraries holding the same
    FMA-body instantiation, load side by side in one process and each
    matches its plain version at every head dim. These shapes stay under
    the 48 KB opt-in threshold, so this does not pin the opt-in flag's
    internal linkage: test_torch_structure.py does."""
    B, T, H, KV, S = 2, 6, 4, 2, 256
    g = torch.Generator(device=card).manual_seed(hd)
    q, k, v = _qkv(g, (B, T, H, hd), (B, S, KV, hd), torch.float32, card)
    kpos = torch.arange(S, dtype=torch.int32, device=card)[None].repeat(B, 1)
    kpos = torch.where(kpos < 200, kpos, -1).to(torch.int32).contiguous()
    qpos = (200 + torch.arange(T, dtype=torch.int32, device=card))[
        None].repeat(B, 1)
    out = ops.decode_attention(q, k, v, kpos, qpos, scale=hd ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ops.decode_attention_plain(q, k, v, kpos, qpos,
                                        scale=hd ** -0.5), atol=1e-4, rtol=0)
    _paged_check(_paged_inputs(card, torch.float32, B, T, H, KV, hd, 40, 16,
                               16, seed=hd), torch.float32)


def test_paged_cuda_tensor_never_takes_the_plain_path(card, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ops, "paged_decode_attention_plain", refuse)
    monkeypatch.setattr(ops, "decode_attention_plain", refuse)
    inp = _paged_inputs(card, torch.bfloat16, 2, 6, 4, 2, 64, 12, 16, 4)
    ops.paged_decode_attention(*inp, scale=0.125)
    torch.cuda.synchronize()
    q, k, v, pos, table, qpos = inp
    with pytest.raises(ValueError, match="block_table"):
        ops.paged_decode_attention(q, k, v, pos, table.long(), qpos,
                                   scale=0.125)


def test_paged_scheduler_matches_contiguous_engine(card):
    """Reduced width: a paged Scheduler.serve under pool pressure gives the
    contiguous Engine.run's tokens per request, through the paged kernel."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW = 3, 20, 12
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=NEW,
                       max_len=64, batch=B, seed=0, device=card)
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    want = eng.run(prompts)["tokens"][:, P:P + NEW]
    peng = Engine(eng.tcfg, eng.dcfg, eng.tparams, eng.dparams,
                  dataclasses.replace(eng.ecfg, kv_layout="paged",
                                      page_size=8, pool_pages=9), B,
                  device=card)
    ops.reset_launches()
    rep = Scheduler(peng).serve([Request(p, max_new_tokens=NEW)
                                 for p in prompts])
    assert rep["preemptions"] > 0 and peng.allocator.n_used == 0
    assert ops.launches["paged_decode_attention"] == (
        (eng.tcfg.n_layers + 2 * eng.dcfg.n_layers) * rep["iterations"])
    for r, w in zip(rep["results"], want):
        np.testing.assert_array_equal(r["tokens"], w)


def test_policies_on_card_equal_a_cold_engine(card):
    """Reduced width on the card: the prefix cache, swap to pinned host
    memory and adaptive K give a cache-off, recompute, fixed-K engine's
    tokens on shared-prefix traffic that swaps and hits; both pools drain."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, shared_prefix_requests
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Scheduler
    off = build_engine(reduced=True, mode="parallel", K=3, max_new=16,
                       max_len=96, batch=3, seed=0, device=card,
                       kv_layout="paged", page_size=8, pool_pages=14)
    on = Engine(off.tcfg, off.dcfg, off.tparams, off.dparams,
                dataclasses.replace(off.ecfg, prefix_cache=True, swap="host"),
                3, device=card)

    def reqs():
        return shared_prefix_requests(off.tcfg.vocab_size, 8, 24, 2, (4, 16),
                                      (8, 16), 1.0, seed=0, repeats=2)
    want = Scheduler(off).serve(reqs())
    got = Scheduler(on, adaptive_k=True).serve(reqs())
    assert got["preempt_swap"] > 0 and got["cache_hit_requests"] >= 6
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    assert len(on.host_pool) == 0 and on.host_pool.used_bytes == 0
    on.prefix_cache.flush(on.allocator)
    assert on.allocator.n_used == 0


def test_swap_round_trip_on_card_is_bitwise(card):
    """A slot copied to pinned host memory (non-blocking) and back restores
    its rows and pages bit for bit."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import cache_ops
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=16,
                       max_len=64, batch=2, seed=0, device=card,
                       kv_layout="paged", page_size=8, pool_pages=10,
                       swap="host")
    state = eng.blank_state()
    state, _, _ = eng.prefill_into_slot(state, np.arange(1, 20), 1,
                                        max_new=16)
    state = eng.step(state)

    def view():
        pages = torch.tensor(eng._slot_pages[1], dtype=torch.int32,
                             device=card)
        return cache_ops.extract_slot(eng._core(state), 1, pages, eng.pspec)
    before = view()
    state, ok = eng.swap_out_slot(state, 1, rid="r")
    assert ok and eng.host_pool.get("r").snap.is_pinned()
    state, _ = eng.swap_in_slot(state, 1, "r")
    after = view()
    for key in ("tcache", "dcache"):
        for a, b in zip(after[key]["blocks"], before[key]["blocks"]):
            for leaf in ("k", "v", "positions"):
                assert torch.equal(a[leaf], b[leaf]), (key, leaf)
    for key in ("tokens", "logprobs", "last", "taps_last"):
        assert torch.equal(after[key], before[key]), key


@pytest.mark.parametrize("arch", ["dbrx-132b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_apply_on_card_equals_cpu(card, arch):
    """``moe_apply`` at the published routing (dbrx 16 / top-4, llama4 128
    / top-1 and its shared expert; 1.25 capacity) and a reduced width, in
    float32, at a plain decode's (8 x 1), a verify's (8 x 6), a short
    prefill's (2 x 6) and a prefill's (8 x 512) token counts:
    the card's experts and dropped slots equal the CPU's, its output is
    within 1e-4 of the CPU's relative to the output's scale, and two runs
    on the card give the same bits (the combine uses no atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    full = get_config(arch)
    m = full.moe
    d, f = 512, 1024
    g = torch.Generator().manual_seed(0)
    p = moe.moe_init(d, f, m.n_experts, m.n_shared_experts, full.mlp_variant,
                     g, device="cpu", dtype=torch.float32)
    kw = dict(n_experts=m.n_experts, top_k=m.top_k,
              capacity_factor=m.capacity_factor, variant=full.mlp_variant,
              n_shared=m.n_shared_experts)
    pc = {k: ({n: t.to(card) for n, t in v.items()} if isinstance(v, dict)
              else v.to(card)) for k, v in p.items()}
    drops = []
    for B, S in ((8, 1), (8, 6), (2, 6), (8, 512)):
        x = torch.randn(B, S, d, generator=g)
        want, waux = moe.moe_apply(p, x, **kw)
        got, gaux = moe.moe_apply(pc, x.to(card), **kw)
        again, _ = moe.moe_apply(pc, x.to(card), **kw)
        xf = x.reshape(-1, d)
        assert torch.equal(moe.route(pc, xf.to(card), m.top_k)[3].cpu(),
                           moe.route(p, xf, m.top_k)[3])
        slots = B * S * m.top_k
        drops.append(round(float(waux["drop_frac"]) * slots))
        assert round(float(gaux["drop_frac"]) * slots) == drops[-1]
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err <= 1e-4, err
        assert torch.equal(got, again)
    assert any(drops), "the published routing dropped nothing"


def test_encdec_forward_on_card_equals_cpu(card):
    """whisper-base at full width cut to 2 encoder and 2 decoder layers, in
    float32, batch 2 over 1500 stub frames: train and prefill (the encoder
    and the cross-attention through non-causal flash), then a verify block
    against the prefill's cache (its cross-attention through the decode
    kernel, keys at position 0) on the card equal the CPU's plain forward:
    logits within 1e-3 (sums in another order), the cross K/V the prefill
    cached within 1e-4, and the launches one flash an encoder, self and
    cross layer at the prefill, 2 decode a self layer and one a cross
    layer at the verify."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model, make_extras
    cfg = get_config("whisper-base").replace(n_layers=2, n_encoder_layers=2,
                                              dtype="float32")
    model = get_model(cfg, card)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    on = {"cpu": params, "cuda": _to_card(params, card)}
    ex = make_extras(cfg, 2, "prefill", prng.PRNGKey(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    blk = torch.randint(0, cfg.vocab_size, (2, 6),
                        generator=torch.Generator().manual_seed(2))
    pos = (20 + torch.arange(6, dtype=torch.int32))[None].repeat(2, 1)
    outs = {}
    for dev in ("cpu", "cuda"):
        d = card if dev == "cuda" else torch.device("cpu")
        exd = {k: v.to(d) for k, v in ex.items()}
        ops.reset_launches()
        with torch.no_grad():
            train = model.forward(on[dev], toks.to(d), mode="train", **exd)
            cache = model.make_cache(2, 64, dtype=torch.float32, device=d)
            pre = model.forward(on[dev], toks.to(d), mode="prefill",
                                cache=cache, **exd)
            n_pre = dict(ops.launches)
            ver = model.forward(on[dev], blk.to(d), mode="decode",
                                positions=pos.to(d), cache=pre.cache)
        outs[dev] = (train.logits.cpu(), pre.logits.cpu(), ver.logits.cpu(),
                     pre.cache["blocks"][1]["cross"]["k"].cpu())
        if dev == "cuda":
            assert n_pre["flash_attention"] == 2 * 6      # train + prefill
            assert ops.launches["decode_attention"] == 2 * 2 + 2
    for i, got in enumerate(outs["cuda"]):
        torch.testing.assert_close(got, outs["cpu"][i], rtol=0,
                                   atol=1e-4 if i == 3 else 1e-3)


def _to_card(tree, card):
    if isinstance(tree, dict):
        return {k: _to_card(v, card) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v, card) for v in tree]
    return tree.to(card)


def test_engine_lossless_through_kernels(card):
    from repro_torch.launch.serve import build_engine, random_prompts
    toks = {}
    for mode in ("parallel", "ar", "none"):
        eng = build_engine(reduced=True, mode=mode, K=3, max_new=12,
                           max_len=64, batch=2, seed=0, device=card)
        prompts = random_prompts(eng.tcfg.vocab_size, 2, 16, seed=0)
        ops.reset_launches()
        toks[mode] = eng.run(prompts)["tokens"]
        assert ops.launches["flash_attention"] == eng.tcfg.n_layers
        assert ops.launches["decode_attention"] > 0
    np.testing.assert_array_equal(toks["parallel"], toks["none"])
    np.testing.assert_array_equal(toks["ar"], toks["none"])


def _equal_but_near_ties(none, got, want, start, tie=1e-3):
    """Each row of ``got`` equals ``want`` from ``start`` on, or first
    parts where the plain-decoding engine ``none``'s top-2 logit gap over
    the shared context is below ``tie`` (float32 products of other shapes
    sum in another order)."""
    for b in range(want.shape[0]):
        where = np.flatnonzero(got[b, start:] != want[b, start:])
        if len(where):
            pos = start + int(where[0])
            ctx = torch.as_tensor(want[b:b + 1, :pos], device=none.device)
            with torch.no_grad():
                top2 = none.model.forward(none.tparams, ctx,
                                          collect_taps=False,
                                          head_last_only=True
                                          ).logits[0, -1].topk(2).values
            assert float(top2[0] - top2[1]) < tie, (b, pos)


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-780m"])
def test_full_width_two_layers_serve_on_card(card, arch):
    """gemma-7b (head dim 256 through the decode, paged and flash kernels)
    and the SSM mamba2-780m (its drafter through the decode and paged
    kernels, the target through none) at full width cut to 2 layers, in
    float32: parallel equals plain decoding but at near-ties; a paged
    Scheduler.serve under pool pressure (swap to host on) equals the
    contiguous one token for token; launch counts of the target's family."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW = 2, 40, 16
    kw = dict(arch=arch, n_layers=2, dtype="float32", K=3, max_new=NEW,
              max_len=64, batch=B, seed=0, device=card)
    par = build_engine(mode="parallel", **kw)
    none = Engine(par.tcfg, None, par.tparams, None,
                  dataclasses.replace(par.ecfg, drafter_mode="none", K=0), B,
                  device=card)
    prompts = random_prompts(par.tcfg.vocab_size, B, P, seed=1)
    ops.reset_launches()
    got = par.run(prompts)["tokens"][:, :P + NEW]
    flash = ops.launches["flash_attention"]
    assert flash == (2 if arch == "gemma-7b" else 0)
    want = none.run(prompts)["tokens"][:, :P + NEW]
    _equal_but_near_ties(none, got, want, P)
    reqs = lambda: [Request(p, max_new_tokens=NEW)        # noqa: E731
                    for p in prompts]
    paged = Engine(par.tcfg, par.dcfg, par.tparams, par.dparams,
                   dataclasses.replace(par.ecfg, kv_layout="paged",
                                       page_size=8, pool_pages=13,
                                       swap="host"), B, device=card)
    ops.reset_launches()
    rep = Scheduler(paged).serve(reqs())
    assert ops.launches["paged_decode_attention"] > 0
    assert rep["preemptions"] > 0 and paged.allocator.n_used == 0
    ref = Scheduler(par).serve(reqs())
    for r, w in zip(rep["results"], ref["results"]):
        np.testing.assert_array_equal(r["tokens"], w["tokens"])


@pytest.mark.parametrize("shape", [(5,), (3, 70001), (2, 8, 151936)],
                         ids=str)
def test_prng_on_card_equals_cpu(card, shape):
    """Threefry words, uniforms and Bernoulli masks from keys on the card
    equal the CPU's bit for bit (both hold 32-bit words in int64)."""
    from repro_torch import prng
    keys = prng.split(prng.fold_in(prng.PRNGKey(2 ** 40 + 7), 517), 3)
    for k in (keys, keys[1]):
        for fn in (lambda k: prng.bits(k, shape),
                   lambda k: prng.uniform(k, shape).view(torch.int32),
                   lambda k: prng.bernoulli(k, 0.9, shape),
                   lambda k: prng.split(k, 5)):
            assert torch.equal(fn(k.to(card)).cpu(), fn(k))


def _first_token_chi2(device, sampled_drafts, N=2 ** 14):
    """tests/test_torch_sampling.py's losslessness check: (statistic,
    threshold, draws outside the support) of the first committed token
    over N seeded rows against the warped target."""
    from scipy.stats import chi2
    from repro_torch import prng
    from repro_torch.core import spec_decode as SD
    V, Kc = 8, 3
    g = np.random.default_rng(0)
    logits = torch.from_numpy((1.5 * g.standard_normal((1, Kc + 1, V)))
                              .astype(np.float32)).to(device)
    p = SD.warp_probs(logits, torch.tensor([0.8], device=device),
                      torch.tensor([6], device=device),
                      torch.tensor([1.0], device=device))[0]
    q = torch.softmax(torch.from_numpy(g.standard_normal((Kc, V)).astype(
        np.float32)).to(device), -1)
    keys = prng.split(prng.PRNGKey(0, device=device), N)
    kd, kv = prng.split(keys, 2).unbind(1)
    if sampled_drafts:
        drafts = prng.categorical(prng.split(kd, Kc), torch.log(q)[None])
        dprobs = q.expand(N, Kc, V)
    else:
        drafts = q.argmax(-1).expand(N, Kc)
        dprobs = torch.nn.functional.one_hot(drafts, V).float()
    _, committed = SD.rejection_verify_rows(
        kv, drafts.to(torch.int32), dprobs, p.expand(N, Kc + 1, V))
    obs = torch.bincount(committed[:, 0].long(), minlength=V).cpu().numpy()
    exp = p[0].cpu().numpy().astype(np.float64) * N
    live = exp > 0
    stat = float((((obs - exp) ** 2)[live] / exp[live]).sum())
    return stat, chi2.ppf(0.999, live.sum() - 1), int(obs[~live].sum())


@pytest.mark.parametrize("sampled_drafts", [False, True],
                         ids=["one-hot drafts", "sampled drafts"])
def test_rejection_verify_lossless_on_card(card, sampled_drafts):
    stat, threshold, outside = _first_token_chi2(card, sampled_drafts)
    assert outside == 0
    assert stat < threshold, (stat, threshold)


def test_sampled_paged_serve_matches_contiguous_engine(card):
    """Reduced width, sampled: each request served by a paged scheduler
    under pool pressure (preempting sampled requests) emits what the
    contiguous engine's run emits for its row, except after a decision
    whose margin is below 1e-4; the kernels' launch counts are the greedy
    path's."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.margins import MarginLog
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW = 3, 20, 12
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=4)
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=NEW,
                       max_len=64, batch=1, seed=0, device=card, sampling=sp)
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    with MarginLog() as log:
        want = [eng.run(p[None])["tokens"][0, P:P + NEW] for p in prompts]
        peng = Engine(eng.tcfg, eng.dcfg, eng.tparams, eng.dparams,
                      dataclasses.replace(eng.ecfg, kv_layout="paged",
                                          page_size=8, pool_pages=9), B,
                      device=card)
        ops.reset_launches()
        rep = Scheduler(peng).serve([Request(p, max_new_tokens=NEW)
                                     for p in prompts])
    assert rep["preemptions"] > 0 and peng.allocator.n_used == 0
    assert ops.launches["paged_decode_attention"] == (
        (eng.tcfg.n_layers + 2 * eng.dcfg.n_layers) * rep["iterations"])
    for r, w in zip(rep["results"], want):
        diff = np.flatnonzero(r["tokens"] != w)
        if len(diff):
            assert log.min_margin(sp.seed, P, P + int(diff[0])) < 1e-4


@pytest.mark.parametrize("arch,layout,mode,mixed,dtype", [
    ("qwen2-1.5b", "paged", "parallel", False, None),
    ("qwen2-1.5b", "paged", "parallel", False, "bfloat16"),
    ("qwen2-1.5b", "contiguous", "parallel", True, None),
    ("qwen2-1.5b", "paged", "ar", True, None),
    ("qwen2-1.5b", "contiguous", "ar", False, "bfloat16"),
    ("dbrx-132b", "paged", "parallel", False, None),        # MoE
    ("mamba2-780m", "paged", "parallel", True, None),       # recurrent
])
def test_verify_replay_equals_eager(card, monkeypatch, arch, layout, mode,
                                    mixed, dtype):
    """Reduced width: a scheduler whose engine replays the verify forward
    from CUDA graphs streams, session after session, bitwise the tokens
    and logprobs of the same engine run eagerly, over more than 64 steps
    (a paged pool small enough to preempt; greedy, or even requests greedy
    and odd ones sampled), with the same kernel launch counts and the same
    paged attention calls seen by a wrapper on ``ops`` (the pieces leave
    them eager). Each session captures once (its first step is eager, its
    second captures) and replays every later step; the graphs' pool holds
    at least the verify's float32 logits."""
    from repro_torch import tracing
    from repro_torch.launch.serve import build_engine, request_policy
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request, Scheduler
    from repro_torch.serving.verify_graph import VerifyGraph, eager
    B, K, NEW = 3, 3, 72
    eng = build_engine(arch=arch, reduced=True, mode=mode, K=K, max_new=NEW,
                       max_len=160, batch=B, seed=0, device=card,
                       dtype=dtype, kv_layout=layout, page_size=8,
                       pool_pages=28)
    ref = Engine(eng.tcfg, eng.dcfg, eng.tparams, eng.dparams, eng.ecfg, B,
                 device=card)
    ref.verify = eager
    assert isinstance(eng.verify, VerifyGraph)
    paged = []
    plain = ops.paged_decode_attention

    def seen(q, *a, **kw):
        paged.append(tuple(q.shape))
        return plain(q, *a, **kw)
    monkeypatch.setattr(ops, "paged_decode_attention", seen)

    def requests():
        rng = np.random.default_rng(3)
        return [Request(rng.integers(1, eng.tcfg.vocab_size - 1,
                                     12 + 4 * i).astype(np.int32),
                        max_new_tokens=NEW - 4 * i,
                        sampling=request_policy(
                            i, temperature=0.8 if mixed else 0.0, top_k=50,
                            top_p=0.95, mixed=True))
                for i in range(4)]

    def serve(sched):
        ops.reset_launches()
        paged.clear()
        before = dict(tracing.counters()["serving"])
        rep = sched.serve(requests())
        after = tracing.counters()["serving"]
        counts = {k: after[f"verify_graph.{k}"] - before[f"verify_graph.{k}"]
                  for k in ("captures", "replays", "eager")}
        return (rep, dict(ops.launches), list(paged),
                after["steps"] - before["steps"], counts)
    want, want_launches, want_paged, want_steps, counts = serve(
        Scheduler(ref))
    assert counts == {"captures": 0, "replays": 0, "eager": want_steps}
    sched = Scheduler(eng)
    for session in (1, 2):
        got, launches, got_paged, steps, counts = serve(sched)
        assert steps >= 64
        assert counts == {"captures": 1, "eager": 1, "replays": steps - 2}
        assert launches == want_launches
        assert got_paged == want_paged
        assert (layout == "paged") == bool(got_paged)
        assert eng.verify.pool_bytes >= B * (K + 1) * eng.tcfg.vocab_size * 4
        for g, w in zip(got["results"], want["results"]):
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            np.testing.assert_array_equal(g["logprobs"], w["logprobs"])


def _mtp_inputs(card, dtype, B, H, KV, hd, n, K, r, mult=64):
    """q, k, v and per-row (B, M) COD metadata, padded with -1 rows."""
    from repro_torch.core import cod
    layouts = []
    for b in range(B):
        pos, dep = cod.sample_cod(np.random.default_rng(b), n, K, r)
        M = int(np.ceil(len(pos) / mult) * mult)
        layouts.append(cod.pad_to(pos, dep, M))
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = _qkv(g, (B, M, H, hd), (B, M, KV, hd), dtype, card)
    pos = torch.as_tensor(np.stack([p for p, _ in layouts]), device=card)
    dep = torch.as_tensor(np.stack([d for _, d in layouts]), device=card)
    return q, k, v, pos.contiguous(), dep.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,K,r,B,H,KV,hd", [
    (48, 4, 0.7, 2, 4, 2, 64), (32, 8, 0.8, 1, 2, 2, 32),
    (24, 2, 0.5, 2, 4, 2, 64),          # the JAX kernel sweep's shapes
    (16, 3, 0.6, 1, 2, 2, 32),          # mostly pad rows
    (512, 8, 0.8, 1, 12, 12, 128),      # the drafter's heads, M 2180
])
def test_mtp_kernel_matches_plain(card, dtype, n, K, r, B, H, KV, hd):
    q, k, v, pos, dep = _mtp_inputs(card, dtype, B, H, KV, hd, n, K, r)
    before = ops.launches["mtp_attention"]
    out, m, l = ops.mtp_attention(q, k, v, pos, dep, scale=hd ** -0.5,
                                  return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["mtp_attention"] == before + 1
    po, pm, pl = ops.mtp_attention_plain(q, k, v, pos, dep, scale=hd ** -0.5,
                                         return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)
    pad = dep < 0
    if pad.any():
        assert out[pad].abs().max().item() == 0.0


def _mtp_layout(kind, seed=0):
    """(pos, depth) of one row, padded with -1 to a multiple of 64:
    "shuffled" a COD layout in random order (pad rows among the real ones),
    "segment" the largest Algorithm-1 segment of n 1024 in 4 (its depth-0
    context first, then an interleaved block), "no chains" a layout of
    depth-0 keys only (K 1: every chain pass is empty)."""
    from repro_torch.core import cod, partition
    rng = np.random.default_rng(seed)
    if kind == "segment":
        p, d = cod.sample_cod(rng, 1024, 8, 0.8)
        seg = max(partition.build_segments(p, d, 1024, 4),
                  key=lambda sg: len(sg.kv_pos))
        p, d = seg.kv_pos, seg.kv_depth
    else:
        p, d = cod.sample_cod(rng, 700, 1 if kind == "no chains" else 8, 0.8)
    p, d = cod.pad_to(p, d, int(np.ceil(len(p) / 64) * 64))
    if kind == "shuffled":
        perm = rng.permutation(len(p))
        p, d = p[perm], d[perm]
    return p, d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,H,KV,hd", [
    ("shuffled", 4, 2, 64), ("shuffled", 12, 12, 128),
    ("segment", 12, 12, 128), ("segment", 4, 2, 32),
    ("no chains", 4, 2, 64),
])
def test_mtp_kernel_layouts_match_plain(card, dtype, kind, H, KV, hd):
    """The depth-split walk gives the predicate's function for any layout:
    rows in random order, a segment's context before its interleaved block,
    and rows that have no chain keys."""
    from repro_torch.core import cod
    layouts = [_mtp_layout(kind, seed=b) for b in range(2)]
    M = max(len(p) for p, _ in layouts)
    layouts = [cod.pad_to(p, d, M) for p, d in layouts]
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = _qkv(g, (2, M, H, hd), (2, M, KV, hd), dtype, card)
    pos = torch.as_tensor(np.stack([p for p, _ in layouts]), device=card)
    dep = torch.as_tensor(np.stack([d for _, d in layouts]), device=card)
    before = ops.launches["mtp_attention"]
    out, m, l = ops.mtp_attention(q, k, v, pos, dep, scale=hd ** -0.5,
                                  return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["mtp_attention"] == before + 1
    po, pm, pl = ops.mtp_attention_plain(q, k, v, pos, dep, scale=hd ** -0.5,
                                         return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    for got, want in ((m, pm), (l, pl)):    # STATS_TOL: 1e-4 of 1 + |want|
        assert ((got - want).abs() / (1 + want.abs())).max().item() <= 1e-4
    pad = dep < 0
    assert out[pad].abs().max().item() == 0.0


def test_mtp_flash_grads_match_plain_autograd(card, monkeypatch):
    from repro_torch.core.flash_train import mtp_flash_attention
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, pos, dep = _mtp_inputs(card, torch.float32, 2, 4, 2, 64, 200, 4,
                                    0.8)
    cot = torch.randn(q.shape, generator=torch.Generator(
        device=card).manual_seed(3), device=card)
    grads = []
    for fn in (mtp_flash_attention, ops.mtp_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, pos, dep, scale=64 ** -0.5)
        grads.append(torch.autograd.grad(out, leaves, cot))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max(),
                                   rtol=0)


def test_trainer_steps_through_kernels(card):
    """A whole and a segmented reduced training step on the card: every
    drafter layer's attention launches the MTP kernel once per forward, the
    target's taps 2 flash launches."""
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.data import MTPPipeline, markov_corpus
    from repro_torch.models.registry import get_model
    from repro_torch.training import TrainConfig, Trainer
    tcfg = get_config("qwen2-1.5b").reduced()
    dcfg = DrafterConfig(n_layers=2).resolve(tcfg)
    tparams = get_model(tcfg).init(
        torch.Generator(device=card).manual_seed(0), device=card)
    corpus = markov_corpus(0, 2, 64, tcfg.vocab_size)
    for segments in (1, 2):
        tr = Trainer(tcfg, dcfg, tparams, TrainConfig(), device=card)
        batch = next(iter(MTPPipeline(corpus, k_train=8, cod_rate=0.8,
                                      batch=2, segments=segments)))
        ops.reset_launches()
        m = tr.train_batch(batch)
        torch.cuda.synchronize()
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert ops.launches == {"decode_attention": 0,
                                "paged_decode_attention": 0,
                                "flash_attention": tcfg.n_layers,
                                "mtp_attention": dcfg.n_layers * segments}


def _stream(aeng, workload, abort_at=None):
    """Stream ``workload`` ((prompt, policy, budget) each) through an
    AsyncEngine; request ``abort_at`` is aborted after its first chunk.
    Returns the token lists and the report."""
    import asyncio

    async def go():
        handles = [await aeng.submit(p, sp, max_new_tokens=b)
                   for p, sp, b in workload]

        async def drain(i, h):
            toks = []
            async for tok, _ in h:
                toks.append(tok)
                if i == abort_at and not h.done:
                    h.abort()
            return toks
        got = await asyncio.gather(*(drain(i, h)
                                     for i, h in enumerate(handles)))
        return got, await aeng.close()
    return asyncio.run(asyncio.wait_for(go(), 120))


def _stream_workload(vocab, n=6):
    from repro_torch.serving.sampling import SamplingParams
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab - 1, int(rng.integers(8, 30))).astype(
        np.int32), None if i % 2 == 0
        else SamplingParams(temperature=0.8, top_k=50, seed=30 + i),
        int(rng.integers(6, 15))) for i in range(n)]


def test_streamed_equals_virtual_twin_on_card(card):
    """Reduced width on the card: AsyncEngine over a pool that preempts
    streams the virtual twin's tokens exactly, through the paged kernel."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.streaming import AsyncEngine, virtual_twin_report
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=16,
                       max_len=64, batch=3, seed=0, device=card,
                       kv_layout="paged", page_size=8, pool_pages=9)
    work = _stream_workload(eng.tcfg.vocab_size)
    twin = virtual_twin_report(eng, work)
    ops.reset_launches()
    got, rep = _stream(AsyncEngine(eng), work)
    assert twin["preemptions"] > 0 and rep["aborted"] == 0
    assert ops.launches["paged_decode_attention"] == (
        (eng.tcfg.n_layers + 2 * eng.dcfg.n_layers) * rep["iterations"])
    for g, w in zip(got, twin["results"]):
        assert g == w["tokens"].tolist()
    assert eng.allocator.n_used == 0


@pytest.mark.parametrize("swap", ["none", "host"])
def test_abort_frees_pages_on_card(card, swap):
    """An aborted stream gives its pages back (and, swapped out, its pinned
    host bytes); the others equal the twin; both pools drain."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.streaming import AsyncEngine, virtual_twin_report
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=16,
                       max_len=64, batch=3, seed=0, device=card,
                       kv_layout="paged", page_size=8, pool_pages=9,
                       swap=swap)
    work = _stream_workload(eng.tcfg.vocab_size)
    twin = virtual_twin_report(eng, work)
    got, rep = _stream(AsyncEngine(eng), work, abort_at=1)
    assert rep["aborted"] == 1 and rep["results"][1]["aborted"]
    assert 0 < len(got[1]) < work[1][2]
    assert got[1] == twin["results"][1]["tokens"].tolist()[:len(got[1])]
    for i, (g, w) in enumerate(zip(got, twin["results"])):
        if i != 1:
            assert g == w["tokens"].tolist()
    assert eng.allocator.n_used == 0 and not any(eng._slot_pages)
    if swap == "host":
        assert len(eng.host_pool) == 0 and eng.host_pool.used_bytes == 0


def test_round_based_launches_flash_once_per_layer_per_round(card):
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.scheduler import serve_round_based
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=12,
                       max_len=64, batch=2, seed=0, device=card)
    prompts = random_prompts(eng.tcfg.vocab_size, 5, 16, seed=2)
    ops.reset_launches()
    rep = serve_round_based(eng, prompts, [4, 9, 3, 12, 6])
    assert rep["rounds"] == 3 and rep["total_new_tokens"] == 34
    assert ops.launches["flash_attention"] == 3 * eng.tcfg.n_layers
    assert ops.launches["paged_decode_attention"] == 0


# ---------------------------------------------------------------------------
# storage-sharded serving and training over nccl, one card a rank
# ---------------------------------------------------------------------------

@pytest.fixture
def cards(request):
    """The world size, when this machine has a card for each rank."""
    n = request.param
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")
    return n


@pytest.mark.parametrize("cards", [2, 4], indirect=True)
def test_sharded_serving_on_cards(cards, tmp_path):
    """``shard_model=True`` over 2 / 4 cards (qwen2's 2 KV heads: the KV
    axis, then head_dim): Engine.run and a paged serve with swap through
    the kernels, tokens equal to the unsharded engine's."""
    import torch_sharding_child as child
    child.spawn(child.card_serving_child, cards, tmp_path, timeout=600,
                backend="nccl")


@pytest.mark.parametrize("cards", [2, 4], indirect=True)
def test_sharded_train_step_on_cards(cards, tmp_path):
    """The sharded train step on (data 2, model cards / 2) over nccl
    against the one-process step on the card: within atol 2e-5 rtol
    2e-4."""
    import numpy as np_
    import torch_sharding_child as child
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.core import cod
    from repro_torch.core import drafter as D
    from repro_torch.models.registry import get_model
    tcfg = get_config("qwen2-1.5b").reduced()
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    g = torch.Generator().manual_seed(3)
    tp = get_model(tcfg).init(g, device="cpu")
    dp = D.init_params(dcfg, tcfg, g, device="cpu")
    n, rng = 24, np_.random.default_rng(0)
    tokens = rng.integers(1, 1000, (4, n)).astype(np_.int32)
    M = cod.expanded_length(n, dcfg.k_train, dcfg.cod_rate)
    pos, depth = cod.pad_to(*cod.sample_cod(rng, n, dcfg.k_train,
                                            dcfg.cod_rate), M)
    tgt = pos + 2
    labels = np_.where(((pos >= 0) & (tgt < n))[None],
                       tokens[:, np_.clip(tgt, 0, n - 1)], -1)
    setup = (tcfg, dcfg, tp, dp, torch.as_tensor(tokens),
             torch.as_tensor(pos.astype(np_.int32)),
             torch.as_tensor(depth.astype(np_.int32)),
             torch.as_tensor(labels.astype(np_.int32)), 1)
    child.spawn(child.train_child, cards, tmp_path, setup, 2, cards // 2,
                True, timeout=600, backend="nccl")


@pytest.mark.parametrize("cards", [4], indirect=True)
def test_llama4_on_four_cards(cards, tmp_path):
    """llama4-maverick at full width, 4 of 48 layers in bfloat16 (~77 GB
    with its drafter), drawn leaf by leaf into its slices over 4 cards:
    each build peaks at its slices plus one leaf's float32 draw and cast;
    Engine.run parallel and ar equal none at capacity factor 128 (bfloat16
    near-tie rules); a paged serve that swaps equals one that never
    preempts; at 2 layers the sharded tokens are the one-card engine's."""
    import torch_sharding_child as child
    child.spawn(child.card_llama4_child, cards, tmp_path, timeout=900,
                backend="nccl")


@pytest.mark.parametrize("cards", [2, 4], indirect=True)
def test_async_engine_on_cards(cards, tmp_path):
    """AsyncEngine over qwen2-1.5b at full width (2 layers) sharded over
    2 / 4 cards, rank 0 deciding and the others following: its greedy and
    sampled streams equal the unsharded AsyncEngine's."""
    import torch_sharding_child as child
    child.spawn(child.card_async_child, cards, tmp_path, timeout=600,
                backend="nccl")

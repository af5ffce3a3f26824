"""The port's attention dispatch on the CPU, where it takes the kernels'
plain PyTorch versions, held against the JAX package's Pallas kernels
(interpret mode) and jnp oracles on the ``tests/test_kernels.py`` sweep
shapes. Inputs are made with numpy from a seed and handed to both.

Tolerances: 3e-5 in float32 and 2e-2 in bfloat16 (the JAX kernel sweep's),
since both sides accumulate in float32 but in another order and with
bfloat16 inputs rounded identically."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _rand(rng, shape):
    return (0.5 * rng.standard_normal(shape)).astype(np.float32)


def _both(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", [
    (2, 128, 128, 4, 2, 64),
    (1, 256, 256, 4, 4, 32),
    (1, 64, 192, 2, 1, 128),       # cross lengths: ragged key tail
    (2, 96, 96, 6, 2, 64),         # not a multiple of the block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 50.0), (False, 0, 0.0),
])
def test_flash_plain_matches_jax(B, Sq, Skv, H, KV, hd, dtype, causal,
                                 window, cap):
    rng = np.random.default_rng(B * 1000 + Sq + Skv + hd)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(rng, s), dtype)
        for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    tol = DTYPES[dtype][2]
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, jref.attention_reference(jq, jk, jv, **kw), tol)
    _close(ref.attention_reference(tq, tk, tv, **kw),
           jref.attention_reference(jq, jk, jv, **kw), tol)
    _close(out, jops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw),
           tol)


def _decode_inputs(rng, B, T, H, KV, hd, S, dtype):
    valid = S * 3 // 4
    kpos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    kpos = np.where(kpos < valid, kpos, -1).astype(np.int32)
    qpos = (valid - 1 + np.broadcast_to(np.arange(T)[None], (B, T))).astype(
        np.int32)
    arrs = [_both(_rand(rng, s), dtype)
            for s in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    return arrs, kpos, qpos


@pytest.mark.parametrize("B,T,H,KV,hd,S,window", [
    (2, 6, 4, 2, 64, 256, 0),
    (1, 1, 4, 4, 32, 512, 0),
    (2, 6, 4, 2, 64, 256, 64),     # sliding window
    (1, 8, 2, 1, 128, 96, 0),      # ragged key tail
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax(B, T, H, KV, hd, S, window, dtype):
    rng = np.random.default_rng(B * 100 + T + S)
    ((jq, tq), (jk, tk), (jv, tv)), kpos, qpos = _decode_inputs(
        rng, B, T, H, KV, hd, S, dtype)
    tol = DTYPES[dtype][2]
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(kpos),
                               torch.from_numpy(qpos), scale=hd ** -0.5,
                               window=window)
    j_ref = jref.decode_reference(jq, jk, jv, jnp.asarray(kpos),
                                  jnp.asarray(qpos), scale=hd ** -0.5,
                                  window=window)
    _close(out, j_ref, tol)
    _close(ref.decode_reference(tq, tk, tv, torch.from_numpy(kpos),
                                torch.from_numpy(qpos), scale=hd ** -0.5,
                                window=window), j_ref, tol)
    _close(out, jops.decode_attention(jq, jk, jv, jnp.asarray(kpos),
                                      jnp.asarray(qpos), scale=hd ** -0.5,
                                      window=window, block_k=64), tol)


@pytest.mark.parametrize("B,T,H,KV,hd,S", [(2, 6, 4, 2, 64, 64),
                                           (2, 5, 4, 4, 32, 48)])
def test_decode_stats_merge_matches_jax_two_phase(B, T, H, KV, hd, S):
    """The decode plain version's (m, l), merged across the two phases of a
    decode (old cache, then the current block), equals the JAX model's
    blocked_attention + merge_attention, and attention over the whole key
    set at once."""
    rng = np.random.default_rng(7)
    pos0 = S - T
    q, k, v = (_rand(rng, s) for s in ((B, T, H, hd), (B, S, KV, hd),
                                       (B, S, KV, hd)))
    qpos = (pos0 + np.broadcast_to(np.arange(T)[None], (B, T))).astype(np.int32)
    cpos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    old = np.where(cpos >= pos0, -1, cpos).astype(np.int32)
    kb, vb = k[:, pos0:], v[:, pos0:]
    t = torch.from_numpy
    o1, m1, l1 = ops.decode_attention(t(q), t(k), t(v), t(old), t(qpos),
                                      scale=hd ** -0.5, return_stats=True)
    o2, m2, l2 = ops.decode_attention(t(q), t(kb), t(vb), t(qpos), t(qpos),
                                      scale=hd ** -0.5, return_stats=True)
    merged = L.merge_attention(o1, m1, l1, o2, m2, l2)

    jq = jnp.asarray(q)
    j1 = JL.blocked_attention(jq, jnp.asarray(k), jnp.asarray(v),
                              scale=hd ** -0.5, return_stats=True,
                              mask_fn=JL.cache_mask_fn(jnp.asarray(qpos),
                                                       jnp.asarray(old)))
    j2 = JL.blocked_attention(jq, jnp.asarray(kb), jnp.asarray(vb),
                              scale=hd ** -0.5, return_stats=True,
                              mask_fn=JL.cache_mask_fn(jnp.asarray(qpos),
                                                       jnp.asarray(qpos)))
    for mine, theirs in ((m1, j1[1]), (l1, j1[2]), (m2, j2[1]), (l2, j2[2])):
        _close(mine, theirs, 3e-5)
    _close(merged, JL.merge_attention(*j1, *j2), 3e-5)
    full = ref.decode_reference(t(q), t(k), t(v), t(cpos), t(qpos),
                                scale=hd ** -0.5)
    _close(merged, full.numpy(), 3e-5)


def test_decode_plain_empty_cache_rows_are_zero():
    """Phase 1 of the first drafter extend sees an all-empty cache: every
    row has no visible key, so out == 0, l == 0 and m == NEG_INF."""
    rng = np.random.default_rng(3)
    B, T, H, KV, hd, S = 2, 7, 4, 4, 32, 40
    q, k, v = (torch.from_numpy(_rand(rng, s))
               for s in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    kpos = torch.full((B, S), -1, dtype=torch.int32)
    qpos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    out, m, l = ops.decode_attention(q, k, v, kpos, qpos, scale=1.0,
                                     return_stats=True)
    assert out.abs().max().item() == 0.0 and l.abs().max().item() == 0.0
    assert (m == -1e30).all()


def test_cpu_tensors_never_launch_kernels():
    rng = np.random.default_rng(0)
    ops.reset_launches()
    q = torch.from_numpy(_rand(rng, (1, 4, 2, 32)))
    ops.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous(),
                        scale=1.0)
    meta = torch.zeros(4, dtype=torch.int32)
    ops.mtp_attention(q, q, q, meta, meta, scale=1.0)
    pool = q[0, :, :1].reshape(2, 2, 1, 32).contiguous()
    ops.paged_decode_attention(q, pool, pool, meta.reshape(2, 2),
                               meta.reshape(2, 2)[:1], meta[None], scale=1.0)
    assert ops.launches == {"decode_attention": 0,
                            "paged_decode_attention": 0,
                            "flash_attention": 0, "mtp_attention": 0}


@pytest.mark.parametrize("T,H,KV,valid", [
    (6, 12, 2, 576),       # target verify, phase 1
    (5, 12, 12, 575),      # drafter draft, phase 1
])
def test_card_bf16_limit_fails_a_dropped_key_tile(T, H, KV, valid):
    """The limit the card check holds a bfloat16 kernel to (elementwise
    1e-4 + 2^-6 |plain|, on inputs with score std 2) passes a float32 sum
    in another order (the dense oracle against the blocked plain version)
    and fails a result that lost one 32-key tile, by far."""
    B, hd, S = 8, 128, 1024
    g = torch.Generator().manual_seed(0)
    q, k, v = ((scale * torch.randn(s, generator=g)).to(torch.bfloat16)
               for scale, s in ((2.0, (B, T, H, hd)), (1.0, (B, S, KV, hd)),
                                (1.0, (B, S, KV, hd))))
    kpos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32)
    qpos = (valid + torch.arange(T, dtype=torch.int32))[None].repeat(B, 1)
    want = ops.decode_attention_plain(q, k, v, kpos, qpos, scale=hd ** -0.5)

    def used(got):   # the worst element's share of its limit
        d = (got.float() - want.float()).abs()
        return float((d / (1e-4 + 2 ** -6 * want.float().abs())).max())

    reordered = ref.decode_reference(q, k, v, kpos, qpos, scale=hd ** -0.5)
    dropped = kpos.clone()
    dropped[:, 32:64] = -1
    lost = ops.decode_attention_plain(q, k, v, dropped, qpos, scale=hd ** -0.5)
    assert used(reordered) <= 0.5
    assert used(lost) > 100.0


def _used(got, want):
    """The worst element's share of the card's bfloat16 limit."""
    d = (got.float() - want.float()).abs()
    return float((d / (1e-4 + 2 ** -6 * want.float().abs())).max())


def _emulate_pv(q, k, v, ok, scale, p_round):
    """Attention in float32 with P rounded by ``p_round`` before P·V, as a
    tensor-core kernel would feed it, output rounded to q's dtype: q
    (B,Sq,H,hd), k/v (B,Skv,KV,hd), ok (B,1,1,Sq,Skv) or (Sq,Skv)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qr, k.float()) * scale
    s = torch.where(ok, s, ref.NEG_INF)
    p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = sum(torch.einsum("bkgqj,bjkd->bkgqd", part, v.float())
            for part in p_round(p)) / l.clamp_min(1e-30)
    o = torch.where(l > 0, o, 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _bf16_p(p):
    return [p.to(torch.bfloat16).float()]


def _hi_lo_p(p):
    hi = p.to(torch.bfloat16).float()
    return [hi, (p - hi).to(torch.bfloat16).float()]


@pytest.mark.parametrize("shape", ["target prefill", "target verify"])
def test_card_bf16_limit_rejects_bf16_rounded_p(shape):
    """Why the bfloat16 kernels feed P·V as a hi/lo pair of bf16 products:
    on the card's inputs (score std 2) a P rounded to bf16 before P·V uses
    more than the whole elementwise limit 1e-4 + 2^-6 |plain| the card
    holds a bf16 kernel to, while hi = bf16(p), lo = bf16(p - hi) uses at
    most half of it, as a float32 P does (one output rounding step)."""
    g = torch.Generator().manual_seed(0)
    hd = 128
    if shape == "target prefill":       # B 2 of the B 8 x 512 prefill
        B, Sq, Skv, H, KV = 2, 512, 512, 12, 2
    else:                               # phase 1, 576 live of 1024 slots
        B, Sq, Skv, H, KV = 8, 6, 1024, 12, 2
    q, k, v = ((sc * torch.randn(sh, generator=g)).to(torch.bfloat16)
               for sc, sh in ((2.0, (B, Sq, H, hd)), (1.0, (B, Skv, KV, hd)),
                              (1.0, (B, Skv, KV, hd))))
    if shape == "target prefill":
        want = ops.flash_attention_plain(q, k, v, scale=hd ** -0.5)
        idx = torch.arange(Sq)
        ok = idx[:, None] >= idx[None, :]
    else:
        kpos = torch.arange(Skv, dtype=torch.int32)[None].repeat(B, 1)
        kpos = torch.where(kpos < 576, kpos, -1).to(torch.int32)
        qpos = (576 + torch.arange(Sq, dtype=torch.int32))[None].repeat(B, 1)
        want = ops.decode_attention_plain(q, k, v, kpos, qpos,
                                          scale=hd ** -0.5)
        ok = ((kpos[:, None, :] >= 0)
              & (kpos[:, None, :] <= qpos[:, :, None]))[:, None, None]
    rounded = _emulate_pv(q, k, v, ok, hd ** -0.5, _bf16_p)
    split = _emulate_pv(q, k, v, ok, hd ** -0.5, _hi_lo_p)
    assert _used(rounded, want) > 1.0
    assert _used(split, want) <= 0.5


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as cvt.rna.tf32.f32 rounds: integer ops on the float32 bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, n):
    """einsum ``eq`` of a and b as the tensor cores take f32 operands in
    TF32, accumulated in f32: n = 1, tf32(a)·tf32(b); n = 3, the split
    hi·hi + hi·lo + lo·hi with hi = tf32(x), lo = tf32(x - hi)."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if n == 3:
        out = (out + torch.einsum(eq, ah, _tf32(b - bh))
               + torch.einsum(eq, _tf32(a - ah), bh))
    return out


def test_card_f32_limit_rejects_one_tf32_product():
    """Why the MTP kernel takes S = Q·Kᵀ and P·V as three TF32 products: on
    the card's inputs (score std 2) at a reduced MTP shape, one TF32 product
    for each uses more than the whole float32 limit 1e-4 the card holds the
    kernel to, while hi·hi + hi·lo + lo·hi uses at most a tenth of it."""
    from repro_torch.core import cod
    from repro_torch.core.masks import mtp_mask_predicate
    pos, dep = cod.sample_cod(np.random.default_rng(0), 256, 8, 0.8)
    pos, dep = torch.from_numpy(pos), torch.from_numpy(dep)
    B, M, H, hd = 1, len(pos), 2, 128
    g = torch.Generator().manual_seed(0)
    q, k, v = (sc * torch.randn(sh, generator=g)
               for sc, sh in ((2.0, (B, M, H, hd)), (1.0, (B, M, H, hd)),
                              (1.0, (B, M, H, hd))))
    want = ops.mtp_attention_plain(q, k, v, pos, dep, scale=hd ** -0.5)
    ok = mtp_mask_predicate(dep, pos, dep, pos)

    def emulate(n):
        s = _tf32_product("bqhd,bjhd->bhqj", q, k, n) * hd ** -0.5
        s = torch.where(ok, s, ref.NEG_INF)
        p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        o = _tf32_product("bhqj,bjhd->bqhd", p, v, n)
        return o / p.sum(-1).transpose(1, 2)[..., None]

    def used(got):      # the worst element's share of the limit 1e-4
        return float((got - want).abs().max()) / 1e-4

    assert used(emulate(1)) > 1.0
    assert used(emulate(3)) <= 0.1


# the decode serving shapes: (B, T, H, KV), S 1024
_DECODE_SERVING = {"target verify": (8, 6, 12, 2),
                   "drafter draft": (8, 5, 12, 12),
                   "drafter prefill extend": (8, 511, 12, 12)}


def _row_blocks(B, T, H, KV):
    return -(-(H // KV) * T // ops.DECODE_ROW_TILE) * B * KV


@pytest.mark.parametrize("shape", list(_DECODE_SERVING))
@pytest.mark.parametrize("S", [6, 511, 1000, 1024, 40000])
@pytest.mark.parametrize("n_sm", [132, 114, 16])
def test_decode_split_cuts_every_slot_once(shape, S, n_sm):
    """decode_split cuts the S slots into contiguous chunks, each a
    multiple of the key tile and at most DECODE_MAX_CHUNK_TILES tiles, and
    none empty, so every slot lies in exactly one chunk; a launch of row
    tiles that already fills the card is not split."""
    B, T, H, KV = _DECODE_SERVING[shape]
    rb = _row_blocks(B, T, H, KV)
    splits, chunk = ops.decode_split(S, rb, n_sm)
    tile = ops.DECODE_KEY_TILE
    assert splits >= 1 and chunk % tile == 0
    assert chunk <= ops.DECODE_MAX_CHUNK_TILES * tile
    owner = torch.arange(S) // chunk            # the chunk of each slot
    assert int(owner.max()) == splits - 1
    assert torch.bincount(owner, minlength=splits).min() > 0
    if rb >= n_sm and S <= ops.DECODE_MAX_CHUNK_TILES * tile:
        assert splits == 1
    if rb < n_sm:   # about two waves, unless the tiles run out first
        assert splits * rb >= 2 * n_sm or splits == -(-S // tile)


def test_decode_split_at_the_serving_shapes():
    """On an H100's 132 SMs: phase 1 of the target verify and the drafter's
    draft split the 1024 slots, the drafter's prefill extend (T 511) and
    every phase 2 (S <= 6) do not. The batch-1 admission extend (T 511 or
    an exact 638, 12 KV heads) has 8-10 row tiles and still splits 4
    ways, in both phases."""
    for shape, want in (("target verify", (16, 64)),
                        ("drafter draft", (4, 320)),
                        ("drafter prefill extend", (1, 1024))):
        assert ops.decode_split(1024, _row_blocks(*_DECODE_SERVING[shape]),
                                132) == want
    assert ops.decode_split(6, _row_blocks(8, 6, 12, 2), 132) == (1, 64)
    for T, S, want in ((511, 1024, (4, 320)), (511, 511, (4, 128)),
                       (638, 638, (4, 192)), (255, 255, (4, 64))):
        rb = _row_blocks(1, T, 12, 12)
        assert rb // 12 > 1      # several row tiles per (b, KV head)
        assert ops.decode_split(S, rb, 132) == want


@pytest.mark.parametrize("shape", ["target verify", "drafter draft"])
def test_decode_chunks_merged_equal_one_pass(shape):
    """The plain decode run over each chunk decode_split chooses, its
    partials put in the kernel's scratch layout and merged by the plain
    copy of the combine pass (ref.decode_combine), equals one pass over all
    slots within 3e-5 in float32. The cache holds 576 live slots of 1024,
    so the last chunks hold no live key, and batch row 1 is empty, so its
    rows see no key (zeros, l 0, m NEG_INF)."""
    B, T, H, KV = _DECODE_SERVING[shape]
    S, hd, G = 1024, 64, H // KV
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_rand(rng, sh)) for sh in (
        (B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    kpos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    kpos = torch.where(kpos < 576, kpos, -1).to(torch.int32)
    kpos[1] = -1
    qpos = (576 + torch.arange(T, dtype=torch.int32))[None].repeat(B, 1)
    splits, chunk = ops.decode_split(S, _row_blocks(B, T, H, KV), 132)
    assert splits > 1
    po, pm, pl = [], [], []
    for c0 in range(0, S, chunk):
        o, m, l = ops.decode_attention_plain(
            q, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
            kpos[:, c0:c0 + chunk].contiguous(), qpos, scale=hd ** -0.5,
            return_stats=True)

        def rows(x):   # (B, KV, G, T) -> (B*KV, T*G), row r = t*G + g
            return x.permute(0, 1, 3, 2).reshape(B * KV, T * G)

        lr = rows(l)
        o = o.reshape(B, T, KV, G, hd).permute(0, 2, 1, 3, 4).reshape(
            B * KV, T * G, hd) * lr[..., None]          # unnormalised
        po.append(torch.where(lr[..., None] > 0, o, float("nan")))
        pm.append(rows(m))
        pl.append(lr)
    out, m, l = ref.decode_combine(torch.stack(po, 1), torch.stack(pm, 1),
                                   torch.stack(pl, 1), B, T, H, KV)
    want, wm, wl = ops.decode_attention_plain(q, k, v, kpos, qpos,
                                              scale=hd ** -0.5,
                                              return_stats=True)
    for got, exp in ((out, want), (m, wm), (l, wl)):
        torch.testing.assert_close(got, exp, atol=3e-5, rtol=3e-5)
    assert out[1].abs().max().item() == 0.0
    assert (l[1] == 0).all() and (m[1] == ref.NEG_INF).all()

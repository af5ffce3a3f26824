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

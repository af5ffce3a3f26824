"""``repro_torch.models.layers`` against the JAX package's
``models/layers.py`` on the same numpy inputs, in float32.

Tolerance 3e-5: both compute in float32, with reductions in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

TOL = 3e-5


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), atol=tol, rtol=tol)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("batched", [False, True])
def test_rope(theta, batched):
    """Half-split rotation at qwen2's theta too, at positions up to 1000."""
    rng = np.random.default_rng(1)
    hd = 64
    pos = rng.integers(0, 1000, (2, 7) if batched else (7,)).astype(np.int32)
    s, c = L.rope_sincos(torch.from_numpy(pos), hd, theta)
    js, jc = JL.rope_sincos(jnp.asarray(pos), hd, theta)
    _close(s, js, 1e-4)
    _close(c, jc, 1e-4)
    x = _rand(rng, 2, 7, 3, hd)
    _close(L.apply_rope(torch.from_numpy(x), s, c),
           JL.apply_rope(jnp.asarray(x), js, jc), 1e-4)


def test_mlp_swiglu():
    rng = np.random.default_rng(2)
    p = {"w_gate": _rand(rng, 16, 40), "w_up": _rand(rng, 16, 40),
         "w_down": _rand(rng, 40, 16)}
    x = _rand(rng, 2, 3, 16)
    _close(L.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), "swiglu"),
           JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), "swiglu"), 1e-4)
    with pytest.raises(NotImplementedError):
        L.mlp_apply({}, torch.from_numpy(x), "relu2")


@pytest.mark.parametrize("mask", ["none", "cache", "cache_window"])
@pytest.mark.parametrize("block_k", [512, 16])
def test_blocked_attention(mask, block_k):
    rng = np.random.default_rng(3)
    B, Sq, Skv, H, KV, hd = 2, 8, 48, 4, 2, 32
    q, k, v = _rand(rng, B, Sq, H, hd), _rand(rng, B, Skv, KV, hd), \
        _rand(rng, B, Skv, KV, hd)
    qpos = np.broadcast_to(np.arange(40, 48)[None], (B, Sq)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(Skv)[None], (B, Skv)).astype(np.int32)
    kpos = np.where(kpos < 30, kpos, -1).astype(np.int32)
    tm = jm = None
    if mask != "none":
        w = 16 if mask == "cache_window" else 0
        tm = L.cache_mask_fn(torch.from_numpy(qpos), torch.from_numpy(kpos), w)
        jm = JL.cache_mask_fn(jnp.asarray(qpos), jnp.asarray(kpos), w)
    to, tmx, tl = L.blocked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=hd ** -0.5, mask_fn=tm, block_k=block_k, return_stats=True)
    jo, jmx, jl = JL.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=hd ** -0.5,
        mask_fn=jm, block_k=block_k, return_stats=True)
    _close(to, jo)
    _close(tmx, jmx)
    _close(tl, jl)


def test_merge_attention_with_empty_side():
    """A side with l == 0 (no visible key) contributes nothing; rows where
    both sides are empty come out zero."""
    rng = np.random.default_rng(4)
    B, Sq, H, KV, hd = 2, 3, 4, 2, 32
    o1, o2 = _rand(rng, B, Sq, H, hd), _rand(rng, B, Sq, H, hd)
    m1, m2 = _rand(rng, B, KV, 2, Sq), _rand(rng, B, KV, 2, Sq)
    l1 = np.abs(_rand(rng, B, KV, 2, Sq))
    l2 = np.abs(_rand(rng, B, KV, 2, Sq))
    l1[0], m1[0] = 0.0, -1e30
    l2[1, 0], l1[1, 0], m1[1, 0], m2[1, 0] = 0.0, 0.0, -1e30, -1e30
    args = (o1, m1, l1, o2, m2, l2)
    out = L.merge_attention(*map(torch.from_numpy, args))
    _close(out, JL.merge_attention(*map(jnp.asarray, args)))
    assert out[1, :, :2].abs().max().item() == 0.0


@pytest.mark.parametrize("ring", [False, True])
def test_cache_update(ring):
    """Two inserts, the second rolling back part of the first (positions
    >= pos are invalidated first); ring caches wrap at pos % W."""
    rng = np.random.default_rng(5)
    B, W, KV, hd = 2, 8, 2, 32
    jc = JL.make_kv_cache(B, W, KV, hd, dtype=jnp.float32, ring=ring)
    tc = L.make_kv_cache(B, W, KV, hd, dtype=torch.float32, ring=ring,
                         device="cpu")
    for T, pos in ((5, np.array([0, 2], np.int32)),
                   (4, np.array([3, 6], np.int32) if ring
                    else np.array([3, 1], np.int32))):
        k, v = _rand(rng, B, T, KV, hd), _rand(rng, B, T, KV, hd)
        jc = JL.cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos))
        out = L.cache_update(tc, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos))
        assert out is tc                     # updated in place
        for name in ("k", "v", "positions"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))


def test_make_kv_cache_layout():
    c = L.make_kv_cache(3, 16, 2, 64, dtype=torch.bfloat16, device="cpu")
    assert c["k"].shape == (3, 16, 2, 64) and c["k"].dtype == torch.bfloat16
    assert c["positions"].dtype == torch.int32
    assert (c["positions"] == -1).all() and c["ring"] is False

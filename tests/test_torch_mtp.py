"""The port's MTP attention on the CPU, where it takes the kernel's plain
PyTorch version, held against the JAX package: the Pallas kernel (interpret
mode) and its jnp oracle on the ``tests/test_kernels.py`` sweep, and the
flash training attention (``core/flash_train.py``) forward and gradients
through ``jax.vjp``. Also the port's numpy copies (COD, masks, Algorithm 1)
against the originals. Inputs are made with numpy from a seed.

Tolerances: the kernel sweep's 3e-5 in float32 and 2e-2 in bfloat16 (both
sides accumulate in float32, in another order); forward 3e-5 and gradients
atol 2e-5, rtol 2e-4 for the flash training attention (tests/
test_flash_train.py's and tests/test_partition.py's). The numpy copies
must be bitwise equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cod as jcod
from repro.core import masks as jmasks
from repro.core import partition as jpartition
from repro.core.flash_train import mtp_flash_attention as jmtp_flash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import cod, masks, partition
from repro_torch.core.flash_train import MTPFlashAttention, mtp_flash_attention
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _meta(n, K, r, mult=64, seed=0):
    rng = np.random.default_rng(seed)
    pos, dep = cod.sample_cod(rng, n, K, r)
    M = int(np.ceil(len(pos) / mult) * mult)
    return cod.pad_to(pos, dep, M)


def _qkv(rng, B, M, H, KV, hd, scale=0.5):
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in ((B, M, H, hd), (B, M, KV, hd), (B, M, KV, hd))]


# ---------------------------------------------------------------------------
# MTP attention: plain version vs the Pallas kernel and its oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,K,r", [(48, 4, 0.7), (32, 8, 0.8), (24, 2, 0.5)])
@pytest.mark.parametrize("B,H,KV,hd", [(2, 4, 2, 64), (1, 2, 2, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mtp_plain_matches_jax(n, K, r, B, H, KV, hd, dtype):
    pos, dep = _meta(n, K, r)
    M = len(pos)
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(np.random.default_rng(1), B, M, H, KV, hd)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs)
    tpos, tdep = torch.from_numpy(pos), torch.from_numpy(dep)
    out = ops.mtp_attention(tq, tk, tv, tpos, tdep, scale=hd ** -0.5)
    assert out.dtype == tdt and out.shape == tq.shape
    want = jops.mtp_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(dep),
                              scale=hd ** -0.5, block_q=64, block_k=64)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)
    oracle = jref.mtp_attention_reference(jq, jk, jv, jnp.asarray(pos),
                                          jnp.asarray(dep), scale=hd ** -0.5)
    np.testing.assert_allclose(
        ref.mtp_reference(tq, tk, tv, tpos, tdep, scale=hd ** -0.5)
        .float().numpy(), np.asarray(oracle, np.float32), atol=tol, rtol=tol)


def test_mtp_padding_rows_zero():
    pos, dep = cod.sample_cod(np.random.default_rng(0), 16, 3, 0.6)
    m = len(pos)
    pos, dep = cod.pad_to(pos, dep, 64)
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(2), 1, 64, 2, 2, 32))
    out = ops.mtp_attention(q, k, v, torch.from_numpy(pos),
                            torch.from_numpy(dep), scale=1.0)
    assert out[:, m:].abs().max().item() == 0.0
    assert out[:, :m].abs().max().item() > 0.0


def test_mtp_stats_match_direct_computation():
    """(m, l) in (B, KV, G, M): the row max of the visible scores and the
    sum of exp(s - m); pad rows m = -1e30, l = 0."""
    B, H, KV, hd = 2, 4, 2, 32
    pos, dep = _meta(40, 4, 0.7)
    M = len(pos)
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(3), B, M, H, KV, hd))
    tpos, tdep = torch.from_numpy(pos), torch.from_numpy(dep)
    out, m, l = ops.mtp_attention(q, k, v, tpos, tdep, scale=hd ** -0.5,
                                  return_stats=True)
    assert m.shape == l.shape == (B, KV, H // KV, M)
    s = torch.einsum("bqkgd,bjkd->bkgqj", q.reshape(B, M, KV, H // KV, hd),
                     k) * hd ** -0.5
    ok = masks.mtp_mask_predicate(tdep, tpos, tdep, tpos)
    s = torch.where(ok, s, -1e30)
    want_m = s.amax(-1)
    want_l = torch.where(ok, torch.exp(s - want_m[..., None]), 0.0).sum(-1)
    pad = tdep < 0
    np.testing.assert_allclose(m[..., ~pad].numpy(), want_m[..., ~pad].numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), want_l.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert (m[..., pad] == -1e30).all() and (l[..., pad] == 0).all()


def test_mtp_dispatch_on_cpu_counts_no_launch():
    pos, dep = _meta(16, 2, 0.5)
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(np.random.default_rng(4), 1, len(pos), 2, 2, 32))
    before = dict(ops.launches)
    ops.mtp_attention(q, k, v, torch.from_numpy(pos), torch.from_numpy(dep),
                      scale=1.0)
    assert ops.launches == before


# ---------------------------------------------------------------------------
# flash training attention: forward and gradients vs the JAX custom VJP
# ---------------------------------------------------------------------------

def _flash_case(n, K, r, B, H, KV, hd, M=None, per_row=True):
    pos, dep = _meta(n, K, r)
    if M is not None:
        pos, dep = cod.pad_to(pos[pos >= 0], dep[dep >= 0], M)
    M = len(pos)
    rng = np.random.default_rng(5)
    arrs = _qkv(rng, B, M, H, KV, hd, scale=0.3)
    if per_row:   # a different layout per row: row b rolls its own COD draw
        rows = [_meta(n, K, r, seed=10 + b) for b in range(B)]
        pos = np.stack([cod.pad_to(p[p >= 0], d[d >= 0], M)[0] for p, d in rows])
        dep = np.stack([cod.pad_to(p[p >= 0], d[d >= 0], M)[1] for p, d in rows])
    else:
        pos, dep = np.broadcast_to(pos, (B, M)), np.broadcast_to(dep, (B, M))
    cot = (0.5 * rng.standard_normal((B, M, H, hd))).astype(np.float32)
    return arrs, np.ascontiguousarray(pos), np.ascontiguousarray(dep), cot


def _port_vjp(arrs, pos, dep, cot, hd, block_k):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs)
    out = mtp_flash_attention(q, k, v, torch.from_numpy(pos),
                              torch.from_numpy(dep), scale=hd ** -0.5,
                              block_k=block_k)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_vjp(arrs, pos, dep, cot, hd, block_k):
    jp, jd = jnp.asarray(pos), jnp.asarray(dep)
    out, vjp = jax.vjp(lambda q, k, v: jmtp_flash(q, k, v, jp, jd,
                                                  scale=hd ** -0.5,
                                                  block_k=block_k),
                       *(jnp.asarray(a) for a in arrs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("case", [
    # (n, K, r, B, H, KV, hd, M, block_k)
    (48, 4, 0.7, 2, 4, 2, 32, None, 64),       # GQA, per-row layouts
    (24, 3, 0.6, 1, 2, 1, 64, None, 64),
    (200, 4, 0.8, 1, 2, 2, 32, 600, 512),      # M = 600: the port walks 512 +
                                                # 88 keys, JAX a 300-key divisor
    (160, 4, 0.7, 1, 2, 1, 32, 541, 128),      # M prime: JAX walks 1-key blocks
])
def test_flash_train_matches_jax(case):
    n, K, r, B, H, KV, hd, M, bk = case
    arrs, pos, dep, cot = _flash_case(n, K, r, B, H, KV, hd, M=M)
    assert M is None or M % bk
    out, grads = _port_vjp(arrs, pos, dep, cot, hd, bk)
    jout, jgrads = _jax_vjp(arrs, pos, dep, cot, hd, bk)
    np.testing.assert_allclose(out, jout, atol=3e-5, rtol=3e-5)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=2e-5, rtol=2e-4,
                                   err_msg=f"d{name}")


def test_flash_train_gradients_match_autograd_through_plain():
    """The recompute-by-block backward against autograd through the plain
    blocked attention (what the CPU takes for M < 512), pad rows included."""
    hd = 32
    arrs, pos, dep, cot = _flash_case(48, 4, 0.7, 2, 4, 2, hd, M=256)
    out, grads = _port_vjp(arrs, pos, dep, cot, hd, 64)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs)
    want = ops.mtp_attention_plain(q, k, v, torch.from_numpy(pos),
                                   torch.from_numpy(dep), scale=hd ** -0.5)
    wgrads = torch.autograd.grad(want, (q, k, v), torch.from_numpy(cot))
    np.testing.assert_allclose(out, want.detach().numpy(), atol=3e-6)
    for name, g, w in zip("qkv", grads, wgrads):
        np.testing.assert_allclose(g, w.numpy(), atol=2e-5, rtol=2e-4,
                                   err_msg=f"d{name}")
    assert np.all(grads[0][dep < 0] == 0)        # pad rows get no gradient


def test_flash_train_saves_stats_not_probabilities():
    arrs, pos, dep, _ = _flash_case(24, 3, 0.6, 1, 2, 1, 32)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs)
    out = MTPFlashAttention.apply(q, k, v, torch.from_numpy(pos),
                                  torch.from_numpy(dep), 32 ** -0.5, 64)
    saved = out.grad_fn.saved_tensors
    M = q.shape[1]
    assert len(saved) == 8
    assert all(t.numel() <= q.numel() for t in saved)   # nothing O(M^2)
    assert saved[6].shape == (1, 1, 2, M)               # m in (B, KV, G, M)


# ---------------------------------------------------------------------------
# numpy copies: bitwise equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,K,r", [(48, 4, 0.7), (32, 8, 0.8), (5, 4, 0.9),
                                   (2048, 8, 0.8)])
def test_cod_copy_is_bitwise(n, K, r):
    np.testing.assert_array_equal(cod.depth_counts(n, K, r),
                                  jcod.depth_counts(n, K, r))
    assert cod.expanded_length(n, K, r) == jcod.expanded_length(n, K, r)
    for seed in range(3):
        got = cod.sample_cod(np.random.default_rng(seed), n, K, r)
        want = jcod.sample_cod(np.random.default_rng(seed), n, K, r)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    M = cod.expanded_length(n, K, r) + 7
    for a, b in zip(cod.pad_to(*got, M), jcod.pad_to(*want, M)):
        np.testing.assert_array_equal(a, b)


def test_masks_copy_is_bitwise():
    pos, dep = _meta(24, 3, 0.7)
    K = 3
    full = masks.precompute_full_mask(24, K)
    np.testing.assert_array_equal(full, jmasks.precompute_full_mask(24, K))
    real = dep >= 0
    p, d = pos[real], dep[real]
    np.testing.assert_array_equal(masks.extract_mask(full, p, d, K),
                                  jmasks.extract_mask(full, p, d, K))
    np.testing.assert_array_equal(masks.pard_style_mask(pos, dep),
                                  jmasks.pard_style_mask(pos, dep))
    np.testing.assert_array_equal(masks.pard_style_mask(p, d),
                                  masks.extract_mask(full, p, d, K))
    np.testing.assert_array_equal(masks.sort_by_layout(pos, dep, K),
                                  jmasks.sort_by_layout(pos, dep, K))
    row = np.arange(24, dtype=np.int32) * 3
    np.testing.assert_array_equal(masks.labels_for(pos, row),
                                  jmasks.labels_for(pos, row))
    want = jmasks.mtp_mask_predicate(dep, pos, dep, pos)
    np.testing.assert_array_equal(masks.mtp_mask_predicate(dep, pos, dep, pos),
                                  want)
    t = masks.mtp_mask_predicate(*(torch.from_numpy(a)
                                   for a in (dep, pos, dep, pos)))
    np.testing.assert_array_equal(t.numpy(), want)
    # per-row (B, M) metadata gives one mask per row
    b2 = [np.stack([a, a]) for a in (dep, pos)]
    np.testing.assert_array_equal(
        masks.mtp_mask_predicate(b2[0], b2[1], b2[0], b2[1]),
        np.stack([want, want]))


@pytest.mark.parametrize("n,K,r,S", [(48, 4, 0.7, 3), (64, 6, 0.8, 4),
                                     (24, 3, 0.6, 2)])
def test_partition_copy_is_bitwise(n, K, r, S):
    pos, dep = cod.sample_cod(np.random.default_rng(n + S), n, K, r)
    np.testing.assert_array_equal(partition.assign_segments(pos, dep, n, S),
                                  jpartition.assign_segments(pos, dep, n, S))
    segs = partition.build_segments(pos, dep, n, S)
    jsegs = jpartition.build_segments(pos, dep, n, S)
    assert len(segs) == len(jsegs)
    for a, b in zip(segs, jsegs):
        for f in ("q_pos", "q_depth", "kv_pos", "kv_depth", "q_in_kv"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert partition.check_dependencies_preserved(segs, pos, dep)

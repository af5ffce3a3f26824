"""The port's MTP attention on the CPU, where it takes the kernel's plain
PyTorch version, held against the JAX package: the Pallas kernel (interpret
mode) and its jnp oracle on the ``tests/test_kernels.py`` sweep, and the
flash training attention (``core/flash_train.py``) forward and gradients
through ``jax.vjp``; the CUDA kernel's depth-split key walk, in plain
PyTorch (``mtp_two_pass`` below, over ``ops.mtp_key_lists``), against the
Pallas kernel on COD, segment, permuted and padded layouts. Also the port's
numpy copies (COD, masks, Algorithm 1) against the originals. Inputs are
made with numpy from a seed.

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
from repro_torch.models.layers import blocked_attention, merge_attention
import torch_threads  # noqa: F401  (torch threads per xdist worker)

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


def _walk_layout(kind, seed=0):
    """(pos, depth), (M,) int32 with M a multiple of 64: "cod" a COD layout,
    "segment" the largest Algorithm-1 segment of n 96 in 3 (its depth-0
    context, then an interleaved block), "permuted" a padded COD layout in
    random order, "pad rows" a short COD layout in mostly pad rows."""
    rng = np.random.default_rng(seed)
    if kind == "segment":
        p, d = cod.sample_cod(rng, 96, 6, 0.8)
        seg = max(partition.build_segments(p, d, 96, 3),
                  key=lambda sg: len(sg.kv_pos))
        p, d = seg.kv_pos, seg.kv_depth
    elif kind == "pad rows":
        p, d = cod.sample_cod(rng, 16, 3, 0.6)
    else:
        p, d = cod.sample_cod(rng, 48, 6, 0.8)
    p, d = cod.pad_to(p, d, int(np.ceil(len(p) / 64) * 64))
    if kind == "permuted":
        perm = rng.permutation(len(p))
        p, d = p[perm], d[perm]
    return p, d


@pytest.mark.parametrize("kind", ["cod", "segment", "permuted", "pad rows"])
def test_mtp_key_lists_order_the_keys(kind):
    """The kernel's index lists: list 0 begins with the depth-0 keys by
    position, list 1 with the depth >= 1 keys by anchor, ties in index
    order; sort keys and counts beside them."""
    rows = [_walk_layout(kind, seed=s) for s in range(2)]
    pos = torch.from_numpy(np.stack([p for p, _ in rows]))
    dep = torch.from_numpy(np.stack([d for _, d in rows]))
    order, okey, counts = ops.mtp_key_lists(pos, dep)
    assert okey.dtype == counts.dtype == torch.int32
    assert order.shape == okey.shape == (2, 2, len(rows[0][0]))
    for b, (p, d) in enumerate(rows):
        for i, (member, key) in enumerate(((d == 0, p), (d > 0, p - d))):
            idx = np.nonzero(member)[0]
            want = idx[np.argsort(key[idx], kind="stable")]
            assert int(counts[b, i]) == len(idx)
            np.testing.assert_array_equal(order[b, i, :len(idx)], want)
            np.testing.assert_array_equal(okey[b, i, :len(idx)], key[want])
            np.testing.assert_array_equal(okey[b, i, len(idx):],
                                          ops.INT32_MAX)


def mtp_two_pass(q, k, v, pos, depth, *, scale, rows=64):
    """The MTP kernel's depth-split key walk (``csrc/mtp_tc.cuh``) in plain
    PyTorch: q (B,M,H,hd), k/v (B,M,KV,hd), per-row int32 pos/depth (B,M).
    The queries of each row go in blocks of ``rows // G`` (the kernel's
    blocks of ``rows`` (query, head) rows when G divides it). A block with
    a real query takes, from the index lists of ``ops.mtp_key_lists``, the
    context pass (the depth-0 entries whose position is <= the block's
    largest anchor) and the chain pass (the depth >= 1 entries whose anchor
    lies within the block's smallest and largest anchor), each an online
    softmax with (m, l) under the closed-form predicate, and merges the two
    by (m, l) (``layers.merge_attention``). Returns out and the f32 (m, l),
    each (B, KV, G, M), as ``ops.mtp_attention_plain`` does."""
    B, M, H, hd = q.shape
    G = H // k.shape[2]
    order, okey, counts = ops.mtp_key_lists(pos, depth)
    out = torch.zeros_like(q)
    m = torch.full((B, k.shape[2], G, M), ref.NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    nq = max(1, rows // G)
    for b in range(B):
        nc, nch = (int(x) for x in counts[b])
        ctx_keys, chain_keys = okey[b, 0, :nc], okey[b, 1, :nch]
        for t0 in range(0, M, nq):
            t1 = min(t0 + nq, M)
            qd, qp = depth[b, t0:t1], pos[b, t0:t1]
            real = qd >= 0
            if not real.any():
                continue
            anchors = (qp - qd)[real]
            lo, hi = anchors.min().reshape(1), anchors.max().reshape(1)
            n1 = int(torch.searchsorted(ctx_keys, hi, right=True))
            c2 = int(torch.searchsorted(chain_keys, lo))
            e2 = int(torch.searchsorted(chain_keys, hi, right=True))
            passes = []
            for idx in (order[b, 0, :n1], order[b, 1, c2:e2]):
                kd, kp = depth[b, idx], pos[b, idx]

                def mask(qi, ki, kd=kd, kp=kp):
                    return masks.mtp_mask_predicate(
                        qd[qi], qp[qi], kd[ki], kp[ki])[None, None, None]
                passes.append(blocked_attention(
                    q[b:b + 1, t0:t1], k[b:b + 1, idx], v[b:b + 1, idx],
                    scale=scale, mask_fn=mask, return_stats=True))
            (o1, m1, l1), (o2, m2, l2) = passes
            out[b, t0:t1] = merge_attention(o1, m1, l1, o2, m2, l2)[0]
            mm = torch.maximum(m1, m2)
            m[b, ..., t0:t1] = mm[0]
            l[b, ..., t0:t1] = (l1 * torch.exp(m1 - mm)
                                + l2 * torch.exp(m2 - mm))[0]
    return out, m, l


@pytest.mark.parametrize("kind", ["cod", "segment", "permuted", "pad rows"])
@pytest.mark.parametrize("B,H,KV,hd,rows", [(2, 4, 2, 32, 64),
                                            (1, 2, 2, 64, 16)])
def test_mtp_two_pass_matches_jax_kernel(kind, B, H, KV, hd, rows):
    """The depth-split walk the CUDA kernel runs (context pass and chain
    pass over the index list, merged by (m, l)), in plain PyTorch, against
    the Pallas kernel in interpret mode and, with its stats, against the
    plain version: float32, 3e-5."""
    pos, dep = _walk_layout(kind)
    M = len(pos)
    arrs = _qkv(np.random.default_rng(6), B, M, H, KV, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    tpos = torch.from_numpy(np.stack([pos] * B))
    tdep = torch.from_numpy(np.stack([dep] * B))
    out, m, l = mtp_two_pass(tq, tk, tv, tpos, tdep, scale=hd ** -0.5,
                                 rows=rows)
    want = jops.mtp_attention(*(jnp.asarray(a) for a in arrs),
                              jnp.asarray(pos), jnp.asarray(dep),
                              scale=hd ** -0.5, block_q=64, block_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)
    _, pm, pl = ops.mtp_attention_plain(tq, tk, tv, tpos, tdep,
                                        scale=hd ** -0.5, return_stats=True)
    np.testing.assert_allclose(m.numpy(), pm.numpy(), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(l.numpy(), pl.numpy(), atol=3e-5, rtol=3e-5)
    assert out[:, dep < 0].abs().max().item() == 0.0


def test_mtp_walk_scores_little_beyond_the_visible_pairs():
    """Why the kernel walks index lists: at the training shape (n 2048,
    K 8, r 0.8) the tiles its 64-row blocks walk (the context prefix up to
    the block's largest anchor, the chain range of its anchors, 32 keys a
    tile) cover at most 1.15 (query, key) pairs per visible pair, where
    walking every 32-key tile of the layout up to the block's largest
    position covers over 4."""
    pos, dep = cod.sample_cod(np.random.default_rng(0), 2048, 8, 0.8)
    M, rows, tile = len(pos), 64, 32
    tpos, tdep = torch.from_numpy(pos), torch.from_numpy(dep)
    visible = sum(int(masks.mtp_mask_predicate(tdep[i:i + 1024],
                                               tpos[i:i + 1024], tdep,
                                               tpos).sum())
                  for i in range(0, M, 1024))
    order, okey, counts = ops.mtp_key_lists(tpos[None], tdep[None])
    nc, nch = (int(x) for x in counts[0])
    ctx, chain = okey[0, 0, :nc].numpy(), okey[0, 1, :nch].numpy()
    walk = every = 0
    for r0 in range(0, M, rows):
        a = pos[r0:r0 + rows] - dep[r0:r0 + rows]
        n1 = np.searchsorted(ctx, a.max(), "right")
        n2 = (np.searchsorted(chain, a.max(), "right")
              - np.searchsorted(chain, a.min()))
        walk += rows * tile * (-(-n1 // tile) + -(-n2 // tile))
        last = np.nonzero(pos <= pos[r0:r0 + rows].max())[0].max()
        every += rows * tile * (last // tile + 1)
    assert walk <= 1.15 * visible
    assert every >= 4 * visible


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

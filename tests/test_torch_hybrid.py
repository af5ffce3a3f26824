"""The hybrid family in the port against the JAX package, on the CPU in
float32: recurrentgemma-2b ``reduced()`` cut to 5 layers (one super-block
of (recurrent, recurrent, attention) and a tail of 2 recurrent layers;
``reduced()`` alone keeps 2 recurrent layers and no attention) and to 7
(a second super-block, which checks the unstacking order of
``convert.py``): d 256, lru_width 256, 4/1 heads of 32, window 64, with a
1-layer attention drafter; weights converted from the JAX package's,
inputs made with numpy from a seed. Tolerance 3e-5 (float32 on both sides,
sums in another order); tokens, events and counters equal.

The attention layers' rings hold ``window + K + 1`` slots in the port; at
max_len 128 the reference here is the JAX package over full-length
windowed caches (its ``make_cache`` patched in the test to ``ring=False``
at ``max_len``; the window mask is unchanged), since its own ring of
``window`` slots can lose an in-window key after a rejected draft. At
max_len 64 (not above window + K + 1) neither package has a ring: the
attention caches are paged pools beside the per-slot recurrent rows.

Covered: the forward in train, prefill and decode modes (logits, taps,
the conv, h and KV leaves, a 61-token prompt for the log-depth scan), the
verify's snapshots and ``cache_ops.commit`` at each accept index, the
bfloat16 ``h`` snapshot rounded through the activation dtype as the
reference's, ``Engine.run`` in the three drafter modes past the window,
a paged ``Scheduler.serve`` with preemption to the host against the JAX
scheduler, chunked admission of ragged prompts, a lossless sampled swap
resume, the idle prefix cache over two passes, and a seeded sampled
stream."""
import contextlib
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.models import get_model as jget_model
from repro.models import hybrid as JH
from repro.models import layers as JL
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import cache_ops as jcache_ops
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.models import hybrid
from repro_torch.models.registry import get_model
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.margins import MarginLog
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ARCH = "recurrentgemma-2b"
TOL = 3e-5
NEAR_TIE = 1e-4
# K 2: rings of 64 + 3 slots at max_len 128; none at max_len 64
K, PAGE, RING_LEN, POOL_LEN = 2, 8, 128, 64


def _cfg(get, n_layers):
    return get(ARCH).reduced().replace(n_layers=n_layers)


@lru_cache(maxsize=None)
def models(n_layers=5):
    """((jcfg, jdcfg, jparams, jdparams), (tcfg, dcfg, tparams, dparams)):
    the reduced config cut to ``n_layers`` and a 1-layer drafter, on both
    sides."""
    jcfg, tcfg = _cfg(jget_config, n_layers), _cfg(get_config, n_layers)
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(23))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(24))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    return (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp)


@contextlib.contextmanager
def full_length_caches():
    """The JAX package's hybrid caches at full length: every attention
    layer's cache is ``max_len`` slots, ``ring=False``; its window mask is
    unchanged. (Patched for the test only; the package is not changed.)"""
    make_cache, make_kv = JH.make_cache, JL.make_kv_cache

    def patched(cfg, batch, max_len, dtype=jnp.bfloat16):
        with pytest.MonkeyPatch.context() as inner:
            inner.setattr(JL, "make_kv_cache",
                          lambda b, ln, kv, hd, dtype=jnp.bfloat16, ring=False:
                          make_kv(b, max_len, kv, hd, dtype=dtype, ring=False))
            return make_cache(cfg, batch, max_len, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JH, "make_cache", patched)
        yield


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=tol, err_msg=msg)


def _same_layers(tblocks, jtree, cfg, msg=""):
    """Port layers against a JAX hybrid tree (a cache or snapshots) in the
    port's layout: every leaf, and None where the JAX tree has none."""
    want = convert.target_cache(jax.tree.map(np.asarray, jtree), cfg)
    assert len(tblocks) == len(want["blocks"]) == cfg.n_layers
    for li, (t, w) in enumerate(zip(tblocks, want["blocks"])):
        assert (t is None) == (w is None), (msg, li)
        for name in (w or {}):
            if name == "ring":
                assert t[name] == w[name], (msg, li)
            elif name == "positions":
                np.testing.assert_array_equal(t[name], w[name],
                                              err_msg=f"{msg} layer {li}")
            else:
                _close(t[name], w[name], msg=f"{msg} layer {li} {name}")


# ---------------------------------------------------------------------------
# the config and the model
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    """The port's copy equals the JAX package's config field by field, at
    full width and reduced; the slot kinds cycle (recurrent, recurrent,
    attention) through the tail; the drafter resolves to 4 layers of d
    2560 with 20 heads of 128."""
    for reduced in (False, True):
        j, t = jget_config(ARCH), get_config(ARCH)
        if reduced:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = get_config(ARCH)
    kinds = [hybrid.slot_kind(cfg, li) for li in range(cfg.n_layers)]
    assert kinds.count("attention") == 8 and kinds[-2:] == ["recurrent"] * 2
    assert kinds[:3] == ["recurrent", "recurrent", "attention"]
    d = DrafterConfig().resolve(cfg)
    assert (d.n_layers, d.d_model, d.n_heads, d.head_dim) == (4, 2560, 20, 128)


@lru_cache(maxsize=None)
def reference_forward(n_layers):
    """The JAX forward at ``n_layers``: train over 61 tokens, a prefill of
    them into a max_len-64 cache, then a 3-token decode block (which
    builds the per-token snapshots) from that cache, and its commit at
    accept indices (2, 0, 1). Returns the inputs and the outputs as numpy
    trees."""
    (jcfg, _, jp, _), _ = models(n_layers)
    rng = np.random.default_rng(1)
    B, P, T = 3, 61, 3
    toks = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    blk = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(P + np.arange(T), (B, T)).astype(np.int32)
    accept = np.array([2, 0, 1], np.int32)
    jm = jget_model(jcfg)
    tr = jm.forward(jp, jnp.asarray(toks), mode="train")
    pf = jm.forward(jp, jnp.asarray(toks), mode="prefill",
                    cache=jm.make_cache(B, POOL_LEN, dtype=jnp.float32))
    dec = jm.forward(jp, jnp.asarray(blk), mode="decode",
                     positions=jnp.asarray(pos), cache=pf.cache)
    committed = jcache_ops.commit(dec.cache, dec.aux["snapshots"],
                                  jnp.asarray(P - 1 + 1 + accept),
                                  jnp.asarray(accept))
    out = dict(train=(tr.logits, tr.taps), prefill=(pf.logits, pf.cache),
               decode=(dec.logits, dec.taps, dec.cache,
                       dec.aux["snapshots"]), commit=committed)
    return (toks, blk, pos, accept), jax.tree.map(np.asarray, out)


def _prefilled(n_layers):
    """The port's prefill of the reference's prompts into a fresh cache."""
    (toks, _, _, _), _ = reference_forward(n_layers)
    tcfg = models(n_layers)[1][0]
    model = get_model(tcfg)
    tc = model.make_cache(toks.shape[0], POOL_LEN, dtype=torch.float32,
                          device="cpu")
    out = model.forward(models(n_layers)[1][2], torch.from_numpy(toks),
                        mode="prefill", cache=tc)
    return model, tc, out


@pytest.mark.parametrize("n_layers", [5, 7])
def test_forward_train_prefill_decode_match_reference(n_layers):
    """Train-mode logits and taps over 61 tokens (the log-depth scan over a
    length that is not a power of two); a prefill's logits and every cache
    leaf (conv and h per recurrent layer, K/V and positions per attention
    layer); a decode block's logits, taps and leaves, with no snapshot
    built. Converted weights keep the norms and lam in float32."""
    (toks, blk, pos, _), ref = reference_forward(n_layers)
    (_, _, _, _), (tcfg, _, tp, _) = models(n_layers)
    model = get_model(tcfg)
    assert model.recurrent
    to = model.forward(tp, torch.from_numpy(toks), mode="train")
    _close(to.logits, ref["train"][0])
    _close(to.taps, ref["train"][1])
    assert all(bp["rec"]["lam"].dtype == torch.float32 and
               bp["ln1"].dtype == torch.float32
               for bp in tp["blocks"] if "rec" in bp)
    assert ["attn" in bp for bp in tp["blocks"]] == [
        hybrid.slot_kind(tcfg, li) == "attention"
        for li in range(n_layers)]

    model, tc, out = _prefilled(n_layers)
    _close(out.logits, ref["prefill"][0])
    _same_layers(tc["blocks"], ref["prefill"][1], tcfg, "prefill")
    assert not any(c.get("ring", False) for c in tc["blocks"])
    out = model.forward(tp, torch.from_numpy(blk), mode="decode",
                        positions=torch.from_numpy(pos), cache=tc)
    _close(out.logits, ref["decode"][0])
    _close(out.taps, ref["decode"][1])
    _same_layers(tc["blocks"], ref["decode"][2], tcfg, "decode")
    assert out.aux["snapshots"] is None


@pytest.mark.parametrize("n_layers", [5, 7])
def test_verify_snapshots_and_commit_match_reference(n_layers):
    """The same block as a verify: each token's conv and h snapshots (None
    for attention layers) equal the JAX forward's, the recurrent leaves
    stay for the commit while the attention layers insert the block; then
    ``cache_ops.commit`` at accept indices 2, 0, 1 (one row each) rolls
    every leaf back as the JAX package's ``commit`` does (snapshot
    selection, attention positions invalidated past the accepted token);
    a row whose index is negative keeps its recurrent leaves."""
    (_, blk, pos, accept), ref = reference_forward(n_layers)
    tcfg, tp = models(n_layers)[1][0], models(n_layers)[1][2]
    model, tc, _ = _prefilled(n_layers)
    before = {li: {n: c[n].clone() for n in ("conv", "h")}
              for li, c in enumerate(tc["blocks"]) if "h" in c}
    out = model.forward(tp, torch.from_numpy(blk), mode="decode",
                        positions=torch.from_numpy(pos), cache=tc,
                        snapshots=True)
    _close(out.logits, ref["decode"][0])
    snaps = out.aux["snapshots"]["blocks"]
    _same_layers(snaps, ref["decode"][3], tcfg, "snapshots")
    B, T = blk.shape
    W, cw = tcfg.hybrid.lru_width, tcfg.hybrid.conv_width
    assert snaps[0]["h"].shape == (B, T, W)
    assert snaps[0]["conv"].shape == (B, T, cw - 1, W)
    for li, leaves in before.items():
        for n, v in leaves.items():
            assert torch.equal(tc["blocks"][li][n], v), (li, n)
    kept = {li: {n: c[n].clone() for n in ("conv", "h")}
            for li, c in enumerate(tc["blocks"]) if "h" in c}

    commit_pos = torch.from_numpy(pos[:, 0] + accept)
    masked = torch.from_numpy(np.where(np.arange(B) == 1, -1, accept))
    cache_ops.commit(tc, commit_pos, snapshots=out.aux["snapshots"],
                     accept_idx=masked)
    for li, leaves in kept.items():       # row 1 masked: its leaves stay
        for n, v in leaves.items():
            assert torch.equal(tc["blocks"][li][n][1], v[1]), (li, n)
    cache_ops.commit(tc, commit_pos, snapshots=out.aux["snapshots"],
                     accept_idx=torch.from_numpy(accept))
    _same_layers(tc["blocks"], ref["commit"], tcfg, "commit")


def test_bfloat16_h_snapshot_rounds_through_the_activation_dtype():
    """The reference's verify snapshot of h is the state rounded to the
    activation dtype, then float32, while the state a prefill or a decode
    chunk leaves stays float32. In bfloat16 the port copies it: every
    snapshot is bfloat16-representable and equals the JAX snapshot; the
    last token's snapshot is the rounded float32 state that the same
    block leaves without snapshots; a commit writes the rounded state.
    (One super-block, no tail.)"""
    jcfg = _cfg(jget_config, 3).replace(dtype="bfloat16")
    tcfg = _cfg(get_config, 3).replace(dtype="bfloat16")
    jp = jget_model(jcfg).init(jax.random.PRNGKey(23))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    assert tp["blocks"][0]["rec"]["lam"].dtype == torch.float32
    rng = np.random.default_rng(9)
    B, P, T = 2, 20, 3
    toks = rng.integers(0, 1000, (B, P)).astype(np.int32)
    blk = rng.integers(0, 1000, (B, T)).astype(np.int32)
    pos = np.broadcast_to(P + np.arange(T), (B, T)).astype(np.int32)
    jm, model = jget_model(jcfg), get_model(tcfg)
    jc = jm.forward(jp, jnp.asarray(toks), mode="prefill",
                    cache=jm.make_cache(B, POOL_LEN)).cache
    jd = jm.forward(jp, jnp.asarray(blk), mode="decode",
                    positions=jnp.asarray(pos), cache=jc)
    jsnap = convert.target_cache(jax.tree.map(np.asarray,
                                              jd.aux["snapshots"]), tcfg)
    jstate = convert.target_cache(jax.tree.map(np.asarray, jd.cache), tcfg)

    tc = model.make_cache(B, POOL_LEN, device="cpu")
    model.forward(tp, torch.from_numpy(toks), mode="prefill", cache=tc)
    saved = [{k: v.clone() for k, v in c.items() if k != "ring"}
             for c in tc["blocks"]]
    out = model.forward(tp, torch.from_numpy(blk), mode="decode",
                        positions=torch.from_numpy(pos), cache=tc,
                        snapshots=True)
    snaps = out.aux["snapshots"]["blocks"]
    for c, s in zip(tc["blocks"], saved):            # back to the prefill
        for k, v in s.items():
            c[k].copy_(v)
    model.forward(tp, torch.from_numpy(blk), mode="decode",
                  positions=torch.from_numpy(pos), cache=tc)
    rec = [li for li, c in enumerate(tc["blocks"]) if "h" in c]
    for li in rec:
        h, jh = snaps[li]["h"], jsnap["blocks"][li]["h"]
        assert h.dtype == jh.dtype == torch.float32
        assert torch.equal(h, h.to(torch.bfloat16).float()), li
        assert torch.equal(jh, jh.to(torch.bfloat16).float()), li
        if li == 0:     # deeper, two orders of bfloat16 rounding add up
            _close(h, jh, tol=2e-2, msg="layer 0 h snapshot")
        state = tc["blocks"][li]["h"]
        jstate_h = jstate["blocks"][li]["h"]
        assert not torch.equal(jstate_h, jstate_h.to(torch.bfloat16).float())
        assert not torch.equal(state, state.to(torch.bfloat16).float())
        assert torch.equal(h[:, -1], state.to(torch.bfloat16).float()), li
    cache_ops.commit(tc, torch.from_numpy(pos[:, -1]),
                     snapshots=out.aux["snapshots"],
                     accept_idx=torch.full((B,), T - 1, dtype=torch.int32))
    for li in rec:
        assert torch.equal(tc["blocks"][li]["h"], snaps[li]["h"][:, -1])


def test_reference_ring_loses_an_in_window_key():
    """Pin of the JAX package's fault the port departs from: the hybrid's
    ``make_cache`` gives a local layer a ring of ``min(window, max_len)``
    slots. Window 64, max_len 128, a 70-token prompt, then a verify block
    at 70-72 whose drafts are both rejected (commit at 70): the JAX ring
    of 64 slots has lost key 8 to the rejected draft at 72, though the
    next query at 71 sees keys 8-71, and its logits there part from those
    over full-length caches; the port's ring of 64 + 3 slots keeps every
    in-window key, and its logits equal the full-length reference's. (One
    super-block, no tail: the attention layer is layer 2.)"""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models(3)
    rng = np.random.default_rng(11)
    P = 70
    toks = rng.integers(0, 1000, (1, P)).astype(np.int32)
    blk = rng.integers(0, 1000, (1, K + 1)).astype(np.int32)
    nxt = rng.integers(0, 1000, (1, 1)).astype(np.int32)
    pos = (P + np.arange(K + 1, dtype=np.int32))[None]
    jm, model = jget_model(jcfg), get_model(tcfg)

    def reference(cache):
        c = jm.forward(jp, jnp.asarray(toks), mode="prefill",
                       cache=cache).cache
        d = jm.forward(jp, jnp.asarray(blk), mode="decode",
                       positions=jnp.asarray(pos), cache=c)
        c = jcache_ops.commit(d.cache, d.aux["snapshots"],
                              jnp.asarray([P]), jnp.asarray([0]))
        o = jm.forward(jp, jnp.asarray(nxt), mode="decode",
                       positions=jnp.asarray([[P + 1]]), cache=c)
        return np.asarray(c["blocks"]["slot2"]["positions"])[0, 0], \
            np.asarray(o.logits)

    jpos, ring_logits = reference(jm.make_cache(1, RING_LEN,
                                                dtype=jnp.float32))
    with full_length_caches():
        _, full_logits = reference(jm.make_cache(1, RING_LEN,
                                                 dtype=jnp.float32))
    tc = model.make_cache(1, RING_LEN, dtype=torch.float32, device="cpu",
                          block=K + 1)
    model.forward(tp, torch.from_numpy(toks), mode="prefill", cache=tc)
    out = model.forward(tp, torch.from_numpy(blk), mode="decode",
                        positions=torch.from_numpy(pos), cache=tc,
                        snapshots=True)
    cache_ops.commit(tc, torch.tensor([P], dtype=torch.int32),
                     snapshots=out.aux["snapshots"],
                     accept_idx=torch.tensor([0], dtype=torch.int32))
    tpos = set(tc["blocks"][2]["positions"][0].tolist())
    window = set(range(P + 1 - 64 + 1, P + 1))        # keys 8..70 of q 71
    assert len(jpos) == 64 and tc["blocks"][2]["k"].shape[1] == 64 + K + 1
    assert 8 not in set(jpos.tolist()) and window <= tpos
    got = model.forward(tp, torch.from_numpy(nxt), mode="decode",
                        positions=torch.tensor([[P + 1]], dtype=torch.int32),
                        cache=tc).logits
    _close(got, full_logits)
    assert np.abs(ring_logits - full_logits).max() > 1e-3


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _ecfg(**kw):
    base = dict(K=K, max_new_tokens=60, drafter_mode="parallel",
                max_len=RING_LEN, page_size=PAGE)
    base.update(kw)
    if base["drafter_mode"] == "none":
        base["K"] = 0
    return base


def _engine(batch=2, **kw):
    _, (tcfg, dcfg, tp, dp) = models()
    cfg = _ecfg(**kw)
    use_d = cfg["drafter_mode"] != "none"
    return Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                  EngineConfig(**cfg), batch, device="cpu")


def _jengine(batch=2, **kw):
    (jcfg, jdcfg, jp, jdp), _ = models()
    cfg = _ecfg(**kw)
    use_d = cfg["drafter_mode"] != "none"
    if "sampling" in kw:
        cfg["sampling"] = JSamplingParams(**dataclasses.asdict(kw["sampling"]))
    return JEngine(jcfg, jdcfg if use_d else None, jp,
                   jdp if use_d else None, JEngineConfig(**cfg), batch)


@lru_cache(maxsize=None)
def engine_run(mode):
    prompts = np.random.default_rng(5).integers(
        1, 1000, (2, 30)).astype(np.int32)
    with full_length_caches():
        jr = _jengine(drafter_mode=mode).run(jnp.asarray(prompts))
    te = _engine(drafter_mode=mode)
    return jr, te.run(prompts), te


@pytest.mark.parametrize("mode", ["parallel", "ar", "none"])
def test_engine_run_matches_jax_engine(mode):
    """Greedy Engine.run (30-token prompts, 60 new tokens: the rows run
    past the 64 window, over rings of 67 slots): tokens, counters and
    logprobs equal the JAX engine's over full-length caches, and the
    speculative modes equal plain decoding."""
    jr, tr, te = engine_run(mode)
    np.testing.assert_array_equal(tr["tokens"], jr["tokens"])
    for leaf in ("new_count", "committed", "iters", "row_iters", "last"):
        np.testing.assert_array_equal(tr["state"][leaf].numpy(),
                                      np.asarray(jr["state"][leaf]), leaf)
    _close(tr["state"]["logprobs"], jr["state"]["logprobs"])
    assert te.chunk_only and te.ring and te.model.recurrent
    ring = [c["k"].shape[1] for c in tr["state"]["tcache"]["blocks"]
            if "k" in c]
    assert ring == [64 + (K if mode != "none" else 0) + 1]
    if mode != "none":
        np.testing.assert_array_equal(tr["tokens"],
                                      engine_run("none")[1]["tokens"])


def _workload(vocab=1024, n=5, seed=7):
    """(prompt, budget, arrival): prompts of 5-21 tokens (odd lengths:
    several MSB chunks), budgets 10-16, Exp(1) gaps."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab - 1, int(m)).astype(np.int32), int(b),
             float(t)) for m, b, t in zip(rng.integers(5, 22, n),
                                          rng.integers(10, 17, n),
                                          np.cumsum(rng.exponential(1.0, n)))]


def _requests(cls, work, policy=None):
    return [cls(p, max_new_tokens=b, arrival_time=t, rid=i,
                sampling=None if policy is None else policy(i))
            for i, (p, b, t) in enumerate(work)]


POLICIES = dict(kv_layout="paged", pool_pages=7, swap="host",
                prefix_cache=True, max_len=POOL_LEN, max_new_tokens=16)


@lru_cache(maxsize=None)
def serves():
    """The workload on 3 slots at max_len 64 (no ring: the attention
    layers' caches are pools): the JAX scheduler and the port's over paged
    KV (a 7-page pool that preempts, swap to host, the prefix cache on),
    and the port's contiguous serve."""
    work = _workload()
    jr = JScheduler(_jengine(3, **POLICIES)).serve(_requests(JRequest, work))
    te = _engine(3, **POLICIES)
    tr = Scheduler(te).serve(_requests(Request, work))
    cr = Scheduler(_engine(3, max_len=POOL_LEN, max_new_tokens=16)).serve(
        _requests(Request, work))
    return jr, tr, te, cr


def test_paged_serve_matches_jax_scheduler():
    """Scheduler.serve over paged KV (the attention layers' and the
    drafter's KV pooled, the recurrent rows per slot): per request tokens,
    counters and logprobs, the event trace and the report's counters equal
    the JAX scheduler's, with preemptions to the host; the prefix cache
    stays idle, as the JAX scheduler's; both pools end empty; the
    contiguous serve gives the same streams."""
    jr, tr, te, cr = serves()
    assert len(tr["results"]) == len(jr["results"]) == 5
    for t, j, c in zip(tr["results"], jr["results"], cr["results"]):
        assert t["rid"] == j["rid"]
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
        np.testing.assert_array_equal(t["tokens"], c["tokens"])
        for key in ("n_new", "iters", "n_preempt", "cached_tokens"):
            assert t[key] == j[key], (t["rid"], key)
        _close(t["logprobs"], j["logprobs"])
    assert tr["events"] == [tuple(e) for e in jr["events"]]
    for key in ("iterations", "makespan_vt", "preemptions", "preempt_swap",
                "preempt_recompute", "peak_pages", "total_new_tokens",
                "cache_hit_tokens", "cache_hit_requests"):
        assert tr[key] == jr[key], key
    assert tr["preempt_swap"] > 0 and tr["cache_hit_tokens"] == 0
    assert te.prefix_cache is None and te.allocator.n_used == 0
    assert len(te.host_pool) == 0 and te.host_pool.used_bytes == 0


def test_mixed_leaves_pool_and_stay_per_slot():
    """At max_len 64 the attention layers' caches are pools tagged PAGED
    beside the recurrent leaves tagged NOT_PAGED (per slot); at max_len 128
    they are per-slot rings. ``extract_slot`` / ``admit_pages`` carry a
    slot's recurrent rows bitwise, and freeing a slot zeroes them."""
    te = _engine(**POLICIES)
    state = te.blank_state()
    spec = cache_ops.paged_spec(state["tcache"])["blocks"]
    assert spec[0] == {"conv": cache_ops.NOT_PAGED, "h": cache_ops.NOT_PAGED}
    assert spec[2] == {"k": cache_ops.PAGED_KV, "v": cache_ops.PAGED_KV,
                       "positions": cache_ops.PAGED_POS,
                       "ring": cache_ops.NOT_PAGED}
    blocks = state["tcache"]["blocks"]
    assert blocks[0]["h"].shape[0] == te.batch
    assert blocks[2]["k"].shape[0] == te.pool_pages + 1
    prompt = np.random.default_rng(4).integers(1, 200, 11).astype(np.int32)
    state, _, _ = te.prefill_into_slot(state, prompt, 1)
    assert float(blocks[0]["h"][1].abs().sum()) > 0
    assert float(blocks[0]["h"][0].abs().sum()) == 0
    pages = torch.tensor(te._slot_pages[1], dtype=torch.int32)
    snap = cache_ops.extract_slot(te._core(state), 1, pages, te.pspec)
    cache_ops.admit_pages(te._core(state), snap, 0,
                          torch.full_like(pages, -1), te.pspec)
    for li in (0, 1, 3, 4):
        for n in ("conv", "h"):
            assert torch.equal(blocks[li][n][0], blocks[li][n][1])
    te.free_slot(state, 1)
    te.free_slot(state, 0)
    assert float(blocks[0]["h"].abs().sum()) == 0
    ring = _engine(kv_layout="paged").blank_state()["tcache"]["blocks"][2]
    assert ring["ring"] and ring["k"].shape[:2] == (2, 64 + K + 1)


def test_sampled_stream_matches_jax_engine():
    """One sampled stream past the window (drafts sampled too): tokens
    equal the JAX engine's except after a decision of margin < 1e-4; keys
    equal."""
    policy = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=3)
    prompts = np.random.default_rng(6).integers(1, 1000, (2, 30)).astype(
        np.int32)
    with full_length_caches():
        jr = _jengine(sampling=policy, draft_sampling=True).run(
            jnp.asarray(prompts))
    te = _engine(sampling=policy, draft_sampling=True)
    with MarginLog() as log:
        tr = te.run(prompts)
    assert log.margins
    want = np.asarray(jr["tokens"])
    compared = 0
    for b in range(2):
        diff = np.flatnonzero(tr["tokens"][b, 30:] != want[b, 30:])
        if len(diff):
            pos = 30 + int(diff[0])
            assert log.min_margin(policy.seed, 30, pos) < NEAR_TIE, (b, pos)
        compared += len(diff) == 0
    assert compared >= 1
    np.testing.assert_array_equal(
        tr["state"]["sampling"]["key"].numpy(),
        np.asarray(jr["state"]["sampling"]["key"]).astype(np.int64))


def test_chunked_admission_of_ragged_prompts():
    """A recurrent target never pads: prompts of 77 and 7 tokens are
    admitted in MSB-first chunks (64 + 8 + 4 + 1 past the window, over the
    rings; 4 + 2 + 1), a prefill then decode-mode chunks that build no
    snapshot, while every verify builds them; the streams equal an
    unbucketed admission's (one exact-length prefill)."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 1000, n).astype(np.int32) for n in (77, 7)]
    eng = _engine(max_new_tokens=6)
    chunks, snaps = [], []
    chunk, fwd = eng._chunk, eng.model.forward
    eng._chunk = lambda src, c, start, *a, **k: (
        chunks.append((start, c.shape[1])), chunk(src, c, start, *a, **k))[1]
    object.__setattr__(eng.model, "forward", lambda *a, **k: (
        snaps.append((k.get("mode"), a[1].shape[1],
                      k.get("snapshots", False))),
        fwd(*a, **k))[1])
    got = Scheduler(eng).serve([Request(p, max_new_tokens=6)
                                for p in prompts])
    assert chunks == [(64, 8), (72, 4), (76, 1), (4, 2), (6, 1)]
    assert ("prefill", 64, False) in snaps and ("prefill", 4, False) in snaps
    assert all(s is (t == K + 1) for m, t, s in snaps if m == "decode")
    assert any(s for _, _, s in snaps)
    ref = Scheduler(_engine(max_new_tokens=6, bucket_prefill=False)).serve(
        [Request(p, max_new_tokens=6) for p in prompts])
    for g, r in zip(got["results"], ref["results"]):
        np.testing.assert_array_equal(g["tokens"], r["tokens"])


def test_prefix_cache_idle_over_two_passes():
    """As test_prefix_cache.py's test_cache_hit_losslessness for hybrid: a
    shared-preamble workload served twice on an engine asked for a prefix
    cache equals the cache-off engine's streams, with no hit: the cache is
    never built for a recurrent target with rings."""
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 200, 20).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(1, 200, t).astype(np.int32)])
               for t in (3, 5, 7, 4)]
    warm = _engine(kv_layout="paged", prefix_cache=True, max_new_tokens=8)
    cold = _engine(kv_layout="paged", max_new_tokens=8)

    def serve(eng):
        rep = Scheduler(eng).serve([Request(p, max_new_tokens=8)
                                    for p in prompts])
        return [r["tokens"] for r in rep["results"]], rep
    cold_toks, _ = serve(cold)
    for _ in (1, 2):
        warm_toks, rep = serve(warm)
        for c, w in zip(cold_toks, warm_toks):
            np.testing.assert_array_equal(w, c)
        assert rep["cache_hit_tokens"] == rep["cache_hit_requests"] == 0
    assert warm.prefix_cache is None


def test_sampled_swap_resume_bitwise():
    """Seeded sampled requests on a 5-page pool at max_len 64 (pools beside
    the recurrent rows) are swapped to the host and resumed; each stream,
    tokens and logprobs, equals the request served alone; both pools
    drain."""
    eng = _engine(kv_layout="paged", pool_pages=5, swap="host",
                  max_new_tokens=16, max_len=POOL_LEN)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 200, size=6).astype(np.int32)
               for _ in range(3)]
    budgets = [14, 14, 8]
    sps = [SamplingParams(temperature=0.8, seed=100 + i) for i in range(3)]
    rep = Scheduler(eng).serve(
        [Request(p, max_new_tokens=b, sampling=sp)
         for p, b, sp in zip(prompts, budgets, sps)])
    assert rep["preempt_swap"] >= 1
    for res, p, b, sp in zip(rep["results"], prompts, budgets, sps):
        solo = Scheduler(eng).serve([Request(p, max_new_tokens=b,
                                             sampling=sp)])["results"][0]
        np.testing.assert_array_equal(res["tokens"], solo["tokens"])
        np.testing.assert_array_equal(res["logprobs"], solo["logprobs"])
    assert eng.allocator.n_used == 0 and len(eng.host_pool) == 0

"""The SSM family in the port against the JAX package, on the CPU in
float32: mamba2-780m ``reduced()`` (2 layers, d 256, 32 SSD heads of 16,
d_state 16, chunk 8) with a 1-layer attention drafter, weights converted
from the JAX package's, inputs made with numpy from a seed. Tolerance 3e-5
(float32 on both sides, sums in another order); tokens, events and
counters equal.

Covered: the forward in train, prefill and decode modes (logits, taps, the
conv and state leaves, the verify's per-token snapshots, and none built
for a decode-mode admission chunk), ``cache_ops.commit``'s snapshot
selection, ``Engine.run`` in the three drafter modes, ``Scheduler.serve``
over both layouts with preemption, swap to host and the prefix cache on
(which stays idle, as the JAX scheduler's does for recurrent targets), a
seeded sampled stream, and the MSB-first chunked admission of ragged
prompts. The JAX package's own SSM cases are mirrored: cross-layout
losslessness, the paged admission round trip, the chunk buckets, the idle
prefix cache over two passes, and the sampled swap resume."""
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
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import cache_ops as jcache_ops
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.models import ssm
from repro_torch.models.registry import get_model
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.margins import MarginLog
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ARCH = "mamba2-780m"
TOL = 3e-5
NEAR_TIE = 1e-4
K, MAX_LEN, PAGE = 2, 64, 8


# the hybrid recurrentgemma-2b cut to one super-block and its 2-layer tail
# (reduced() alone keeps no attention layer), for the pin of the stalled
# slot that reaches both recurrent families
HYBRID = "recurrentgemma-2b"


def _reduced(get, arch):
    cfg = get(arch).reduced()
    return cfg.replace(n_layers=5) if arch == HYBRID else cfg


@lru_cache(maxsize=None)
def models(arch=ARCH):
    """((jcfg, jdcfg, jparams, jdparams), (tcfg, dcfg, tparams, dparams)):
    the reduced config of ``arch`` and a 1-layer drafter, on both sides."""
    jcfg, tcfg = _reduced(jget_config, arch), _reduced(get_config, arch)
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(23))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(24))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    return (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp)


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=tol, err_msg=msg)


def _same_layers(tcache, jblocks, msg=""):
    """Port layers ``{"blocks": [{conv, state}]}`` against a JAX tree
    stacked on the layer axis."""
    want = convert.ssm_layers(jax.tree.map(np.asarray, jblocks))
    for li, (t, w) in enumerate(zip(tcache["blocks"], want["blocks"])):
        for name in ("conv", "state"):
            _close(t[name], w[name], msg=f"{msg} layer {li} {name}")


# ---------------------------------------------------------------------------
# the config and the model
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    """The port's copy equals the JAX package's config field by field, at
    full width and reduced; the drafter resolves to 12 heads of 128."""
    for reduced in (False, True):
        j, t = jget_config(ARCH), get_config(ARCH)
        if reduced:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    d = DrafterConfig().resolve(get_config(ARCH))
    assert (d.d_model, d.n_heads, d.head_dim) == (1536, 12, 128)


def test_forward_train_prefill_decode_match_reference():
    """Train-mode logits and taps (12 tokens: the chunk is 6, the largest
    divisor of 12 up to 8); a prefill's cache leaves; a decode block's
    logits, taps and cache leaves, with no snapshot built; the same block
    as a verify: each token's snapshots equal the JAX forward's, and the
    cache is left for the commit."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models()
    rng = np.random.default_rng(1)
    B, P, T = 2, 12, 3
    toks = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    jm, model = jget_model(jcfg), get_model(tcfg)
    jo = jm.forward(jp, jnp.asarray(toks), mode="train")
    to = model.forward(tp, torch.from_numpy(toks), mode="train")
    _close(to.logits, jo.logits)
    _close(to.taps, jo.taps)
    assert all(bp[n].dtype == torch.float32 for bp in tp["blocks"]
               for n in ("ln", "A_log", "dt_bias", "D", "gnorm"))

    jc = jm.make_cache(B, MAX_LEN, dtype=jnp.float32)
    tc = model.make_cache(B, MAX_LEN, dtype=torch.float32, device="cpu")
    jo = jm.forward(jp, jnp.asarray(toks), mode="prefill", cache=jc)
    to = model.forward(tp, torch.from_numpy(toks), mode="prefill", cache=tc)
    _close(to.logits, jo.logits)
    _same_layers(to.cache, jo.cache["blocks"], "prefill")
    prefilled = {n: [c[n].clone() for c in tc["blocks"]]
                 for n in ("conv", "state")}

    blk = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(P + np.arange(T), (B, T)).astype(np.int32)
    jd = jm.forward(jp, jnp.asarray(blk), mode="decode",
                    positions=jnp.asarray(pos), cache=jo.cache)
    to = model.forward(tp, torch.from_numpy(blk), mode="decode",
                       positions=torch.from_numpy(pos), cache=tc)
    _close(to.logits, jd.logits)
    _close(to.taps, jd.taps)
    _same_layers(to.cache, jd.cache["blocks"], "decode")
    assert to.aux["snapshots"] is None

    for li, c in enumerate(tc["blocks"]):     # back to the prefill's state
        for n in ("conv", "state"):
            c[n].copy_(prefilled[n][li])
    to = model.forward(tp, torch.from_numpy(blk), mode="decode",
                       positions=torch.from_numpy(pos), cache=tc,
                       snapshots=True)
    _close(to.logits, jd.logits)
    snaps = to.aux["snapshots"]
    _same_layers(snaps, jd.aux["snapshots"]["blocks"], "snapshots")
    assert snaps["blocks"][0]["state"].shape == (B, T) + tuple(
        tc["blocks"][0]["state"].shape[1:])
    for li, c in enumerate(tc["blocks"]):
        for n in ("conv", "state"):
            assert torch.equal(c[n], prefilled[n][li]), (li, n)


def test_intra_chunk_overflow_is_discarded():
    """Decays steep enough that exp(csum_i - csum_j) overflows above the
    diagonal: the chunked scan stays finite and equals the token-by-token
    recurrence (the where drops the overflow; a product with a 0/1 mask
    would make it nan)."""
    g = torch.Generator().manual_seed(0)
    B, S, H, P, N = 1, 16, 2, 4, 3
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.full((B, S, H), 20.0)
    A = torch.tensor([-10.0, -5.0])
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N,
                                                            generator=g)
    D = torch.ones(H)
    y, state = ssm._ssd_chunked(x, dt, A, Bm, Cm, D, 8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    ys, ss, _ = ssm._ssd_step(x, dt, A, Bm, Cm, D, torch.zeros(B, H, P, N),
                              False)
    _close(y, ys, tol=1e-5)
    _close(state, ss, tol=1e-5)


def test_commit_selects_snapshots_as_reference():
    """``cache_ops.commit`` writes each row's snapshot at its accept index,
    as the JAX package's ``commit(cache, snapshots, commit_pos,
    accept_idx)``; a row whose index is negative keeps its leaves."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models()
    rng = np.random.default_rng(2)
    B, T = 3, 3
    jm, model = jget_model(jcfg), get_model(tcfg)
    jc = jm.make_cache(B, MAX_LEN, dtype=jnp.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    jc = jm.forward(jp, jnp.asarray(toks), mode="prefill", cache=jc).cache
    blk = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(8 + np.arange(T), (B, T)).astype(np.int32)
    jo = jm.forward(jp, jnp.asarray(blk), mode="decode",
                    positions=jnp.asarray(pos), cache=jc)
    accept = np.array([2, 0, 1], np.int32)
    want = jcache_ops.commit(jo.cache, jo.aux["snapshots"],
                             jnp.asarray(8 + accept), jnp.asarray(accept))

    tc = convert.target_cache(jax.tree.map(np.asarray, jc), tcfg)
    snaps = convert.ssm_layers(
        jax.tree.map(np.asarray, jo.aux["snapshots"]["blocks"]))
    before = [c["state"][1].clone() for c in tc["blocks"]]
    cache_ops.commit(tc, torch.from_numpy(8 + accept), snapshots=snaps,
                     accept_idx=torch.from_numpy(accept))
    _same_layers(tc, want["blocks"], "commit")
    keep = torch.tensor([2, -1, 1], dtype=torch.int32)
    cache_ops.commit(tc, torch.from_numpy(8 + accept), snapshots=snaps,
                     accept_idx=keep)
    for c, b in zip(tc["blocks"], before):
        assert not torch.equal(c["state"][1], b)     # row 1 took index 0
    tc0 = convert.target_cache(jax.tree.map(np.asarray, jc), tcfg)
    cache_ops.commit(tc0, torch.from_numpy(8 + accept), snapshots=snaps,
                     accept_idx=keep)
    for c, c0 in zip(tc0["blocks"], convert.target_cache(
            jax.tree.map(np.asarray, jc), tcfg)["blocks"]):
        assert torch.equal(c["state"][1], c0["state"][1])
        assert torch.equal(c["conv"][1], c0["conv"][1])


def test_recurrent_leaves_are_per_slot_rows():
    """The conv and state leaves are tagged NOT_PAGED: a paged blank state
    keeps one row per slot, ``reset_slot`` zeroes the slot's rows,
    ``extract_slot`` / ``admit_pages`` carry them bitwise, and the swap
    estimate counts their bytes."""
    te = _engine("paged", pool_pages=12)
    state = te.blank_state()
    blocks = state["tcache"]["blocks"]
    assert cache_ops.paged_spec(state["tcache"]) == {
        "blocks": [{"conv": cache_ops.NOT_PAGED,
                    "state": cache_ops.NOT_PAGED}] * len(blocks)}
    assert blocks[0]["state"].shape[0] == te.batch
    prompt = np.random.default_rng(4).integers(1, 200, 11).astype(np.int32)
    state, _, _ = te.prefill_into_slot(state, prompt, 1)
    assert float(blocks[0]["state"][1].abs().sum()) > 0
    assert float(blocks[0]["state"][0].abs().sum()) == 0
    pages = torch.tensor(te._slot_pages[1], dtype=torch.int32)
    snap = cache_ops.extract_slot(te._core(state), 1, pages, te.pspec)
    cache_ops.admit_pages(te._core(state), snap, 0,
                          torch.full_like(pages, -1), te.pspec)
    for n in ("conv", "state"):
        assert torch.equal(blocks[1][n][0], blocks[1][n][1])
    row_b, _ = te._swap_layout()
    recurrent = sum(c[n][0].numel() * c[n].element_size()
                    for c in blocks for n in ("conv", "state"))
    assert row_b > recurrent
    assert te.swap_bytes_estimate(1) >= recurrent
    te.free_slot(state, 1)
    te.free_slot(state, 0)
    for n in ("conv", "state"):
        assert float(blocks[0][n][1].abs().sum()) == 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _ecfg(**kw):
    base = dict(K=K, max_new_tokens=16, drafter_mode="parallel",
                max_len=MAX_LEN, page_size=PAGE)
    base.update(kw)
    if base["drafter_mode"] == "none":
        base["K"] = 0
    return base


def _engine(layout="contiguous", batch=2, arch=ARCH, **kw):
    (_, _, _, _), (tcfg, dcfg, tp, dp) = models(arch)
    cfg = _ecfg(kv_layout=layout, **kw)
    use_d = cfg["drafter_mode"] != "none"
    return Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                  EngineConfig(**cfg), batch, device="cpu")


def _jengine(layout="contiguous", batch=2, arch=ARCH, **kw):
    (jcfg, jdcfg, jp, jdp), _ = models(arch)
    cfg = _ecfg(kv_layout=layout, **kw)
    use_d = cfg["drafter_mode"] != "none"
    if "sampling" in kw:
        cfg["sampling"] = JSamplingParams(**dataclasses.asdict(kw["sampling"]))
    return JEngine(jcfg, jdcfg if use_d else None, jp,
                   jdp if use_d else None, JEngineConfig(**cfg), batch)


@lru_cache(maxsize=None)
def engine_run(mode):
    prompts = np.random.default_rng(5).integers(
        1, 1000, (2, 13)).astype(np.int32)
    jr = _jengine(drafter_mode=mode, max_new_tokens=30).run(
        jnp.asarray(prompts))
    te = _engine(drafter_mode=mode, max_new_tokens=30)
    return jr, te.run(prompts), te


@pytest.mark.parametrize("mode", ["parallel", "ar", "none"])
def test_engine_run_matches_jax_engine(mode):
    """Greedy Engine.run (13-token prompts prefilled at their exact length,
    30 new tokens): tokens, counters and logprobs equal the JAX engine's,
    and the speculative modes equal plain decoding."""
    jr, tr, te = engine_run(mode)
    np.testing.assert_array_equal(tr["tokens"], jr["tokens"])
    for leaf in ("new_count", "committed", "iters", "row_iters", "last"):
        np.testing.assert_array_equal(tr["state"][leaf].numpy(),
                                      np.asarray(jr["state"][leaf]), leaf)
    _close(tr["state"]["logprobs"], jr["state"]["logprobs"])
    assert te.chunk_only and not te.ring
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


POLICIES = dict(pool_pages=7, swap="host", prefix_cache=True)


@lru_cache(maxsize=None)
def serves():
    """The workload on 3 slots: the JAX scheduler and the port's over paged
    KV (a 7-page pool that preempts, swap to host, the prefix cache on),
    and the port's contiguous serve."""
    work = _workload()
    jr = JScheduler(_jengine("paged", 3, **POLICIES)).serve(
        _requests(JRequest, work))
    te = _engine("paged", 3, **POLICIES)
    tr = Scheduler(te).serve(_requests(Request, work))
    cr = Scheduler(_engine("contiguous", 3)).serve(_requests(Request, work))
    return jr, tr, te, cr


def test_paged_serve_matches_jax_scheduler():
    """Scheduler.serve over paged KV (only the drafter's KV is paged; the
    recurrent state stays per slot): per request tokens, counters and
    logprobs, the event trace and the report's counters equal the JAX
    scheduler's, with preemptions to the host; the prefix cache stays
    idle, as the JAX scheduler's; both pools end empty; the contiguous
    serve gives the same streams."""
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


def test_sampled_stream_matches_jax_engine():
    """One sampled stream (drafts sampled too): tokens equal the JAX
    engine's except after a decision of margin < 1e-4; keys equal."""
    policy = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=3)
    prompts = np.random.default_rng(6).integers(1, 1000, (2, 13)).astype(
        np.int32)
    jr = _jengine(sampling=policy, draft_sampling=True,
                  max_new_tokens=30).run(jnp.asarray(prompts))
    te = _engine(sampling=policy, draft_sampling=True, max_new_tokens=30)
    with MarginLog() as log:
        tr = te.run(prompts)
    assert log.margins
    want = np.asarray(jr["tokens"])
    compared = 0
    for b in range(2):
        diff = np.flatnonzero(tr["tokens"][b, 13:] != want[b, 13:])
        if len(diff):
            pos = 13 + int(diff[0])
            assert log.min_margin(policy.seed, 13, pos) < NEAR_TIE, (b, pos)
        compared += len(diff) == 0
    assert compared >= 1
    np.testing.assert_array_equal(
        tr["state"]["sampling"]["key"].numpy(),
        np.asarray(jr["state"]["sampling"]["key"]).astype(np.int64))


def test_chunked_admission_of_ragged_prompts():
    """A recurrent target never pads (a pad would fold into its state):
    prompts of 13 and 7 tokens are admitted in MSB-first chunks (8 + 4 + 1,
    4 + 2 + 1), a prefill then decode-mode chunks that build no snapshot,
    while every verify builds them; the streams equal an unbucketed
    admission's (one exact-length prefill). (The JAX scheduler's chunked
    admissions are held in test_paged_serve_matches_jax_scheduler.)"""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 1000, n).astype(np.int32) for n in (13, 7)]
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
    assert chunks == [(8, 4), (12, 1), (4, 2), (6, 1)]
    assert ("prefill", 8, False) in snaps and ("prefill", 4, False) in snaps
    assert all(s is (t == K + 1) for m, t, s in snaps if m == "decode")
    assert any(s for _, _, s in snaps)
    ref = Scheduler(_engine(max_new_tokens=6, bucket_prefill=False)).serve(
        [Request(p, max_new_tokens=6) for p in prompts])
    for g, r in zip(got["results"], ref["results"]):
        np.testing.assert_array_equal(g["tokens"], r["tokens"])


# ---------------------------------------------------------------------------
# the JAX package's own SSM cases, mirrored
# ---------------------------------------------------------------------------

def test_cross_layout_losslessness():
    """As test_serving.py's test_cross_layout_losslessness for ssm: greedy
    serving through the paged engine (bucketed, i.e. chunked, admission)
    equals the contiguous engine with exact-length prefills, token for
    token, over lengths that are powers of two, one off them and several
    chunks; the pool drains."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 1000, n).astype(np.int32)
               for n in (4, 5, 7, 3, 9)]
    budgets = [6, 3, 5, 4, 6]
    reqs = lambda: [Request(p, max_new_tokens=b)         # noqa: E731
                    for p, b in zip(prompts, budgets)]
    ref = Scheduler(_engine(max_new_tokens=6, bucket_prefill=False)).serve(
        reqs())
    paged = _engine("paged", max_new_tokens=6)
    got = Scheduler(paged).serve(reqs())
    for r, g in zip(ref["results"], got["results"]):
        np.testing.assert_array_equal(r["tokens"], g["tokens"])
    assert paged.allocator.n_free == paged.pool_pages


def test_paged_admit_roundtrip_identity():
    """As test_cache_ops.py's test_paged_admit_roundtrip_identity for ssm:
    a paged admission, gathered back into a contiguous view, equals the
    contiguous admission in every slot (the recurrent rows bitwise; K/V
    under empty positions ignored); freeing returns every page."""
    engc, engp = _engine(batch=3), _engine("paged", batch=3)
    prompt = np.asarray([5, 9, 2, 11, 4], np.int32)
    sc, fc, lc = engc.prefill_into_slot(engc.blank_state(), prompt, 1)
    sp, fp, lp = engp.prefill_into_slot(engp.blank_state(), prompt, 1)
    assert (fc, lc) == (fp, lp)
    view = cache_ops.gather_state(engp._core(sp), sp["block_table"],
                                  engp.pspec)

    def rows(tree, s):
        out = {}
        cache_ops.map_tree(lambda p, t: out.__setitem__(p, t[s])
                           if isinstance(t, torch.Tensor) and t.dim() > 0
                           else None, tree)
        return out
    for s in range(3):
        a, b = rows(view, s), rows(sc, s)
        assert set(a) == set(b)
        for path in a:
            if path.startswith("/dcache") and path.rsplit("/", 1)[-1] in "kv":
                live = rows(view, s)[path.rsplit("/", 1)[0] + "/positions"]
                assert torch.equal(a[path][live >= 0], b[path][live >= 0])
            else:
                assert torch.equal(a[path], b[path]), (s, path)
    engp.free_slot(sp, 1)
    assert engp.allocator.n_free == engp.pool_pages
    assert int(sp["block_table"][1].max()) == -1


def test_chunk_buckets_bounded():
    """As test_cache_ops.py's test_prefill_retrace_bound_chunked: admitting
    lengths 1-12 runs first chunks and later chunks of at most
    ceil(log2(max_len)) distinct sizes each, every one a power of two, and
    never pads."""
    eng = _engine(drafter_mode="none", max_new_tokens=2)
    firsts, later = set(), set()
    rows, chunk = eng._prefill_rows, eng._chunk

    def prefill_rows(prompts, true_len, *a, **k):
        assert prompts.shape[1] == true_len      # no pad
        firsts.add(true_len)
        return rows(prompts, true_len, *a, **k)
    eng._prefill_rows = prefill_rows
    eng._chunk = lambda src, c, *a, **k: (later.add(c.shape[1]),
                                          chunk(src, c, *a, **k))[1]
    state = eng.blank_state()
    for n in range(1, 13):
        prompt = np.arange(1, n + 1, dtype=np.int32)
        state, _, _ = eng.prefill_into_slot(state, prompt, 0)
        state = eng.free_slot(state, 0)
    bound = int(np.ceil(np.log2(MAX_LEN)))
    assert len(firsts) <= bound and len(later) <= bound
    assert all(n & (n - 1) == 0 for n in firsts | later)


def test_prefix_cache_idle_over_two_passes():
    """As test_prefix_cache.py's test_cache_hit_losslessness for ssm: a
    shared-preamble workload served twice on an engine asked for a prefix
    cache equals the cache-off engine's streams, with no hit: the cache is
    never built for a recurrent target (recurrent page content is not a
    function of the page's own tokens)."""
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 200, 20).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(1, 200, t).astype(np.int32)])
               for t in (3, 5, 7, 4)]
    warm = _engine("paged", prefix_cache=True)
    cold = _engine("paged")

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
    """As test_swap.py's sampled swap resume for ssm (its mesh-4 case runs
    the single-device path here): seeded sampled requests on a 5-page pool
    are swapped to the host and resumed; each stream, tokens and logprobs,
    equals the request served alone; both pools drain."""
    eng = _engine("paged", pool_pages=5, swap="host", max_new_tokens=16)
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


@pytest.mark.parametrize("arch", [ARCH, HYBRID])
def test_reference_stalled_recurrent_slot_drifts(arch):
    """Pin of the JAX package's fault the port departs from, in both
    recurrent families (the hybrid's attention layer a pool at max_len 64).
    Without preemption a slot that cannot grow stalls (masked out of the
    step); the reference's commit still writes its recurrent state's
    snapshot at index 0 (the re-fed last token), so the stalled stream's
    next step feeds that token twice and parts from the unstalled stream.
    The port's commit keeps a masked row's state: its stalled stream equals
    the contiguous serve's. Two requests (budgets 10 and 14) on a 5-page
    pool."""
    rng = np.random.default_rng(3)
    work = [(rng.integers(1, 200, size=6).astype(np.int32), b, 0.0)
            for b in (10, 14)]
    ref = Scheduler(_engine(max_new_tokens=16, arch=arch)).serve(
        _requests(Request, work))
    jr = JScheduler(_jengine("paged", pool_pages=5, max_new_tokens=16,
                             arch=arch),
                    preempt=False).serve(_requests(JRequest, work))
    tr = Scheduler(_engine("paged", pool_pages=5, max_new_tokens=16,
                           arch=arch),
                   preempt=False).serve(_requests(Request, work))
    assert tr["iterations"] == jr["iterations"] > ref["iterations"]
    for t, r in zip(tr["results"], ref["results"]):
        np.testing.assert_array_equal(t["tokens"], r["tokens"])
    np.testing.assert_array_equal(jr["results"][0]["tokens"],
                                  ref["results"][0]["tokens"])
    assert not np.array_equal(jr["results"][1]["tokens"],
                              ref["results"][1]["tokens"])

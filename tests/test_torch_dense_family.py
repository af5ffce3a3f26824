"""The rest of the dense family in the port against the JAX package, on the
CPU in float32 with the plain attention: gemma-7b (GeGLU, embedding
scale; at the reduced head dim 32 and at its own 256), gemma2-27b
(alternating local/global attention, attention and final softcaps,
post-norms, query scale 144^-0.5) and minitron-4b (ReLU², untied head),
each ``reduced()`` (2 layers, d 256); weights converted from the JAX
package's, inputs made with numpy from a seed. Tolerance 3e-5 (float32 on
both sides, reductions in another order); tokens and events equal.

gemma2's local layers keep rings in the port of ``window + K + 1`` slots
(``models.transformer.ring_length``); the reference here is the JAX
package over full-length windowed caches (its ``make_cache`` patched in
the test to ``ring=False`` at ``max_len``; the window mask is unchanged),
since the JAX package's own ring of ``window`` slots can lose an
in-window key after a rejected draft. Two tests pin the reference's
faults that the port departs from: that ring loss, and the prefix cache's
hit on a ring target, whose stream parts from the cold one (the port keeps
its prefix cache idle for ring targets)."""
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.margins import MarginLog
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
import torch_threads  # noqa: F401  (torch threads per xdist worker)

TOL = 3e-5
NEAR_TIE = 1e-4
# gemma-7b at its own head dim: 2 layers, d 256, 4 heads of 256
ARCHES = {"gemma-7b": lambda c: c.reduced(),
          "gemma-7b-hd256": lambda c: c.reduced().replace(head_dim=256),
          "gemma2-27b": lambda c: c.reduced(),
          "minitron-4b": lambda c: c.reduced()}
GEMMA2 = "gemma2-27b"
# serving geometry of gemma2 (window 64): prompts of 30 + 60 new tokens run
# every row past the window, K 2 (rings of 64 + 3 = 67 slots at max_len 128)
K, MAX_LEN, PAGE = 2, 128, 8


def _arch_cfg(name, get):
    return ARCHES[name](get(name.split("-hd")[0]))


@lru_cache(maxsize=None)
def models(name):
    """((jcfg, jdcfg, jparams, jdparams), (tcfg, dcfg, tparams, dparams)):
    the reduced config of ``name`` and a 1-layer drafter, on both sides."""
    jcfg, tcfg = _arch_cfg(name, jget_config), _arch_cfg(name, get_config)
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(23))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(24))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    return (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp)


@contextlib.contextmanager
def full_length_caches():
    """The JAX package's caches at full length: every layer's cache is
    ``max_len`` slots, ``ring=False``; local layers keep their window
    mask. (Patched for the test only; the package is not changed.)"""
    make_cache, make_kv = JT.make_cache, JL.make_kv_cache

    def patched(cfg, batch, max_len, dtype=jnp.bfloat16):
        with pytest.MonkeyPatch.context() as inner:
            inner.setattr(JL, "make_kv_cache",
                          lambda b, ln, kv, hd, dtype=jnp.bfloat16, ring=False:
                          make_kv(b, max_len, kv, hd, dtype=dtype, ring=False))
            return make_cache(cfg, batch, max_len, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "make_cache", patched)
        yield


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# configs and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-7b", "gemma2-27b", "minitron-4b"])
def test_config_copy_matches_reference(arch):
    """The port's copies equal the JAX package's configs field by field,
    at full width and reduced."""
    for reduced in (False, True):
        j, t = jget_config(arch), get_config(arch)
        if reduced:
            j, t = j.reduced(), t.reduced()
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert set(td) == set(jd)
        for name in td:
            assert td[name] == jd[name], (arch, name)
        assert [t.attn_kind(i) for i in range(t.n_layers)] == \
            [j.attn_kind(i) for i in range(j.n_layers)]
        assert t.q_scale() == j.q_scale()


@pytest.mark.parametrize("name", list(ARCHES))
def test_converted_weights_train_and_prefill(name):
    """Train-mode logits and taps, then a prefill into a cache and a
    verify-shaped decode against it, equal the JAX package's; the
    converted tree has the port's leaves (post-norms float32, an untied
    head where the config has one)."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jm, model = jget_model(jcfg), get_model(tcfg)
    jo = jm.forward(jp, jnp.asarray(toks), mode="train")
    to = model.forward(tp, torch.from_numpy(toks), mode="train")
    _close(to.logits, jo.logits)
    _close(to.taps, jo.taps)
    assert ("lm_head" in tp) == (not tcfg.tie_embeddings)
    assert ("pn1" in tp["blocks"][0]) == tcfg.post_norms
    assert all(bp[n].dtype == torch.float32 for bp in tp["blocks"]
               for n in ("ln1", "ln2", "pn1", "pn2") if n in bp)
    assert ("w_gate" in tp["blocks"][0]["mlp"]) == \
        (tcfg.mlp_variant in ("swiglu", "geglu"))

    with full_length_caches():
        jc = jm.make_cache(2, 40, dtype=jnp.float32)
    tc = model.make_cache(2, 40, dtype=torch.float32, device="cpu")
    jo = jm.forward(jp, jnp.asarray(toks), mode="prefill", cache=jc)
    to = model.forward(tp, torch.from_numpy(toks), mode="prefill", cache=tc)
    _close(to.logits, jo.logits)
    blk = rng.integers(0, jcfg.vocab_size, (2, 4)).astype(np.int32)
    pos = np.broadcast_to(12 + np.arange(4), (2, 4)).astype(np.int32)
    jo = jm.forward(jp, jnp.asarray(blk), mode="decode",
                    positions=jnp.asarray(pos), cache=jo.cache)
    to = model.forward(tp, torch.from_numpy(blk), mode="decode",
                       positions=torch.from_numpy(pos), cache=to.cache)
    _close(to.logits, jo.logits)
    _close(to.taps, jo.taps)


def test_decode_past_the_window_on_rings():
    """gemma2 (window 64): a 40-token prefill, then verify blocks of K + 1
    whose tails are rolled back (the next block restarts one or two
    positions after the last), on to position 120: the port's rings of
    64 + 3 slots wrap, and every block's logits and taps equal the JAX
    forward over full-length windowed caches."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models(GEMMA2)
    jm, model = jget_model(jcfg), get_model(tcfg)
    rng = np.random.default_rng(2)
    B, P, W = 2, 40, K + 1
    toks = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    with full_length_caches():
        jc = jm.make_cache(B, MAX_LEN, dtype=jnp.float32)
    tc = model.make_cache(B, MAX_LEN, dtype=torch.float32, device="cpu",
                          block=W)
    ring = tcfg.window_size + W
    assert [c["ring"] for c in tc["blocks"]] == [True, False]
    assert [c["k"].shape[1] for c in tc["blocks"]] == [ring, MAX_LEN]
    jo = jm.forward(jp, jnp.asarray(toks), mode="prefill", cache=jc)
    to = model.forward(tp, torch.from_numpy(toks), mode="prefill", cache=tc)
    _close(to.logits, jo.logits)
    def jdecode_fn(p, t, pos, c):
        o = jm.forward(p, t, mode="decode", positions=pos, cache=c)
        return o.logits, o.taps, o.cache
    jdecode = jax.jit(jdecode_fn)
    jcache, tcache, start, n, last = jo.cache, to.cache, P, 0, 0
    while start + W <= 120:
        blk = rng.integers(0, jcfg.vocab_size, (B, W)).astype(np.int32)
        pos = (start + np.broadcast_to(np.arange(W), (B, W))).astype(np.int32)
        jlogits, jtaps, jcache = jdecode(jp, jnp.asarray(blk),
                                         jnp.asarray(pos), jcache)
        to = model.forward(tp, torch.from_numpy(blk), mode="decode",
                           positions=torch.from_numpy(pos), cache=tcache)
        _close(to.logits, jlogits, msg=f"block at {start}")
        _close(to.taps, jtaps, msg=f"block at {start}")
        tcache, last = to.cache, int(pos.max())
        start += 1 + n % 2                # accept 0 or 1 of the K drafts
        n += 1
    kpos = tcache["blocks"][0]["positions"]
    assert last >= 2 * tcfg.window_size - 20 and int(kpos.max()) == last
    assert int(kpos[kpos >= 0].min()) > 0
    # wrapped: the slot order is not the position order
    assert not bool((kpos[0].argsort() == torch.arange(ring)).all())


def test_reference_ring_loses_an_in_window_key():
    """Pin of the JAX package's fault the port departs from. Window 8, a
    prompt at positions 0-11, a verify block at 12-14 whose drafts 13 and
    14 are rejected: the JAX ring of 8 slots has lost key 6 to the
    rejected draft at 14, though the next query at 13 sees 6-13; the
    port's ring of 8 + 3 slots keeps it."""
    W, T_max, kv, hd = 8, 3, 1, 4
    rng = np.random.default_rng(0)
    k0 = rng.standard_normal((1, 12, kv, hd)).astype(np.float32)
    k1 = rng.standard_normal((1, 3, kv, hd)).astype(np.float32)

    jc = JL.make_kv_cache(1, W, kv, hd, dtype=jnp.float32, ring=True)
    jc = JL.cache_update(jc, jnp.asarray(k0[:, -W:]), jnp.asarray(k0[:, -W:]),
                         jnp.asarray([12 - W], jnp.int32))
    jc = JL.cache_update(jc, jnp.asarray(k1), jnp.asarray(k1),
                         jnp.asarray([12], jnp.int32))
    jpos = np.asarray(jc["positions"])[0]
    jpos = np.where(jpos > 12, -1, jpos)               # commit at 12

    tc = L.make_kv_cache(1, W + T_max, kv, hd, dtype=torch.float32,
                         ring=True, device="cpu")
    L.cache_update(tc, torch.from_numpy(k0[:, -(W + T_max):]),
                   torch.from_numpy(k0[:, -(W + T_max):]),
                   torch.tensor([12 - W - T_max], dtype=torch.int32))
    L.cache_update(tc, torch.from_numpy(k1), torch.from_numpy(k1),
                   torch.tensor([12], dtype=torch.int32))
    cache_ops.commit({"blocks": [tc]}, torch.tensor([12], dtype=torch.int32))
    tpos = tc["positions"][0].numpy()

    window = set(range(13 - W + 1, 13))               # keys 6..12 of q 13
    assert 6 in window
    assert 6 not in set(jpos.tolist())                 # the reference lost it
    assert window <= set(tpos.tolist())                # the port keeps all
    j6 = int(np.flatnonzero(tpos == 6)[0])
    np.testing.assert_array_equal(tc["k"][0, j6].numpy(), k0[0, 6])


# ---------------------------------------------------------------------------
# serving: Engine.run, Scheduler.serve, chunked admission
# ---------------------------------------------------------------------------

def _ecfg(**kw):
    base = dict(K=K, max_new_tokens=60, drafter_mode="parallel",
                max_len=MAX_LEN, page_size=PAGE)
    base.update(kw)
    if base["drafter_mode"] == "none":
        base["K"] = 0
    return base


def _engines(name, batch, **kw):
    (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp) = models(name)
    use_d = _ecfg(**kw)["drafter_mode"] != "none"
    with full_length_caches():
        je = JEngine(jcfg, jdcfg if use_d else None, jp,
                     jdp if use_d else None, JEngineConfig(**_ecfg(**kw)),
                     batch)
    te = Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                EngineConfig(**_ecfg(**kw)), batch, device="cpu")
    return je, te


RUNS = [(GEMMA2, "parallel"), (GEMMA2, "ar"), (GEMMA2, "none"),
        ("gemma-7b", "parallel"), ("gemma-7b-hd256", "parallel"),
        ("minitron-4b", "parallel")]


@lru_cache(maxsize=None)
def engine_run(name, mode):
    prompts = np.random.default_rng(5).integers(
        1, 1000, (2, 30)).astype(np.int32)
    je, te = _engines(name, 2, drafter_mode=mode)
    with full_length_caches():
        jr = je.run(jnp.asarray(prompts))
    return jr, te.run(prompts), te


@pytest.mark.parametrize("name,mode", RUNS, ids=[f"{n}-{m}" for n, m in RUNS])
def test_engine_run_matches_jax_engine(name, mode):
    """Greedy Engine.run (30-token prompts, 60 new tokens: gemma2's rows
    run past the 64 window): tokens, counters and logprobs equal the JAX
    engine's, and the speculative modes equal plain decoding."""
    jr, tr, te = engine_run(name, mode)
    np.testing.assert_array_equal(tr["tokens"], jr["tokens"])
    for leaf in ("new_count", "committed", "iters", "row_iters", "last"):
        np.testing.assert_array_equal(tr["state"][leaf].numpy(),
                                      np.asarray(jr["state"][leaf]), leaf)
    _close(tr["state"]["logprobs"], jr["state"]["logprobs"])
    assert te.ring == (name == GEMMA2)
    if mode != "none" and name == GEMMA2:
        np.testing.assert_array_equal(tr["tokens"],
                                      engine_run(name, "none")[1]["tokens"])


def _workload(vocab, n=6, seed=7):
    """(prompt, budget, arrival): prompts of 20-70 tokens (some longer than
    the window), budgets 20-40, Exp(1) gaps."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab - 1, int(m)).astype(np.int32), int(b),
             float(t)) for m, b, t in zip(rng.integers(20, 71, n),
                                          rng.integers(20, 41, n),
                                          np.cumsum(rng.exponential(1.0, n)))]


def _requests(cls, work, policy=None):
    return [cls(p, max_new_tokens=b, arrival_time=t, rid=i,
                sampling=None if policy is None else policy(i))
            for i, (p, b, t) in enumerate(work)]


@lru_cache(maxsize=None)
def paged_serve():
    """gemma2 on 3 slots over paged KV with a pool of 20 pages of 8 (the
    prompts' growth preempts), against the JAX scheduler over full-length
    caches; and the port's contiguous serve of the same work."""
    work = _workload(1024)
    kw = dict(kv_layout="paged", pool_pages=20, max_new_tokens=40)
    je, te = _engines(GEMMA2, 3, **kw)
    with full_length_caches():
        jr = JScheduler(je).serve(_requests(JRequest, work))
    tr = Scheduler(te).serve(_requests(Request, work))
    tc = Engine(*models(GEMMA2)[1], EngineConfig(**_ecfg(max_new_tokens=40)),
                3, device="cpu")
    return jr, tr, te, Scheduler(tc).serve(_requests(Request, work))


def test_paged_serve_with_rings_matches_jax_scheduler():
    """Scheduler.serve over paged KV whose local layers keep per-slot rings:
    per request tokens, counters and logprobs, and the event trace, equal
    the JAX scheduler's over full-length caches; requests are preempted and
    the pool ends empty; the contiguous serve gives the same streams."""
    jr, tr, te, cr = paged_serve()
    assert len(tr["results"]) == len(jr["results"]) == 6
    for t, j, c in zip(tr["results"], jr["results"], cr["results"]):
        assert t["rid"] == j["rid"]
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
        np.testing.assert_array_equal(t["tokens"], c["tokens"])
        for key in ("n_new", "iters", "n_preempt"):
            assert t[key] == j[key], (t["rid"], key)
        _close(t["logprobs"], j["logprobs"])
    assert tr["events"] == [tuple(e) for e in jr["events"]]
    for key in ("iterations", "makespan_vt", "preemptions", "peak_pages",
                "total_new_tokens"):
        assert tr[key] == jr[key], key
    assert tr["preemptions"] > 0 and te.allocator.n_used == 0
    # the rings are per slot, the global layer a pool
    blocks = te.blank_state()["tcache"]["blocks"]
    assert blocks[0]["ring"] and blocks[0]["k"].shape[0] == 3
    assert blocks[1]["k"].shape == (20 + 1, PAGE, te.tcfg.n_kv_heads, 32)


def test_chunked_admission_for_ring_targets():
    """As the JAX package's test_bucketed_prefill_ring_window_safe: a
    65-token prompt would pad to a 128 bucket, over the window, so a ring
    target admits it in MSB-first chunks (64 + 1; 33 = 32 + 1) and never
    pads; the streams equal an unbucketed admission's and the JAX
    scheduler's."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models(GEMMA2)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, tcfg.vocab_size - 2, n).astype(np.int32)
               for n in (65, 33)]

    def port(bucket):
        e = Engine(tcfg, None, tp, None, EngineConfig(
            K=0, max_new_tokens=4, drafter_mode="none", max_len=128,
            bucket_prefill=bucket), 2, device="cpu")
        return e, Scheduler(e)

    eng, sched = port(True)
    assert eng.ring
    chunks = []
    chunk = eng._chunk
    eng._chunk = lambda src, c, start, *a, **k: (
        chunks.append((start, c.shape[1])), chunk(src, c, start, *a, **k))[1]
    got = sched.serve([Request(p, max_new_tokens=4) for p in prompts])
    assert chunks == [(64, 1), (32, 1)]
    ref = port(False)[1].serve([Request(p, max_new_tokens=4)
                                for p in prompts])
    with full_length_caches():
        je = JEngine(jcfg, None, jp, None, JEngineConfig(
            K=0, max_new_tokens=4, drafter_mode="none", max_len=128), 2)
        jr = JScheduler(je).serve([JRequest(p, max_new_tokens=4)
                                   for p in prompts])
    for g, r, j in zip(got["results"], ref["results"], jr["results"]):
        np.testing.assert_array_equal(g["tokens"], r["tokens"])
        np.testing.assert_array_equal(g["tokens"], j["tokens"])


def test_sampled_stream_matches_jax_engine():
    """One sampled gemma2 stream (the final softcap shapes the warped
    distribution), drafts sampled too: tokens equal the JAX engine's
    except after a decision of margin < 1e-4; keys equal."""
    policy = dict(temperature=0.8, top_k=50, top_p=0.95, seed=3)
    prompts = np.random.default_rng(6).integers(1, 1000, (2, 30)).astype(
        np.int32)
    (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp) = models(GEMMA2)
    kw = _ecfg(draft_sampling=True)
    with full_length_caches():
        je = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(
            sampling=JSamplingParams(**policy), **kw), 2)
        jr = je.run(jnp.asarray(prompts))
    te = Engine(tcfg, dcfg, tp, dp, EngineConfig(
        sampling=SamplingParams(**policy), **kw), 2, device="cpu")
    with MarginLog() as log:
        tr = te.run(prompts)
    assert log.margins
    want = np.asarray(jr["tokens"])
    compared = 0
    for b in range(2):
        diff = np.flatnonzero(tr["tokens"][b, 30:] != want[b, 30:])
        if len(diff):
            pos = 30 + int(diff[0])
            assert log.min_margin(policy["seed"], 30, pos) < NEAR_TIE, (b, pos)
        compared += len(diff) == 0
    assert compared >= 1
    np.testing.assert_array_equal(
        tr["state"]["sampling"]["key"].numpy(),
        np.asarray(jr["state"]["sampling"]["key"]).astype(np.int64))


# ---------------------------------------------------------------------------
# the prefix cache on a ring target, and the per-slot ring leaves
# ---------------------------------------------------------------------------

def _preamble_prompts():
    """Four prompts sharing a 100-token preamble, tails 10/13/7/20."""
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 200, 100).astype(np.int32)
    return [np.concatenate([pre, rng.integers(1, 200, t).astype(np.int32)])
            for t in (10, 13, 7, 20)]


@lru_cache(maxsize=None)
def prefix_runs():
    """gemma2 at max_len 160, paged, page 8, K 2, batch 2, budget 12: the
    JAX scheduler with its own ring caches, prefix cache off and on, and
    the port's with its cache off and on."""
    (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp) = models(GEMMA2)
    prompts = _preamble_prompts()
    kw = dict(K=K, max_new_tokens=12, drafter_mode="parallel", max_len=160,
              kv_layout="paged", page_size=PAGE)
    out = {}
    for cache in (False, True):
        je = JEngine(jcfg, jdcfg, jp, jdp,
                     JEngineConfig(prefix_cache=cache, **kw), 2)
        te = Engine(tcfg, dcfg, tp, dp, EngineConfig(prefix_cache=cache, **kw),
                    2, device="cpu")
        out["jax", cache] = JScheduler(je).serve(
            [JRequest(p, max_new_tokens=12, rid=i)
             for i, p in enumerate(prompts)])
        out["port", cache] = Scheduler(te).serve(
            [Request(p, max_new_tokens=12, rid=i)
             for i, p in enumerate(prompts)])
        out["engine", cache] = te
    return out


def test_prefix_cache_idle_for_ring_targets():
    """The port builds no prefix cache for a target with rings, even when
    the config asks for one: no hit, every stream equal to the cold
    serve's."""
    runs = prefix_runs()
    on, off, eng = runs["port", True], runs["port", False], runs["engine", True]
    assert eng.ring and eng.prefix_cache is None
    assert on["cache_hit_tokens"] == on["cache_hit_requests"] == 0
    for a, b in zip(on["results"], off["results"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["cached_tokens"] == 0
    assert on["events"] == off["events"]


def test_reference_prefix_hit_on_rings_differs_from_cold():
    """Pin of the JAX package's fault the port departs from: with ring
    caches its prefix cache still hits (mapping the global layers' pages;
    the local layers' per-slot rings never receive the preamble), and a
    hit's stream parts from the cold serve's."""
    runs = prefix_runs()
    on, off = runs["jax", True], runs["jax", False]
    hits = [r for r in on["results"] if r["cached_tokens"] > 0]
    assert len(hits) >= 1
    cold = {r["rid"]: r["tokens"] for r in off["results"]}
    assert any(not np.array_equal(r["tokens"], cold[r["rid"]]) for r in hits)
    # the port's cold serve equals the reference's cold one
    for a, b in zip(runs["port", False]["results"], off["results"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_ring_leaves_ride_admission_swap_and_copy():
    """A paged state mixing pools (global layers) and per-slot rings
    (local layers): ``admit_pages`` writes a slot's ring row, a swap
    round trip (``extract_slot`` then ``admit_pages`` into other pages)
    restores it bitwise, and ``copy_page`` leaves every ring untouched."""
    _, te = _engines(GEMMA2, 3, kv_layout="paged", pool_pages=30)
    state = te.blank_state()
    prompt = np.random.default_rng(3).integers(1, 1000, 70).astype(np.int32)
    state, _, _ = te.prefill_into_slot(state, prompt, 1)
    ring = state["tcache"]["blocks"][0]
    assert ring["ring"] and int(ring["positions"][1].max()) == 69
    assert bool((ring["positions"][[0, 2]] == -1).all())
    pages = torch.tensor(te._slot_pages[1], dtype=torch.int32)
    snap = cache_ops.extract_slot(te._core(state), 1, pages, te.pspec)
    assert snap["tcache"]["blocks"][0]["k"].shape == (
        1, 64 + K + 1, te.tcfg.n_kv_heads, 32)
    before = {n: ring[n].clone() for n in ("k", "v", "positions")}
    cache_ops.copy_page(te._core(state), int(pages[0]), 29, te.pspec)
    for n in ("k", "v", "positions"):
        assert torch.equal(ring[n], before[n])
    fresh = torch.tensor(list(range(10, 10 + len(pages))), dtype=torch.int32)
    cache_ops.admit_pages(te._core(state), snap, 2, fresh, te.pspec)
    for n in ("k", "v", "positions"):
        assert torch.equal(ring[n][2], ring[n][1])
    glob = state["tcache"]["blocks"][1]
    for a, b in zip(pages.tolist(), fresh.tolist()):
        assert torch.equal(glob["positions"][b], glob["positions"][a])
        assert torch.equal(glob["k"][b], glob["k"][a])

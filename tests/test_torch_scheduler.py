"""The port's continuous-batching scheduler on the CPU.

Against the JAX package's ``Scheduler.serve`` on the same workload
(seeded prompt lengths and budgets, Exp(1) arrival gaps on the virtual
clock, an EOS id that ends some streams early), for the contiguous and the
paged-incremental layouts, the paged pool small enough that requests are
preempted: per request the tokens, ``n_new``, ``iters`` and ``n_preempt``
are equal, and so are the event trace (kind, request, virtual time),
``iterations``, ``makespan_vt``, ``preemptions`` and ``peak_pages``;
logprobs within 3e-5 (float32, sums in another order).

Inside the port: paged == contiguous == ``Engine.run`` tokens; parallel ==
ar == none; a preempted stream equals the uninterrupted one; ``sync_every``
does not change a stream; the allocator holds no page after ``serve``; a
request refilled into a neighbouring slot mid-stream leaves a running one
unchanged.

Mixed greedy/sampled batches (even requests greedy, odd ones sampled with
their own seeds, stop tokens and policy budgets), against the JAX package
on both layouts, the paged pool preempting sampled requests: tokens equal,
except after a decision whose margin is below 1e-4 (a greedy request's
top-2 logit gap, a sampled request's ``serving.margins``), after which a
stream is not compared; events equal. Inside the port a sampled stream is
a function of (seed, prefix): served alone, in a mixed batch, in another
slot, paged and preempted, it is the same; the greedy rows of a mixed
batch equal an all-greedy serve.

The reduced qwen2-1.5b (2 layers, d 256) in float32 with a 1-layer
drafter, weights converted from the JAX package's."""
import jax
import numpy as np
import pytest

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.margins import MarginLog
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
import torch_threads  # noqa: F401  (torch threads per xdist worker)

B, K, MAX_LEN, PAGE, POOL, N_REQ = 3, 3, 128, 8, 10, 8
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(11))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(12))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    return (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp)


def _ecfg(**kw):
    base = dict(K=K, max_new_tokens=16, drafter_mode="parallel",
                max_len=MAX_LEN, page_size=PAGE, pool_pages=POOL)
    base.update(kw)
    return base


def _engine(models, mode="parallel", batch=B, **kw):
    tcfg, dcfg, tp, dp = models[1]
    use_d = mode != "none"
    return Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                  EngineConfig(**_ecfg(drafter_mode=mode,
                                       K=K if use_d else 0, **kw)),
                  batch, device="cpu")


def _workload(vocab, seed=7):
    """(prompt, budget, arrival) per request: lengths and budgets in
    6..20, Exp(1) gaps; prompts avoid the drafter's mask token."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(6, 21, N_REQ)
    budgets = rng.integers(6, 21, N_REQ)
    arrivals = np.cumsum(rng.exponential(1.0, N_REQ))
    return [(rng.integers(1, vocab - 1, n).astype(np.int32), int(b),
             float(t)) for n, b, t in zip(lens, budgets, arrivals)]


def _requests(cls, work):
    return [cls(p, max_new_tokens=b, arrival_time=t, rid=i)
            for i, (p, b, t) in enumerate(work)]


@pytest.fixture(scope="module")
def eos_id(models):
    """A token the contiguous port run emits mid-stream in request 2, so
    that EOS ends at least one stream before its budget."""
    work = _workload(models[1][0].vocab_size)
    rep = Scheduler(_engine(models)).serve(_requests(Request, work))
    return int(rep["results"][2]["tokens"][3])


@pytest.fixture(scope="module")
def served(models, eos_id):
    (jcfg, jdcfg, jp, jdp), _ = models
    work = _workload(jcfg.vocab_size)
    out = {}
    for layout in ("contiguous", "paged"):
        je = JEngine(jcfg, jdcfg, jp, jdp,
                     JEngineConfig(**_ecfg(kv_layout=layout)), B)
        jr = JScheduler(je, eos_id=eos_id).serve(_requests(JRequest, work))
        te = _engine(models, kv_layout=layout)
        tr = Scheduler(te, eos_id=eos_id).serve(_requests(Request, work))
        out[layout] = (jr, tr, te, work)
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_serve_matches_jax_scheduler(served, eos_id, layout):
    jr, tr, te, work = served[layout]
    assert len(tr["results"]) == len(jr["results"]) == N_REQ
    for t, j in zip(tr["results"], jr["results"]):
        assert t["rid"] == j["rid"]
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
        for key in ("n_new", "iters", "n_preempt"):
            assert t[key] == j[key], (t["rid"], key)
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], atol=3e-5,
                                   rtol=3e-5)
        assert t["acceptance_length"] == pytest.approx(j["acceptance_length"])
    assert tr["events"] == [tuple(e) for e in jr["events"]]
    for key in ("iterations", "makespan_vt", "preemptions", "peak_pages",
                "total_new_tokens", "p50_latency_vt", "p99_latency_vt",
                "p50_wait_vt", "p99_wait_vt"):
        assert tr[key] == jr[key], key
    # the workload exercises what it is meant to
    trimmed = [r for r, (_, b, _) in zip(tr["results"], work)
               if r["n_new"] < b]
    assert trimmed and all(r["tokens"][-1] == eos_id for r in trimmed)
    if layout == "paged":
        assert tr["preemptions"] > 0 and tr["peak_pages"] <= POOL
        assert te.allocator.n_used == 0


def _serve_tokens(eng, prompts, budget, **sched_kw):
    rep = Scheduler(eng, **sched_kw).serve(
        [Request(p, max_new_tokens=budget) for p in prompts])
    if eng.paged:
        assert eng.allocator.n_used == 0
    return rep, [r["tokens"] for r in rep["results"]]


def test_layouts_and_whole_batch_run_agree(models):
    """paged (preempting) == contiguous == Engine.run, per request; also
    paged with pages reserved up front and admissions not bucketed."""
    P, NEW = 12, 10
    prompts = np.random.default_rng(1).integers(
        1, models[1][0].vocab_size - 1, (B, P)).astype(np.int32)
    run = _engine(models, max_new_tokens=NEW).run(prompts)["tokens"]
    _, contiguous = _serve_tokens(_engine(models), prompts, NEW)
    rep, paged = _serve_tokens(_engine(models, kv_layout="paged",
                                       pool_pages=6), prompts, NEW)
    assert rep["preemptions"] > 0
    _, upfront = _serve_tokens(_engine(models, kv_layout="paged",
                                       kv_growth="upfront", pool_pages=6,
                                       bucket_prefill=False), prompts, NEW)
    for b in range(B):
        for got in (contiguous, paged, upfront):
            np.testing.assert_array_equal(got[b], run[b, P:P + NEW])


def test_drafter_modes_agree_and_preemption_is_lossless(models):
    """parallel == ar == none under pool pressure, each equal to the
    uninterrupted stream (an ample pool); sync_every 2 changes nothing."""
    work = _workload(models[1][0].vocab_size, seed=3)
    prompts = [p for p, _, _ in work]
    rep, want = _serve_tokens(_engine(models, kv_layout="paged",
                                      pool_pages=0), prompts, 14)
    assert rep["preemptions"] == 0
    for mode in ("parallel", "ar", "none"):
        eng = _engine(models, mode=mode, kv_layout="paged", pool_pages=7)
        rep, got = _serve_tokens(eng, prompts, 14)
        assert rep["preemptions"] > 0, mode
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    _, got = _serve_tokens(_engine(models, kv_layout="paged", pool_pages=7),
                           prompts, 14, sync_every=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mid_stream_refill_leaves_neighbour_unchanged(models, layout):
    """A long request served alone emits the same tokens as when short
    requests keep being admitted into the other slot beside it."""
    rng = np.random.default_rng(9)
    vocab = models[1][0].vocab_size
    long = rng.integers(1, vocab - 1, 10).astype(np.int32)
    shorts = [rng.integers(1, vocab - 1, 7).astype(np.int32)
              for _ in range(3)]
    eng = _engine(models, batch=2, kv_layout=layout, pool_pages=0)
    alone = Scheduler(eng).serve([Request(long, max_new_tokens=40)])
    rep = Scheduler(eng).serve(
        [Request(long, max_new_tokens=40)]
        + [Request(s, max_new_tokens=4, arrival_time=2.0 + 3 * i)
           for i, s in enumerate(shorts)])
    admits = [e for e in rep["events"] if e[1] == "admit"]
    assert len(admits) == 4 and admits[-1][0] > 2.0     # refills mid-stream
    np.testing.assert_array_equal(rep["results"][0]["tokens"],
                                  alone["results"][0]["tokens"])


# ---------------------------------------------------------------------------
# mixed greedy / sampled serving
# ---------------------------------------------------------------------------

def _policy(cls, i, eos):
    """Request i's policy: even greedy (the engine default); odd sampled
    on seed 100 + i, request 3 also stopping at ``eos`` and request 5
    carrying its budget in the policy."""
    if i % 2 == 0:
        return None
    kw = dict(temperature=0.9, top_k=40, top_p=0.9, seed=100 + i)
    if i == 3:
        kw["stop_token_ids"] = (eos,)
    if i == 5:
        kw["max_new_tokens"] = 9
    return cls(**kw)


def _mixed_requests(cls, spcls, work, eos):
    return [cls(p, max_new_tokens=None if i == 5 else b, arrival_time=t,
                rid=i, sampling=_policy(spcls, i, eos))
            for i, (p, b, t) in enumerate(work)]


def _greedy_gap(eng, context):
    """Top-2 logit gap of the port's target after ``context`` (1-D)."""
    ids = torch.as_tensor(np.asarray(context, np.int32)[None])
    with torch.no_grad():
        logits = eng.model.forward(eng.tparams, ids,
                                   head_last_only=True).logits[0, -1]
    top2 = logits.topk(2).values
    return float(top2[0] - top2[1])


def _diverged(eng, log, req, got, want):
    """None when the streams are equal; else assert that they part after
    a near-tie decision and return its position."""
    n = min(len(got), len(want))
    diff = np.flatnonzero(got[:n] != want[:n])
    if not len(diff) and len(got) == len(want):
        return None
    j = int(diff[0]) if len(diff) else n
    P = req.prompt.size
    if req.sampling is None or req.sampling.is_greedy:
        margin = _greedy_gap(eng, np.concatenate([req.prompt, want[:j]]))
    else:
        margin = log.min_margin(req.sampling.seed, P, P + j)
    assert margin < NEAR_TIE, (req.rid, j, margin)
    return P + j


@pytest.fixture(scope="module")
def mixed(models, eos_id):
    (jcfg, jdcfg, jp, jdp), _ = models
    work = _workload(jcfg.vocab_size)
    out = {}
    for layout, ds in (("contiguous", False), ("paged", True)):
        kw = _ecfg(kv_layout=layout, draft_sampling=ds)
        je = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(**kw), B)
        jr = JScheduler(je, eos_id=eos_id).serve(
            _mixed_requests(JRequest, JSamplingParams, work, eos_id))
        te = _engine(models, kv_layout=layout, draft_sampling=ds)
        reqs = _mixed_requests(Request, SamplingParams, work, eos_id)
        with MarginLog() as log:
            tr = Scheduler(te, eos_id=eos_id).serve(reqs)
        out[layout] = (jr, tr, te, reqs, log)
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mixed_serve_matches_jax_scheduler(mixed, layout):
    jr, tr, te, reqs, log = mixed[layout]
    assert len(tr["results"]) == len(jr["results"]) == N_REQ
    parted = False
    for req, t, j in zip(reqs, tr["results"], jr["results"]):
        assert t["rid"] == j["rid"] == req.rid
        if _diverged(te, log, req, t["tokens"], j["tokens"]) is not None:
            parted = True
            continue
        for key in ("n_new", "iters", "n_preempt"):
            assert t[key] == j[key], (t["rid"], key)
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], atol=3e-5,
                                   rtol=3e-5)
    if not parted:
        assert tr["events"] == [tuple(e) for e in jr["events"]]
        for key in ("iterations", "makespan_vt", "preemptions",
                    "peak_pages", "total_new_tokens"):
            assert tr[key] == jr[key], key
    # the workload exercises what it is meant to
    res = {r["rid"]: r for r in tr["results"]}
    assert res[5]["n_new"] == 9                   # the policy's budget
    assert log.margins                             # sampled decisions ran
    if layout == "paged":
        assert any(res[r.rid]["n_preempt"] for r in reqs
                   if r.sampling is not None and not r.sampling.is_greedy)
        assert te.allocator.n_used == 0


def test_stop_token_ids_trim_inclusive(models):
    """A request's own stop token ends its stream at the first occurrence,
    kept; the engine-wide eos_id is unset."""
    work = _workload(models[1][0].vocab_size, seed=2)
    sp = SamplingParams(temperature=0.9, seed=11)
    free = Scheduler(_engine(models)).serve(
        [Request(p, max_new_tokens=16, sampling=sp) for p, _, _ in work[:2]])
    stop = int(free["results"][0]["tokens"][4])
    rep = Scheduler(_engine(models)).serve(
        [Request(p, max_new_tokens=16, sampling=SamplingParams(
            temperature=0.9, seed=11, stop_token_ids=(stop,)))
         for p, _, _ in work[:2]])
    for f, r in zip(free["results"], rep["results"]):
        hits = np.flatnonzero(f["tokens"] == stop)
        n = int(hits[0]) + 1 if len(hits) else len(f["tokens"])
        np.testing.assert_array_equal(r["tokens"], f["tokens"][:n])
    assert rep["results"][0]["n_new"] <= 5


def test_sampled_stream_is_a_function_of_seed_and_prefix(models):
    """One sampled request served alone, then beside other requests
    (contiguous; and arriving after them, so in another slot), paged under
    pool pressure that preempts it, and with sync_every 2: the same
    stream."""
    work = _workload(models[1][0].vocab_size, seed=5)
    sp = SamplingParams(temperature=1.0, top_k=30, seed=77)

    def others():
        return [Request(p, max_new_tokens=14, sampling=SamplingParams(
            temperature=0.8, seed=200 + i) if i % 2 else None)
                for i, (p, _, _) in enumerate(work[1:5])]

    def serve(eng, arrival=0.0, **kw):
        me = Request(work[0][0], max_new_tokens=20, sampling=sp,
                     arrival_time=arrival)
        reqs = [me] + ([] if eng is None else others())
        rep = Scheduler(eng or _engine(models), **kw).serve(reqs)
        return rep["results"][0], me

    with MarginLog() as log:
        want, me = serve(None)
        runs = {"mixed": serve(_engine(models)),
                "later slot": serve(_engine(models), arrival=0.5),
                # arriving last, it has the lowest priority: the victim
                "paged, preempted": serve(_engine(models, kv_layout="paged",
                                                  pool_pages=6), arrival=0.5),
                "paged, sync_every 2": serve(_engine(
                    models, kv_layout="paged", pool_pages=6), arrival=0.5,
                    sync_every=2)}
    eng = _engine(models)
    for name, (got, req) in runs.items():
        _diverged(eng, log, req, got["tokens"], want["tokens"])
    assert runs["later slot"][1].slot != 0
    assert runs["paged, preempted"][0]["n_preempt"] > 0


def test_greedy_rows_of_a_mixed_batch_equal_all_greedy(models, mixed):
    """The greedy requests of the mixed serve emit what an all-greedy serve
    of the same workload emits (paged, preempting)."""
    _, tr, te, reqs, log = mixed["paged"]
    work = _workload(models[1][0].vocab_size)
    greedy = Scheduler(_engine(models, kv_layout="paged")).serve(
        _requests(Request, work))
    for req, got, want in zip(reqs, tr["results"], greedy["results"]):
        if req.sampling is None or req.sampling.is_greedy:
            n = min(len(got["tokens"]), len(want["tokens"]))
            _diverged(te, log, req, got["tokens"][:n], want["tokens"][:n])


def test_sampled_resume_claims_one_position_less(models):
    """The engine's page claim of a no-commit resume matches the JAX
    engine's, one position under a fresh admission of the same length."""
    (jcfg, jdcfg, jp, jdp), _ = models
    kw = _ecfg(kv_layout="paged")
    je = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(**kw), B)
    te = _engine(models, kv_layout="paged")
    saw_less = False
    for n in range(1, 40):
        for resume in (False, True):
            assert te.initial_pages(n, 16, resume=resume) == \
                je.initial_pages(n, 16, resume=resume), (n, resume)
            assert te.can_admit(n, 16, resume=resume) == \
                je.can_admit(n, 16, resume=resume)
        saw_less |= te.initial_pages(n, resume=True) < te.initial_pages(n)
    assert saw_less

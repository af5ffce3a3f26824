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
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import Request, Scheduler

B, K, MAX_LEN, PAGE, POOL, N_REQ = 3, 3, 128, 8, 10, 8


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


def test_request_with_a_sampling_policy_raises():
    with pytest.raises(NotImplementedError, match="sampled"):
        Request(np.arange(1, 5), sampling=object())


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

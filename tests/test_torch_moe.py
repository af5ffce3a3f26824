"""The MoE family in the port against the JAX package, on the CPU in float32
with the plain attention: dbrx-132b (16 experts, top-4, every layer) and
llama4-maverick (128 experts, top-1 on the odd layers, a shared expert,
local attention on three layers of four and NoPE on the fourth); weights
converted from the JAX package's, inputs made with numpy from a seed.
Tolerance 3e-5 (float32 on both sides, sums in another order); expert
choices, dropped slots, tokens and events equal.

Two routings. ``reduced()`` alone gives 4 experts at capacity factor 4.0,
which drops nothing; the *published* routing keeps the reduced width (d
256, 4 heads of 32) with the full config's MoE: dbrx 16 / top-4 / 1.25,
llama4 128 / top-1 / 1.25 with its shared expert. There the capacity
``int(T*K/E * 1.25) + 1`` drops tokens, and each test that means to show
drops asserts that the reference dropped some.

llama4's super-block is 4 layers (its attention pattern and the MoE
interleave): at 4 layers it is one block, at 5 a block and a tail layer,
and its first global (NoPE) layer is layer 3. Its local layers' window is
64 in the reduced config, and it is served at max_len 64, where neither
package makes a ring.

Capacity couples the tokens of a call, so a verify (B x (K+1) tokens) and
a plain decode step (B tokens) drop different tokens: greedy speculation
is not lossless at the published routing, in the reference as in the port,
which copies it (``test_engine_run_matches_jax_engine``)."""
import contextlib
import copy
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
from repro.models import moe as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import Request, Scheduler
import torch_threads  # noqa: F401  (torch threads per xdist worker)

TOL = 3e-5
DBRX, LLAMA4 = "dbrx-132b", "llama4-maverick-400b-a17b"
ROUTINGS = ("published", "reduced")
# moe_apply's call shapes (B, S): a prefill, a long row, a verify of 8 rows
# at K 5, a plain decode of 8 rows
SHAPES = ((2, 6), (1, 16), (8, 6), (8, 1))
K, PAGE, MAX_LEN = 2, 8, 64


def _cfg(get, arch, n_layers, routing):
    full = get(arch)
    cfg = full.reduced().replace(n_layers=n_layers)
    return cfg.replace(moe=full.moe) if routing == "published" else cfg


def _moe_kw(cfg):
    m = cfg.moe
    return dict(n_experts=m.n_experts, top_k=m.top_k,
                capacity_factor=m.capacity_factor, variant=cfg.mlp_variant,
                n_shared=m.n_shared_experts)


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=tol, err_msg=msg)


def _drops(aux, T, K_):
    """Dropped slots of a call, from its drop_frac."""
    return int(round(float(aux["drop_frac"]) * T * K_))


@lru_cache(maxsize=None)
def models(arch, n_layers, routing="published"):
    """((jcfg, jdcfg, jparams, jdparams), (tcfg, dcfg, tparams, dparams)):
    the reduced config cut to ``n_layers`` under ``routing``, a 1-layer
    drafter, on both sides."""
    jcfg = _cfg(jget_config, arch, n_layers, routing)
    tcfg = _cfg(get_config, arch, n_layers, routing)
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(41))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(42))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    return (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def moe_layer(arch, routing):
    """One MoE layer's JAX params and the port's copy, and the JAX
    outputs at every shape of SHAPES."""
    cfg = _cfg(jget_config, arch, 2, routing)
    m = cfg.moe
    jp = JM.moe_init(jax.random.PRNGKey(5), cfg.d_model, cfg.d_ff,
                     m.n_experts, m.n_shared_experts, cfg.mlp_variant)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(9)
    apply = jax.jit(lambda p, x: JM.moe_apply(p, x, **_moe_kw(cfg)))
    runs = {}
    for shape in SHAPES:
        x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
        out, aux = apply(jp, jnp.asarray(x))
        runs[shape] = (x, np.asarray(out), jax.tree.map(np.asarray, aux))
    return cfg, jp, tp, runs


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("arch", [DBRX, LLAMA4])
def test_moe_apply_matches_reference(arch, routing, shape):
    """``moe_apply`` at a call shape: out, lb_loss and z_loss within 3e-5,
    the same dropped slots, and the same experts as the reference's router
    (its top-K read back from the reference's own softmax)."""
    cfg, jp, tp, runs = moe_layer(arch, routing)
    x, want, jaux = runs[shape]
    out, aux = TM.moe_apply(tp, torch.from_numpy(x), **_moe_kw(cfg))
    _close(out, want)
    for name in ("lb_loss", "z_loss"):
        _close(aux[name], jaux[name], msg=name)
    T, K_ = shape[0] * shape[1], cfg.moe.top_k
    assert _drops(aux, T, K_) == _drops(jaux, T, K_)
    xf = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    _, jexp = jax.lax.top_k(probs, K_)
    _, _, _, texp = TM.route(tp, torch.from_numpy(xf), K_)
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))


@pytest.mark.parametrize("arch", [DBRX, LLAMA4])
def test_published_routing_drops_and_reduced_does_not(arch):
    """At the published routing the reference drops slots at some call
    shape (and the port drops the same ones, above); ``reduced()`` alone
    (capacity factor 4.0 over 4 experts) drops none at any shape."""
    for routing, want_drops in (("published", True), ("reduced", False)):
        cfg, _, _, runs = moe_layer(arch, routing)
        drops = [_drops(aux, s[0] * s[1], cfg.moe.top_k)
                 for s, (_, _, aux) in runs.items()]
        assert any(drops) is want_drops, (routing, drops)


def test_router_ties_follow_lax_top_k():
    """A zero router ties every expert: the port picks experts 0..K-1 with
    gates 1/K, as ``lax.top_k``; with the router's columns equal in pairs
    the lower of each tied pair comes first, as in the reference."""
    cfg, jp, tp, runs = moe_layer(DBRX, "published")
    x = runs[(2, 6)][0]
    kw = _moe_kw(cfg)
    for make in (np.zeros_like,
                 lambda r: np.repeat(r[:, ::2], 2, axis=1)):
        router = make(np.asarray(jp["router"]))
        jp2 = dict(jp, router=jnp.asarray(router))
        tp2 = dict(tp, router=torch.from_numpy(router))
        xf = x.reshape(-1, cfg.d_model)
        probs = jax.nn.softmax(jnp.asarray(xf) @ jp2["router"], axis=-1)
        jgate, jexp = jax.lax.top_k(probs, cfg.moe.top_k)
        _, _, gate, texp = TM.route(tp2, torch.from_numpy(xf), cfg.moe.top_k)
        np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
        _close(gate, np.asarray(jgate) / np.asarray(jgate).sum(-1,
                                                                keepdims=True))
        out, aux = TM.moe_apply(tp2, torch.from_numpy(x), **kw)
        jout, jaux = JM.moe_apply(jp2, jnp.asarray(x), **kw)
        _close(out, jout)
        assert _drops(aux, 12, 4) == _drops(jaux, 12, 4)
    np.testing.assert_array_equal(
        TM.route(dict(tp, router=torch.zeros_like(tp["router"])),
                 torch.from_numpy(xf), 4)[3].numpy(),
        np.tile(np.arange(4), (12, 1)))


def test_capacity_at_an_exact_integer_product():
    """16 tokens, top-4 of 16 experts at 1.25: T*K/E * 1.25 is exactly 5.0,
    so C is 6. Every token is steered to experts 0-3, which take 6 tokens
    each in token order: 24 of 64 slots are kept, in both packages, and
    the kept tokens are the first six."""
    cfg, jp, tp, _ = moe_layer(DBRX, "published")
    assert TM.capacity(16, 4, 16, 1.25) == 6 == int((16 * 4) / 16 * 1.25) + 1
    router = np.zeros_like(np.asarray(jp["router"]))
    router[0, :4] = [4.0, 3.0, 2.0, 1.0]
    x = np.random.default_rng(2).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32) * 0.01
    x[..., 0] = 5.0
    jp2 = dict(jp, router=jnp.asarray(router))
    tp2 = dict(tp, router=torch.from_numpy(router))
    kw = _moe_kw(cfg)
    out, aux = TM.moe_apply(tp2, torch.from_numpy(x), **kw)
    jout, jaux = JM.moe_apply(jp2, jnp.asarray(x), **kw)
    assert _drops(aux, 16, 4) == _drops(jaux, 16, 4) == 64 - 24
    _close(out, jout)
    # tokens 6.. lost every expert: their routed output is zero
    assert float(out[0, 6:].abs().max()) == 0.0
    assert bool((out[0, :6].abs().amax(-1) > 0).all())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

FORWARDS = [(DBRX, 2), (LLAMA4, 4), (LLAMA4, 5)]


@pytest.mark.parametrize("arch,n_layers", FORWARDS,
                         ids=[f"{a.split('-')[0]}-{n}" for a, n in FORWARDS])
def test_converted_tree_matches_init_params(arch, n_layers):
    """The converted tree has ``init_params``'s structure and shapes: a
    ``moe`` subtree on every dbrx layer and on llama4's odd layers (a
    ``shared`` MLP beside its experts), ``mlp`` elsewhere; cast to
    bfloat16, the routers and norms stay float32."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models(arch, n_layers)
    mine = get_model(tcfg).init(torch.Generator().manual_seed(0),
                                device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert shapes(tp) == shapes(mine)
    kinds = ["moe" if "moe" in b else "mlp" for b in tp["blocks"]]
    assert kinds == ["moe" if tcfg.is_moe_layer(li) else "mlp"
                     for li in range(n_layers)]
    assert kinds == (["moe"] * n_layers if arch == DBRX
                     else ["mlp", "moe"] * (n_layers // 2)
                     + ["mlp"] * (n_layers % 2))
    assert all(("shared" in b["moe"]) == (arch == LLAMA4)
               for b in tp["blocks"] if "moe" in b)
    bf = convert.target_params(jax.tree.map(np.asarray, jp), tcfg,
                               dtype=torch.bfloat16)
    for b, f32 in zip(bf["blocks"], tp["blocks"]):
        assert b["ln1"].dtype == torch.float32
        if "moe" in b:
            assert b["moe"]["router"].dtype == torch.float32
            assert b["moe"]["w_up"].dtype == torch.bfloat16
            np.testing.assert_array_equal(b["moe"]["router"].numpy(),
                                          f32["moe"]["router"].numpy())


@lru_cache(maxsize=None)
def forwards(arch, n_layers, routing):
    """The JAX forwards in train, prefill and decode modes on one set of
    inputs, and the inputs."""
    (jcfg, _, jp, _), _ = models(arch, n_layers, routing)
    jm = jget_model(jcfg)
    rng = np.random.default_rng(13)
    B, P = 2, 9
    toks = rng.integers(0, 1000, (B, P)).astype(np.int32)
    blk = rng.integers(0, 1000, (B, K + 1)).astype(np.int32)
    pos = (P + np.arange(K + 1, dtype=np.int32))[None].repeat(B, 0)
    train = jm.forward(jp, jnp.asarray(toks), mode="train")
    pre = jm.forward(jp, jnp.asarray(toks), mode="prefill",
                     cache=jm.make_cache(B, MAX_LEN, dtype=jnp.float32))
    dec = jm.forward(jp, jnp.asarray(blk), mode="decode",
                     positions=jnp.asarray(pos), cache=pre.cache)
    return (toks, blk, pos), [jax.tree.map(np.asarray, (o.logits, o.taps,
                                                        o.cache, o.aux))
                              for o in (train, pre, dec)]


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("arch,n_layers", FORWARDS,
                         ids=[f"{a.split('-')[0]}-{n}" for a, n in FORWARDS])
def test_forward_matches_reference(arch, n_layers, routing):
    """train, prefill into a cache and a decode block read against it:
    logits, taps, every cache leaf and the aux losses (summed over the MoE
    layers) within 3e-5. llama4's layer 3 is global and takes no RoPE: its
    cached keys are the raw projections."""
    (toks, blk, pos), want = forwards(arch, n_layers, routing)
    _, (tcfg, _, tp, _) = models(arch, n_layers, routing)
    model = get_model(tcfg)
    cache = model.make_cache(2, MAX_LEN, dtype=torch.float32, device="cpu",
                             block=K + 1)
    got = [model.forward(tp, torch.from_numpy(toks), mode="train"),
           model.forward(tp, torch.from_numpy(toks), mode="prefill",
                         cache=cache)]
    # the decode updates the cache in place: keep the prefill's apart
    caches = [None, copy.deepcopy(got[1].cache)]
    got.append(model.forward(tp, torch.from_numpy(blk), mode="decode",
                             positions=torch.from_numpy(pos),
                             cache=got[1].cache))
    caches.append(got[2].cache)
    for what, o, tcache, (logits, taps, jcache, aux) in zip(
            ("train", "prefill", "decode"), got, caches, want):
        _close(o.logits, logits, msg=f"{what} logits")
        _close(o.taps, taps, msg=f"{what} taps")
        for name in ("lb_loss", "z_loss"):
            _close(o.aux[name], aux[name], msg=f"{what} {name}")
        assert float(o.aux["lb_loss"]) > 0
        if jcache is None:
            continue
        ref = convert.target_cache(jcache, tcfg)["blocks"]
        assert len(tcache["blocks"]) == len(ref) == n_layers
        for li, (t, j) in enumerate(zip(tcache["blocks"], ref)):
            assert not t["ring"] and t["ring"] == j["ring"]
            np.testing.assert_array_equal(t["positions"], j["positions"])
            for name in ("k", "v"):
                _close(t[name], j[name], msg=f"{what} layer {li} {name}")
    if arch == LLAMA4:      # RoPE on layer 3 would part from the reference
        assert tcfg.attn_kind(3) == "global" and tcfg.nope_on_global
        rope = get_model(tcfg.replace(nope_on_global=False)).forward(
            tp, torch.from_numpy(toks), mode="train")
        assert np.abs(rope.logits.numpy() - want[0][0]).max() > 1e-3


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _ecfg(**kw):
    base = dict(K=K, max_new_tokens=12, drafter_mode="parallel",
                max_len=MAX_LEN, page_size=PAGE)
    base.update(kw)
    if base["drafter_mode"] == "none":
        base["K"] = 0
    return base


def _engines(arch, n_layers, batch=2, **kw):
    (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp) = models(arch, n_layers)
    cfg = _ecfg(**kw)
    use_d = cfg["drafter_mode"] != "none"
    je = JEngine(jcfg, jdcfg if use_d else None, jp, jdp if use_d else None,
                 JEngineConfig(**cfg), batch)
    te = Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                EngineConfig(**cfg), batch, device="cpu")
    return je, te


ENGINE_RUNS = [(DBRX, 2), (LLAMA4, 4)]
# whether the reference's stream parts from its none stream, at the
# published routing on engine_run's prompts
PARTS_FROM_NONE = {(DBRX, "parallel"): True, (DBRX, "ar"): True,
                   (LLAMA4, "parallel"): False, (LLAMA4, "ar"): True}


@contextlib.contextmanager
def drop_log():
    """The (call shape, dropped slots) of every port MoE layer call."""
    log, inner = [], T.moe_apply

    def logged(p, x, **kw):
        out, aux = inner(p, x, **kw)
        log.append((tuple(x.shape[:2]),
                    _drops(aux, x.shape[0] * x.shape[1], kw["top_k"])))
        return out, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "moe_apply", logged)
        yield log


@lru_cache(maxsize=None)
def engine_run(arch, n_layers, mode):
    prompts = np.random.default_rng(5).integers(
        1, 1000, (3, 20)).astype(np.int32)
    je, te = _engines(arch, n_layers, batch=3, drafter_mode=mode)
    with drop_log() as log:
        tr = te.run(prompts)
    return je.run(jnp.asarray(prompts)), tr, log


@pytest.mark.parametrize("mode", ["parallel", "ar", "none"])
@pytest.mark.parametrize("arch,n_layers", ENGINE_RUNS,
                         ids=[a.split("-")[0] for a, _ in ENGINE_RUNS])
def test_engine_run_matches_jax_engine(arch, n_layers, mode):
    """Greedy Engine.run (3 rows of 20-token prompts, 12 new tokens) at
    the published routing: tokens, counters and logprobs equal the JAX
    engine's in each mode. Where the reference's parallel or ar stream
    parts from its none stream (capacity over B x (K+1) tokens against B
    drops other tokens), the port's parts at the same position: reference
    behaviour copied on purpose."""
    jr, tr, log = engine_run(arch, n_layers, mode)
    np.testing.assert_array_equal(tr["tokens"], jr["tokens"])
    assert any(d for _, d in log), "no call dropped a slot"
    for leaf in ("new_count", "committed", "iters", "row_iters", "last"):
        np.testing.assert_array_equal(tr["state"][leaf].numpy(),
                                      np.asarray(jr["state"][leaf]), leaf)
    _close(tr["state"]["logprobs"], jr["state"]["logprobs"])
    if mode != "none":
        jnone, tnone, _ = engine_run(arch, n_layers, "none")
        parted = np.asarray(jr["tokens"]) != np.asarray(jnone["tokens"])
        np.testing.assert_array_equal(parted,
                                      tr["tokens"] != tnone["tokens"])
        assert bool(parted.any()) is PARTS_FROM_NONE[(arch, mode)]


def _workload(vocab=1000, n=5, seed=7):
    """(prompt, budget, arrival): prompts of 5-21 tokens, budgets 10-16,
    Exp(1) gaps."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab - 1, int(m)).astype(np.int32), int(b),
             float(t)) for m, b, t in zip(rng.integers(5, 22, n),
                                          rng.integers(10, 17, n),
                                          np.cumsum(rng.exponential(1.0, n)))]


def _requests(cls, work):
    return [cls(p, max_new_tokens=b, arrival_time=t, rid=i)
            for i, (p, b, t) in enumerate(work)]


POLICIES = dict(kv_layout="paged", pool_pages=7, swap="host",
                prefix_cache=True, max_new_tokens=16)


@lru_cache(maxsize=None)
def serves():
    """The workload on 3 slots of dbrx at the published routing: the JAX
    scheduler and the port's over paged KV (a 7-page pool that preempts,
    swap to host, the prefix cache asked for)."""
    work = _workload()
    je, te = _engines(DBRX, 2, batch=3, **POLICIES)
    jr = JScheduler(je).serve(_requests(JRequest, work))
    with drop_log() as log:
        tr = Scheduler(te).serve(_requests(Request, work))
    return jr, tr, te, log


def test_paged_serve_matches_jax_scheduler():
    """Scheduler.serve with staggered arrivals over paged KV: per request
    tokens, counters and logprobs, the event trace and the report's
    counters equal the JAX scheduler's, with a preemption swapped to the
    host and slots dropped in the verifies (idle rows included: their
    tokens take expert capacity as the reference's do); the prefix cache stays idle for MoE, as the JAX engine's
    (``_hits_ok`` admits the dense family alone); both pools end empty."""
    jr, tr, te, log = serves()
    assert len(tr["results"]) == len(jr["results"]) == 5
    assert any(d for (B, S), d in log if (B, S) == (3, K + 1))
    for t, j in zip(tr["results"], jr["results"]):
        assert t["rid"] == j["rid"]
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
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
    assert len(te.host_pool) == 0


def test_prefix_cache_idle_over_two_passes():
    """A shared-preamble workload served twice on a dbrx engine asked for a
    prefix cache equals the cache-off engine's streams, with no hit."""
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 200, 16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(1, 200, t).astype(np.int32)])
               for t in (3, 5, 7)]
    _, warm = _engines(DBRX, 2, kv_layout="paged", prefix_cache=True,
                       max_new_tokens=6)
    _, cold = _engines(DBRX, 2, kv_layout="paged", max_new_tokens=6)

    def serve(eng):
        rep = Scheduler(eng).serve([Request(p, max_new_tokens=6)
                                    for p in prompts])
        return [r["tokens"] for r in rep["results"]], rep
    cold_toks, _ = serve(cold)
    for _ in (1, 2):
        warm_toks, rep = serve(warm)
        for c, w in zip(cold_toks, warm_toks):
            np.testing.assert_array_equal(w, c)
        assert rep["cache_hit_tokens"] == rep["cache_hit_requests"] == 0
    assert warm.prefix_cache is None

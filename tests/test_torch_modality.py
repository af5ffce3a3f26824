"""The VLM and encoder-decoder families in the port against the JAX
package, on the CPU in float32 with the plain attention: internvl2-1b
(qwen2-style LM behind 8 stub vision tokens, early-fused) and whisper-base
(a bidirectional encoder over 16 stub frames, a decoder with
cross-attention, sinusoidal positions), both at ``reduced()`` (2 layers, d
256), weights converted from the JAX package's, a 1-layer drafter, inputs
made with numpy from a seed.

Tolerance 3e-5 (float32 on both sides, sums in another order); tokens,
events and counters equal. The stub extras the port draws
(``registry.make_extras``: threefry, then XLA's ``erf_inv`` polynomial in
torch ops) differ from the JAX package's by at most 3 ulps: the port's
``log1p`` is torch's, a few ulps off XLA's, on about 1% of the elements;
the served streams are equal all the same, explicit extras and the
prompt-keyed stub alike."""
import asyncio
import copy
import zlib
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.data import pipeline as JP
from repro.models import extra_input_shapes as jextra_input_shapes
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models import make_extras as jmake_extras
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import virtual_twin_report as jvirtual_twin_report
from repro.training import TrainConfig as JTrainConfig
from repro.training import Trainer as JTrainer
from repro_torch import convert, prng
from repro_torch.configs import ARCH_IDS, DrafterConfig, get_config
from repro_torch.data import pipeline as P
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.registry import (extra_input_shapes, extras_on,
                                         get_model, make_extras,
                                         takes_extras)
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.streaming import AsyncEngine
from repro_torch.training import TrainConfig, Trainer
import torch_threads  # noqa: F401  (torch threads per xdist worker)

TOL = 3e-5
GTOL = dict(atol=2e-5, rtol=2e-4)
VLM, ENCDEC = "internvl2-1b", "whisper-base"
ARCHS = (VLM, ENCDEC)
K, PAGE, MAX_LEN = 2, 8, 64
# most ulps between the port's stub draws and the JAX package's
EXTRAS_MAX_ULP = 3


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                               rtol=tol, err_msg=msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@lru_cache(maxsize=None)
def models(arch):
    """((jcfg, jdcfg, jparams, jdparams), (tcfg, dcfg, tparams, dparams)):
    the reduced config, a 1-layer drafter, on both sides."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(31))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(32))
    return ((jcfg, jdcfg, jp, jdp),
            (tcfg, dcfg, convert.target_params(_np(jp), tcfg),
             convert.drafter_params(_np(jdp))))


@lru_cache(maxsize=None)
def jextras(arch, batch, seed=7):
    """The JAX package's stub extras at prefill, as numpy."""
    jcfg = models(arch)[0][0]
    return _np(jmake_extras(jcfg, batch, "prefill",
                            jax.random.PRNGKey(seed)))


def _textras(arch, batch, seed=7):
    return {k: torch.from_numpy(np.array(v))
            for k, v in jextras(arch, batch, seed).items()}


# ---------------------------------------------------------------------------
# configs, parameters, helpers, extras
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    """The port's config carries every field of the JAX package's, equal,
    at full width and reduced."""
    for full in (True, False):
        j, t = jget_config(arch), get_config(arch)
        if not full:
            j, t = j.reduced(), t.reduced()
        for name in ("family", "n_layers", "d_model", "n_heads",
                     "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                     "mlp_variant", "qkv_bias", "rope_theta",
                     "tie_embeddings", "positional", "n_encoder_layers",
                     "encoder_seq", "vision_tokens", "vision_dim"):
            assert getattr(t, name) == getattr(j, name), (arch, full, name)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_tree_matches_init_params(arch):
    """The converted tree has ``init_params``'s structure, shapes and
    dtypes: internvl2's ``vis_proj`` (vision_dim, d) and (d, d); whisper's
    encoder and decoder layers unstacked into lists, norms float32 when the
    weights are cast to bfloat16."""
    (_, _, jp, _), (tcfg, _, tp, _) = models(arch)
    mine = get_model(tcfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    assert _shapes(tp) == _shapes(mine)
    if arch == VLM:
        assert tuple(tp["vis_proj"]["w1"].shape) == (tcfg.vision_dim,
                                                     tcfg.d_model)
    else:
        assert len(tp["enc_blocks"]) == tcfg.n_encoder_layers
        assert len(tp["dec_blocks"]) == tcfg.n_layers
        bf = convert.target_params(_np(jp), tcfg, dtype=torch.bfloat16)
        layer = bf["dec_blocks"][1]
        assert layer["lnx"].dtype == torch.float32
        assert layer["cross_attn"]["wk"].dtype == torch.bfloat16


def test_sinusoidal_positions_match_reference():
    """Whisper's positions at d 512 and the reduced d 256, positions 0 to
    4095, against the JAX package's compiled ``sinusoidal_positions`` (the
    form its engine runs): the float32 angles are the same (the port
    computes XLA's exp polynomial), so sin and cos differ by at most an
    ulp of their libraries. Torch's own exp would put an angle an ulp
    apart: 2.4e-4 at position 4095."""
    pos = np.arange(4096, dtype=np.int32)[None]
    for d in (512, 256):
        want = np.asarray(jax.jit(lambda p: JL.sinusoidal_positions(p, d))(
            jnp.asarray(pos)))
        got = L.sinusoidal_positions(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, tol=1.2e-7, msg=str(d))


def test_full_attention_matches_reference():
    """The plain unmasked attention, GQA 4/2 over 40 keys, float32."""
    rng = np.random.default_rng(0)
    q = 2 * rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = JL.full_attention(*map(jnp.asarray, (q, k, v)), scale=0.2)
    got = L.full_attention(*map(torch.from_numpy, (q, k, v)), scale=0.2)
    _close(got, want)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_takes_extras_as_the_reference_shapes_say(arch):
    """``takes_extras`` (the one place the scheduler's stub and the
    launchers ask) holds exactly where the JAX package's
    ``extra_input_shapes`` gives a prefill input; ``extras_on`` carries
    numpy extras to tensors unchanged."""
    jcfg = jget_config(arch)
    assert takes_extras(get_config(arch)) == bool(
        jextra_input_shapes(jcfg, 1, "prefill"))
    assert takes_extras(get_config(arch)) == (arch in ARCHS)
    a = np.random.default_rng(0).standard_normal((1, 3, 4)).astype(np.float32)
    got = extras_on({"x": a}, torch.device("cpu"))
    assert isinstance(got["x"], torch.Tensor)
    np.testing.assert_array_equal(got["x"].numpy(), a)
    assert extras_on(None, torch.device("cpu")) == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_extras_matches_reference(arch, dtype):
    """``make_extras`` at the full config's shapes, in float32 and in
    bfloat16: the shapes and dtypes of ``extra_input_shapes`` (the JAX
    package's), and draws within EXTRAS_MAX_ULP ulps of the JAX package's
    (in float32; in bfloat16 those round to at most one bfloat16 ulp).
    The uniforms underneath are bitwise equal."""
    jcfg = jget_config(arch).replace(dtype=dtype)
    tcfg = get_config(arch).replace(dtype=dtype)
    for mode in ("prefill", "decode"):
        js = jextra_input_shapes(jcfg, 2, mode)
        ts = extra_input_shapes(tcfg, 2, mode)
        assert list(ts) == list(js)
        assert [s for s, _ in ts.values()] == [s for s, _ in js.values()]
    want = _np(jmake_extras(jcfg, 2, "prefill", jax.random.PRNGKey(3)))
    got = make_extras(tcfg, 2, "prefill", prng.PRNGKey(3))
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            assert _ulps(g, w).max() <= EXTRAS_MAX_ULP
            assert (_ulps(g, w) > 0).mean() < 0.02
        else:
            assert np.abs(g - w).max() <= 2 ** -8 * np.abs(w).max()
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    key = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(9), (4096,), lo, 1.0).numpy(),
        np.asarray(jax.random.uniform(key, (4096,), jnp.float32, lo, 1.0)))


def test_text_len_and_extra_shapes_match_reference():
    """``Model.text_len``: a VLM's train and prefill sequences carry its
    vision tokens; a decode and the other families do not."""
    for arch in ARCHS + ("qwen2-1.5b",):
        jm, tm = (jget_model(jget_config(arch).reduced()),
                  get_model(get_config(arch).reduced()))
        for total, mode in ((20, "train"), (20, "prefill"), (3, "decode"),
                            (5, "train")):
            assert tm.text_len(total, mode) == jm.text_len(total, mode)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def forwards(arch, cache_dtype="float32"):
    """The JAX forwards in train, prefill (into a ``cache_dtype`` cache)
    and decode modes on one set of inputs, and the inputs."""
    (jcfg, _, jp, _), (tcfg, _, _, _) = models(arch)
    jm = jget_model(jcfg)
    rng = np.random.default_rng(13)
    B, Pn = 2, 9
    off = tcfg.vision_tokens
    toks = rng.integers(0, 1000, (B, Pn)).astype(np.int32)
    blk = rng.integers(0, 1000, (B, K + 1)).astype(np.int32)
    pos = (Pn + off + np.arange(K + 1, dtype=np.int32))[None].repeat(B, 0)
    ex = {k: jnp.asarray(v) for k, v in jextras(arch, B).items()}
    train = jm.forward(jp, jnp.asarray(toks), mode="train", **ex)
    pre = jm.forward(jp, jnp.asarray(toks), mode="prefill",
                     cache=jm.make_cache(B, MAX_LEN,
                                         dtype=getattr(jnp, cache_dtype)),
                     **ex)
    dec = jm.forward(jp, jnp.asarray(blk), mode="decode",
                     positions=jnp.asarray(pos), cache=pre.cache)
    return (toks, blk, pos), [_np((o.logits, o.taps, o.cache))
                              for o in (train, pre, dec)]


def _same_cache(got, want, tcfg, what, tol=TOL):
    ref = convert.target_cache(want, tcfg)["blocks"]
    assert len(got["blocks"]) == len(ref) == tcfg.n_layers
    for li, (t, j) in enumerate(zip(got["blocks"], ref)):
        t, j = t.get("self", t), j.get("self", j)
        assert not t["ring"] and not j["ring"]
        np.testing.assert_array_equal(t["positions"], j["positions"])
        for name in ("k", "v"):
            _close(t[name].float(), np.asarray(j[name], np.float32), tol,
                   f"{what} layer {li} {name}")
    if tcfg.family == "encdec":
        for li, (t, j) in enumerate(zip(got["blocks"], ref)):
            for name in ("k", "v"):
                assert t["cross"][name].dtype == j["cross"][name].dtype
                _close(t["cross"][name].float(),
                       np.asarray(j["cross"][name], np.float32), tol,
                       f"{what} layer {li} cross {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """train, prefill into a cache and a decode block read against it:
    logits, taps and every cache leaf (whisper's cross K/V too) within
    3e-5. internvl2's train and prefill sequences are the 8 vision tokens
    and the 9 text tokens (logits and taps of all 17), its decode at
    positions past them; whisper's decode reads the cross K/V the prefill
    wrote."""
    (toks, blk, pos), want = forwards(arch)
    _, (tcfg, _, tp, _) = models(arch)
    model = get_model(tcfg)
    ex = _textras(arch, 2)
    cache = model.make_cache(2, MAX_LEN, dtype=torch.float32, device="cpu",
                             block=K + 1)
    got = [model.forward(tp, torch.from_numpy(toks), mode="train", **ex),
           model.forward(tp, torch.from_numpy(toks), mode="prefill",
                         cache=cache, **ex)]
    caches = [None, copy.deepcopy(got[1].cache)]
    got.append(model.forward(tp, torch.from_numpy(blk), mode="decode",
                             positions=torch.from_numpy(pos),
                             cache=got[1].cache))
    caches.append(got[2].cache)
    S = toks.shape[1] + tcfg.vision_tokens
    assert got[0].logits.shape == (2, S, tcfg.vocab_size)
    for what, o, tcache, (logits, taps, jcache) in zip(
            ("train", "prefill", "decode"), got, caches, want):
        _close(o.logits, logits, msg=f"{what} logits")
        _close(o.taps, taps, msg=f"{what} taps")
        if jcache is not None:
            _same_cache(tcache, jcache, tcfg, what)


def test_cross_kv_dtypes_follow_the_reference():
    """A float32 whisper over a bfloat16 cache: the prefill's own
    cross-attention reads the fresh float32 K/V, the cache keeps them
    rounded to bfloat16, and the decode reads that copy cast to float32,
    as the reference does (``encdec.py:78-85``, ``:173-180``): prefill and
    decode logits within 3e-5 of the reference's, and the decode's apart
    from a decode over float32 cross K/V by more than that."""
    (toks, blk, pos), want = forwards(ENCDEC, "bfloat16")
    _, (tcfg, _, tp, _) = models(ENCDEC)
    model = get_model(tcfg)
    ex = _textras(ENCDEC, 2)
    cache = model.make_cache(2, MAX_LEN, dtype=torch.bfloat16, device="cpu")
    pre = model.forward(tp, torch.from_numpy(toks), mode="prefill",
                        cache=cache, **ex)
    assert pre.cache["blocks"][0]["cross"]["k"].dtype == torch.bfloat16
    _close(pre.logits, want[1][0], msg="prefill")
    dec = model.forward(tp, torch.from_numpy(blk), mode="decode",
                        positions=torch.from_numpy(pos), cache=pre.cache)
    _close(dec.logits, want[2][0], msg="decode")
    assert np.abs(dec.logits.numpy() - forwards(ENCDEC)[1][2][0]).max() > TOL


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _ecfg(**kw):
    base = dict(K=K, max_new_tokens=10, drafter_mode="parallel",
                max_len=MAX_LEN, page_size=PAGE)
    base.update(kw)
    if base["drafter_mode"] == "none":
        base["K"] = 0
    return base


def _engines(arch, batch=2, **kw):
    (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp) = models(arch)
    cfg = _ecfg(**kw)
    use_d = cfg["drafter_mode"] != "none"
    je = JEngine(jcfg, jdcfg if use_d else None, jp, jdp if use_d else None,
                 JEngineConfig(**cfg), batch)
    te = Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                EngineConfig(**cfg), batch, device="cpu")
    return je, te


@lru_cache(maxsize=None)
def engine_run(arch, mode):
    prompts = np.random.default_rng(5).integers(
        1, 1000, (2, 12)).astype(np.int32)
    je, te = _engines(arch, drafter_mode=mode)
    ex = jextras(arch, 2)
    return (je.run(jnp.asarray(prompts), {k: jnp.asarray(v)
                                          for k, v in ex.items()}),
            te.run(prompts, ex), te)


@pytest.mark.parametrize("mode", ["parallel", "ar", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_run_matches_jax_engine(arch, mode):
    """Greedy Engine.run of 2 rows of 12-token prompts with their extras,
    10 new tokens: tokens (at the vision offset for internvl2, whose first
    8 positions stay 0), counters, the last position and logprobs equal the
    JAX engine's in each mode; and every mode's tokens equal none's."""
    jr, tr, te = engine_run(arch, mode)
    np.testing.assert_array_equal(tr["tokens"], np.asarray(jr["tokens"]))
    for leaf in ("new_count", "committed", "iters", "row_iters", "last"):
        np.testing.assert_array_equal(tr["state"][leaf].numpy(),
                                      np.asarray(jr["state"][leaf]), leaf)
    _close(tr["state"]["logprobs"], jr["state"]["logprobs"])
    off = te.pos_offset
    assert off == (8 if arch == VLM else 0)
    assert int(tr["state"]["last"][0]) == off + 12 + 10 - 1
    if mode != "none":
        np.testing.assert_array_equal(tr["tokens"],
                                      engine_run(arch, "none")[1]["tokens"])


def _workload(vocab=1000, n=5, seed=7):
    """(prompt, budget, arrival): prompts of 5-21 tokens, budgets 10-16,
    Exp(1) gaps."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab - 1, int(m)).astype(np.int32), int(b),
             float(t)) for m, b, t in zip(rng.integers(5, 22, n),
                                          rng.integers(10, 17, n),
                                          np.cumsum(rng.exponential(1.0, n)))]


# a pool that preempts at these prompts (internvl2's rows begin with 8
# vision positions: one more page each)
POOLS = {VLM: 10, ENCDEC: 7}


@lru_cache(maxsize=None)
def serves(arch, extras):
    """The workload on 3 slots: the JAX scheduler and the port's over
    paged KV (a pool that preempts, swap to host, the prefix cache asked
    for), each request with its own explicit extras or (``"stub"``) none,
    so the scheduler draws the prompt-keyed stub."""
    work = _workload()
    je, te = _engines(arch, batch=3, kv_layout="paged",
                      pool_pages=POOLS[arch], swap="host", prefix_cache=True,
                      max_new_tokens=16)

    def reqs(cls, conv):
        return [cls(p, max_new_tokens=b, arrival_time=t, rid=i,
                    extras=(None if extras == "stub" else
                            {k: conv(v) for k, v in
                             jextras(arch, 1, seed=100 + i).items()}))
                for i, (p, b, t) in enumerate(work)]
    jreqs = reqs(JRequest, jnp.asarray)
    jr = JScheduler(je).serve(jreqs)
    treqs = reqs(Request, lambda v: torch.from_numpy(np.array(v)))
    tr = Scheduler(te).serve(treqs)
    return jr, tr, te, jreqs, treqs


@pytest.mark.parametrize("extras", ["explicit", "stub"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serve_matches_jax_scheduler(arch, extras):
    """Scheduler.serve with staggered arrivals over paged KV, swap to host
    and a preemption: per request tokens, counters and logprobs, the event
    trace and the report's counters equal the JAX scheduler's; the prefix
    cache is never built for either family (the JAX engine's ``_hits_ok``);
    both pools end empty. Without explicit extras each request's stub is
    drawn from ``fold_in(PRNGKey(0), crc32(prompt))``, kept on the request
    and replayed by its resume: within EXTRAS_MAX_ULP ulps of the JAX
    scheduler's stub."""
    jr, tr, te, jreqs, treqs = serves(arch, extras)
    assert len(tr["results"]) == len(jr["results"]) == 5
    for t, j in zip(tr["results"], jr["results"]):
        assert t["rid"] == j["rid"]
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
        for key in ("n_new", "iters", "n_preempt", "n_swap",
                    "cached_tokens"):
            assert t[key] == j[key], (t["rid"], key)
        _close(t["logprobs"], j["logprobs"])
    assert tr["events"] == [tuple(e) for e in jr["events"]]
    for key in ("iterations", "makespan_vt", "preemptions", "preempt_swap",
                "preempt_recompute", "peak_pages", "total_new_tokens",
                "cache_hit_tokens", "cache_hit_requests"):
        assert tr[key] == jr[key], key
    assert tr["preemptions"] > 0 and tr["preempt_swap"] > 0
    assert tr["cache_hit_tokens"] == 0 and te.prefix_cache is None
    assert te.allocator.n_used == 0 and len(te.host_pool) == 0
    if extras == "stub":
        tcfg = models(arch)[1][0]
        for t, j in zip(treqs, jreqs):
            seed = zlib.crc32(t.prompt.tobytes()) & 0x7FFFFFFF
            want = make_extras(tcfg, 1, "prefill",
                               prng.fold_in(prng.PRNGKey(0), seed))
            for name, v in t.extras.items():
                np.testing.assert_array_equal(v.numpy(), want[name].numpy())
                assert _ulps(v.numpy(), j.extras[name]).max() \
                    <= EXTRAS_MAX_ULP


def test_vision_offset_in_pages_and_the_bucket_guard():
    """internvl2's 8 vision positions count in the pages a request needs and
    claims (the JAX engine's ``pages_needed`` / ``initial_pages``), and in
    the admission bucket's guard: at max_len 40 a 20-token prompt's bucket
    of 32 would reach position 8 + 32, so it is prefilled at its exact
    length (whisper, without the offset, pads it to 32); the admission's
    first token and position equal the JAX engine's."""
    je, te = _engines(VLM, batch=2, kv_layout="paged", pool_pages=40,
                      max_new_tokens=12)
    assert te.pos_offset == je.pos_offset == 8
    for plen, mnew in ((5, 10), (16, 12), (30, 4)):
        assert te.pages_needed(plen, mnew) == je.pages_needed(plen, mnew)
        for resume in (False, True):
            assert (te.initial_pages(plen, mnew, resume=resume)
                    == je.initial_pages(plen, mnew, resume=resume))
    assert te.pages_needed(5, 10) == -(-(5 + 8 + 10 + K + 1) // PAGE)
    assert te.prefill_bucket(9) == 16 and te.prefill_bucket(30) == 32
    prompt = np.arange(3, 23, dtype=np.int32)
    for arch, want in ((VLM, 20), (ENCDEC, 32)):
        je, te = _engines(arch, batch=1, max_len=40, max_new_tokens=8)
        assert te.prefill_bucket(20) == want
        ex = jextras(arch, 1)
        _, first, last = te.prefill_into_slot(te.blank_state(), prompt, 0,
                                              extras=ex)
        _, jfirst, jlast = je.prefill_into_slot(
            je.blank_state(), prompt, 0,
            extras={k: jnp.asarray(v) for k, v in ex.items()})
        assert (first, last) == (jfirst, jlast) == (first, 20 + te.pos_offset)


def test_cross_kv_are_per_slot_rows_through_swap_and_commit():
    """whisper's cross K/V are per-slot rows (``paged_spec`` tags them
    NOT_PAGED): ``extract_slot`` then ``admit_pages`` into another slot
    carries them bit for bit, ``reset_slot`` zeros the slot's, and a
    commit or an invalidation leaves them untouched."""
    _, te = _engines(ENCDEC, batch=3, kv_layout="paged", pool_pages=12)
    state = te.blank_state()
    p = np.arange(1, 12, dtype=np.int32)
    state, _, _ = te.prefill_into_slot(
        state, p, 1, extras={k: torch.from_numpy(np.array(v)) for k, v in
                             jextras(ENCDEC, 1).items()})
    core = te._core(state)
    spec = te.pspec["tcache"]["blocks"][0]
    assert spec["cross"] == {"k": cache_ops.NOT_PAGED,
                             "v": cache_ops.NOT_PAGED}
    assert spec["self"]["k"] == cache_ops.PAGED_KV
    cross = [{n: b["cross"][n].clone() for n in ("k", "v")}
             for b in core["tcache"]["blocks"]]
    assert all(float(c["k"][1].abs().max()) > 0 for c in cross)
    cache_ops.commit(core["tcache"], torch.zeros(3, dtype=torch.int32),
                     state["block_table"])
    for b, c in zip(core["tcache"]["blocks"], cross):
        for n in ("k", "v"):
            assert torch.equal(b["cross"][n], c[n])
    row = state["block_table"][1].clone()
    snap = cache_ops.extract_slot(core, 1, row, te.pspec)
    cache_ops.reset_slot(core, 1, te.pspec)
    assert all(float(b["cross"]["k"][1].abs().max()) == 0
               for b in core["tcache"]["blocks"])
    cache_ops.admit_pages(core, snap, 2, row, te.pspec)
    for b, c in zip(core["tcache"]["blocks"], cross):
        for n in ("k", "v"):
            assert torch.equal(b["cross"][n][2], c[n][1])


def test_round_based_refuses_and_serve_rehearses_both_families():
    """``launch/serve.py --arch`` serves both families reduced on the CPU,
    paged and preempting with swap (stub extras drawn at admission), every
    request to its budget, the prefix cache asked for idle; ``--round-based``
    refuses them."""
    for arch, pool in ((VLM, 9), (ENCDEC, 7)):
        r = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--requests", "4", "--prompt-len",
                        "13", "--max-new", "8", "--max-len", "64",
                        "--kv-layout", "paged", "--page-size", "8",
                        "--pool-pages", str(pool), "--swap", "host",
                        "--prefix-cache", "--runs", "1"])
        assert r["arch"] == arch and r["new_tokens"] == 32
        assert r["preempt_swap"] > 0 and r["cache_hit_tokens"] == 0
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--round-based"])


# ---------------------------------------------------------------------------
# the stream front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_async_engine_with_extras_equals_jax_virtual_twin(arch):
    """Concurrent streams through ``AsyncEngine.submit(extras=)``, each
    request's extras the stub its prompt keys, equal token for token (and
    logprob within 3e-5) the JAX package's ``virtual_twin_report``, whose
    requests carry no extras and draw the stub at admission."""
    work = [(p, None, b) for p, b, _ in _workload(n=4, seed=11)]
    je, te = _engines(arch, batch=2, kv_layout="paged",
                      pool_pages=POOLS[arch], max_new_tokens=16)
    twin = jvirtual_twin_report(je, work)
    tcfg = te.tcfg

    async def go():
        aeng = AsyncEngine(te)

        async def one(p, b):
            seed = zlib.crc32(p.tobytes()) & 0x7FFFFFFF
            ex = make_extras(tcfg, 1, "prefill",
                             prng.fold_in(prng.PRNGKey(0), seed))
            h = await aeng.submit(p, None, b, extras=ex)
            return [pair async for pair in h]
        out = await asyncio.gather(*(one(p, b) for p, _, b in work))
        return out, await aeng.close()
    streams, rep = asyncio.run(asyncio.wait_for(go(), 60))
    assert rep["n_requests"] == len(work) and rep["aborted"] == 0
    for got, want in zip(streams, twin["results"]):
        assert [t for t, _ in got] == np.asarray(want["tokens"]).tolist()
        _close([lp for _, lp in got], want["logprobs"])
    assert te.allocator.n_used == 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def trained(arch, segments):
    """One step of both trainers from the same converted drafter on the
    same batch (2 sequences of 24 tokens, K_train 3), with the JAX
    package's extras for that batch."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models(arch)
    corpus = P.markov_corpus(0, 4, 24, tcfg.vocab_size, branch=2)
    kw = dict(n_layers=1, k_train=3)
    jd, d = JDrafterConfig(**kw).resolve(jcfg), DrafterConfig(**kw).resolve(
        tcfg)
    tc = dict(lr=2e-3, total_steps=20, warmup_ratio=0.1)
    ex = jextras(arch, 2, seed=21)
    jtr = JTrainer(jcfg, jd, jp, JTrainConfig(**tc), seed=0,
                   extras={k: jnp.asarray(v) for k, v in ex.items()})
    tr = Trainer(tcfg, d, tp, TrainConfig(**tc),
                 dparams=convert.drafter_params(_np(jtr.dparams)),
                 device="cpu", extras=ex)
    pkw = dict(k_train=3, cod_rate=0.7, batch=2, seed=0, segments=segments)
    batch = next(iter(P.MTPPipeline(corpus, **pkw)))
    jbatch = next(iter(JP.MTPPipeline(corpus, **pkw)))
    return tr, jtr, tr.train_batch(batch), jtr.train_batch(jbatch)


@pytest.mark.parametrize("segments", [1, 2], ids=["whole", "segmented"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_step_with_extras_matches_jax(arch, segments):
    """A whole and a segmented ``Trainer.train_batch`` with the target's
    extras (internvl2's taps sliced to the text region): the metrics (loss,
    accuracies, grad norm) and the first moment, linear in the grads,
    within atol 2e-5, rtol 2e-4."""
    tr, jtr, tm, jm = trained(arch, segments)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **GTOL)
    want = {k: np.asarray(v) for k, v in
            _flat(convert.drafter_params(_np(jtr.opt_state.m))).items()}
    got = _flat(tr.opt_state.m)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GTOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree.detach().numpy()}


def test_vlm_taps_are_the_text_region():
    """The trainer's taps of a VLM target are the last n of the fused
    forward's Tv + n, and differ from what the first n would give."""
    _, (tcfg, dcfg, tp, _) = models(VLM)
    ex = _textras(VLM, 2)
    tr = Trainer(tcfg, dcfg, tp, TrainConfig(), device="cpu", extras=ex)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1000, (2, 12)).astype(np.int32))
    full = get_model(tcfg).forward(tp, toks, mode="train", **ex).taps
    assert full.shape[1] == 12 + tcfg.vision_tokens
    torch.testing.assert_close(tr.taps(toks), full[:, -12:], rtol=0, atol=0)


def test_self_generated_corpus_with_extras_equals_jax():
    """Greedy rollouts of internvl2 with ``extras_fn``: the text region,
    equal to the JAX package's corpus."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = models(VLM)
    kw = dict(seed=3, n_seqs=2, seq_len=10, prompt_len=3, batch=2)
    want = JP.self_generated_corpus(
        jget_model(jcfg), jp, extras_fn=lambda b: {
            k: jnp.asarray(v) for k, v in jextras(VLM, b).items()}, **kw)
    got = P.self_generated_corpus(get_model(tcfg), tp, device="cpu",
                                  extras_fn=lambda b: jextras(VLM, b), **kw)
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)

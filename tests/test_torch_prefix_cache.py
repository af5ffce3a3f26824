"""The port's prefix cache on the CPU, against the JAX package's.

The index (``serving/prefix_cache.py``): the same operations on the same
streams give the same page ids in both packages: the chain walk, the
lookahead token of the full key, full-key dedup, the read-only
``match_len`` and eviction that skips pinned pages.

The engine's hit admission: a hit commits the token a cold prefill commits
and leaves the slot's caches equal to the cold ones (positions exactly,
K/V within 3e-5) at every position below ``last``, for a full hit and a
copy-on-write hit, fresh and as a sampled resume. Served through the
scheduler, a shared-preamble workload with the cache on gives the streams
of a cold engine, on a copy-on-write workload and under eviction
pressure, and equals the JAX scheduler's: tokens, events and the
``cache_hit_*`` fields, over two serves (the second from warm pages).

The reduced qwen2-1.5b in float32 (``torch_serving_setup``)."""
import numpy as np
import pytest
import torch

from repro.serving import PrefixCache as JPrefixCache
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import cache_ops as jcache_ops
from repro_torch.serving import cache_ops
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
from torch_serving_setup import (PS, assert_same_serve, jax_engine,
                                 port_engine, shared_preamble)
import torch_threads  # noqa: F401  (torch threads per xdist worker)


# ---------------------------------------------------------------------------
# the index, against the JAX package's on the same operations
# ---------------------------------------------------------------------------

def _chain_walk(cache_cls, ops):
    """The chain walk and the lookahead: a page full-hits only through its
    chain and the token after it; equal bytes with another next token is
    the copy-on-write source."""
    c, a = cache_cls(4), ops.BlockAllocator(8)
    stream = np.arange(1, 14, dtype=np.int32)
    pages = a.alloc(3)
    seen = [c.insert_stream(stream, pages, a),
            [a.refcount(p) for p in pages], c.match(stream)]
    div = stream.copy()
    div[5] = 99                 # page 1's bytes differ
    seen.append(c.match(div))
    div2 = stream.copy()
    div2[8] = 99                # page 1's lookahead differs
    seen += [c.match(div2), c.match(stream[:7])]
    a.free(pages)
    seen += [c.flush(a), a.n_free]
    return seen


def _dedup(cache_cls, ops):
    c, a = cache_cls(4), ops.BlockAllocator(8)
    stream = np.arange(1, 10, dtype=np.int32)
    p1, p2 = a.alloc(2), a.alloc(2)
    seen = [c.insert_stream(stream, p1, a), c.insert_stream(stream, p2, a),
            c.match(stream), a.refcount(p1[0]), a.refcount(p2[0])]
    a.free(p1 + p2)
    return seen + [c.flush(a), a.n_free]


def _match_len_read_only(cache_cls, ops):
    """Probing (``match_len``, ``probe``) refreshes no LRU order, so the
    eviction takes the least recently matched page."""
    c, a = cache_cls(4), ops.BlockAllocator(8)
    s1 = np.arange(1, 6, dtype=np.int32)
    s2 = np.arange(50, 55, dtype=np.int32)
    c.insert_stream(s1, a.alloc(1), a)
    c.insert_stream(s2, a.alloc(1), a)
    seen = [c.match_len(s1), c.match_len(s2)]
    a.free(c.pages())
    seen += [c.match_len(s1), c.probe(s1), c.evict(1, a), c.match_len(s1),
             c.match_len(s2), c.match(s2), c.evict(1, a), len(c)]
    return seen + [c.flush(a), a.n_free, c.stats]


def _evict_pinned(cache_cls, ops):
    c, a = cache_cls(4), ops.BlockAllocator(8)
    s1 = np.arange(1, 6, dtype=np.int32)
    s2 = np.arange(50, 55, dtype=np.int32)
    p1, p2 = a.alloc(1), a.alloc(1)
    c.insert_stream(s1, p1, a)
    c.insert_stream(s2, p2, a)
    a.free(p2)
    seen = [c.evictable(a), c.evictable(a, exclude=p2), c.evict(2, a),
            c.match_len(s1), c.match_len(s2)]
    a.free(p1)
    return seen + [c.flush(a), a.n_free, c.stats]


@pytest.mark.parametrize("scenario", [_chain_walk, _dedup,
                                      _match_len_read_only, _evict_pinned],
                         ids=lambda f: f.__name__.strip("_"))
def test_index_matches_jax_prefix_cache(scenario):
    got = scenario(PrefixCache, cache_ops)
    want = scenario(JPrefixCache, jcache_ops)
    assert got == want


def test_index_semantics():
    """What the index scenarios observe, pinned outright."""
    got = _chain_walk(PrefixCache, cache_ops)
    assert got[0] == 3 and got[1] == [2, 2, 2]
    pages = got[2][0]
    assert got[2] == (pages, None)
    assert got[3] == (pages[:1], None)       # bytes differ: no source
    assert got[4] == (pages[:1], pages[1])   # lookahead differs: copy it
    assert got[5] == (pages[:1], None)       # too short to hold page 1
    assert got[7] == 8
    dedup = _dedup(PrefixCache, cache_ops)
    assert dedup[:2] == [2, 0] and dedup[3:5] == [2, 1]
    pinned = _evict_pinned(PrefixCache, cache_ops)
    assert pinned[:5] == [1, 0, 1, 1, 0]


def test_copy_page_refuses_the_sink():
    pool = {"k": torch.arange(4 * 2, dtype=torch.float32).reshape(4, 2),
            "positions": torch.arange(8, dtype=torch.int32).reshape(4, 2)}
    spec = {"k": cache_ops.PAGED_KV, "positions": cache_ops.PAGED_POS}
    cache_ops.copy_page(pool, 0, 2, spec)
    assert pool["k"][2].tolist() == [0.0, 1.0]
    assert pool["positions"][2].tolist() == [0, 1]
    for src, dst in ((3, 1), (1, 3), (-1, 1)):
        with pytest.raises(ValueError, match="sink"):
            cache_ops.copy_page(pool, src, dst, spec)


# ---------------------------------------------------------------------------
# a hit admission against a cold one
# ---------------------------------------------------------------------------

def _slot_view(eng, state, slot):
    """Slot ``slot``'s caches as a batch-1 contiguous view."""
    row = state["block_table"][slot]
    return cache_ops.extract_slot(eng._core(state), slot, row, eng.pspec)


@pytest.mark.parametrize("cow", [False, True], ids=["full", "cow"])
@pytest.mark.parametrize("resume", [False, True], ids=["fresh", "resume"])
def test_hit_equals_cold_prefill(cow, resume):
    """A prompt admitted against cached pages commits what a cold
    admission commits, and leaves the slot's caches equal to the cold ones
    below ``last``. ``cow``: the preamble fills whole pages, so the page
    before the divergence is copied on write; ``resume``: a sampled
    no-commit resume (the stream's last token forced)."""
    pre = 3 * PS if cow else 3 * PS + 3
    first, second = shared_preamble(pre, (5, 7), seed=4)
    sp = SamplingParams(temperature=0.8, seed=9) if resume else None
    warm, cold = (port_engine(pool_pages=16, prefix_cache=True),
                  port_engine(pool_pages=16))
    ws, cs = warm.blank_state(), cold.blank_state()
    ws, _, _ = warm.prefill_into_slot(ws, first, 0, max_new=8)
    ws, tok_w, last_w = warm.prefill_into_slot(ws, second, 1, max_new=8,
                                               sampling=sp, resume=resume)
    cs, tok_c, last_c = cold.prefill_into_slot(cs, second, 1, max_new=8,
                                               sampling=sp, resume=resume)
    start = (3 * PS - 1) if cow else 3 * PS
    assert warm.last_hit_tokens == start and cold.last_hit_tokens == 0
    assert warm.prefix_cache.stats["cow_hits"] == int(cow)
    assert (tok_w, last_w) == (tok_c, last_c)
    assert warm.last_logprob == pytest.approx(cold.last_logprob, abs=3e-5)
    got, want = _slot_view(warm, ws, 1), _slot_view(cold, cs, 1)
    for key in ("tokens", "last", "new_count"):
        assert torch.equal(got[key], want[key]), key
    for key in got["sampling"]:
        assert torch.equal(got["sampling"][key], want["sampling"][key]), key
    torch.testing.assert_close(got["logprobs"], want["logprobs"], rtol=0,
                               atol=3e-5)
    torch.testing.assert_close(got["taps_last"], want["taps_last"],
                               rtol=3e-5, atol=3e-5)
    for key in ("tcache", "dcache"):
        for g, w in zip(got[key]["blocks"], want[key]["blocks"]):
            below = torch.arange(g["positions"].shape[1]) < last_c
            assert torch.equal(g["positions"][:, below],
                               w["positions"][:, below]), key
            live = below & (w["positions"][0] >= 0)
            for kv in ("k", "v"):
                torch.testing.assert_close(g[kv][:, live], w[kv][:, live],
                                           rtol=3e-5, atol=3e-5)


# ---------------------------------------------------------------------------
# served: lossless against a cold engine, equal to the JAX scheduler
# ---------------------------------------------------------------------------

def _serve(eng, prompts, budget=8, cls=Request, sched=Scheduler, gap=0.0):
    rep = sched(eng).serve([cls(p, max_new_tokens=budget, rid=i,
                                arrival_time=i * gap)
                            for i, p in enumerate(prompts)])
    return [r["tokens"] for r in rep["results"]], rep


def _assert_cache_consistent(eng):
    """After a drain every live page is the cache's alone, once; a flush
    empties the pool."""
    cache, alloc = eng.prefix_cache, eng.allocator
    pages = cache.pages()
    assert len(pages) == len(set(pages))
    assert alloc.n_used == len(pages)
    assert all(alloc.refcount(p) == 1 for p in pages)
    cache.flush(alloc)
    assert alloc.n_used == 0 and not any(eng._slot_pages)


def test_cow_divergence_lossless():
    """The preamble fills 3 pages, so the prompts part exactly at a cached
    page's lookahead token: admissions copy that page on write."""
    prompts = shared_preamble(3 * PS, (4, 4, 6), seed=1)
    cold, _ = _serve(port_engine(), prompts)
    warm_eng = port_engine(prefix_cache=True)
    warm, rep = _serve(warm_eng, prompts)
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(w, c)
    assert warm_eng.prefix_cache.stats["cow_hits"] >= 2
    assert rep["cache_hit_tokens"] >= 2 * (3 * PS - 1)
    _assert_cache_consistent(warm_eng)


def test_eviction_under_pressure_lossless():
    """A pool too small to index every stream: cache-only pages are
    evicted least recently used first, streams stay a cold engine's."""
    prompts = shared_preamble(16, (6, 6, 6, 6), seed=2)
    cold, _ = _serve(port_engine(pool_pages=8), prompts, budget=4)
    warm_eng = port_engine(pool_pages=8, prefix_cache=True)
    warm, rep = _serve(warm_eng, prompts, budget=4)
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(w, c)
    assert warm_eng.prefix_cache.stats["evictions"] > 0
    assert rep["cache_hit_requests"] > 0
    assert warm_eng.allocator.peak_used <= 8
    _assert_cache_consistent(warm_eng)


def test_serve_matches_jax_scheduler():
    """Shared-preamble traffic with arrival gaps, served twice (the second
    serve from the pages the first left warm): tokens, events, per-request
    ``cached_tokens`` and the ``cache_hit_*`` fields equal the JAX
    scheduler's, and the streams equal a cold port engine's."""
    prompts = shared_preamble(20, (3, 5, 7, 4), seed=0)
    port, ref = port_engine(prefix_cache=True), jax_engine(prefix_cache=True)
    cold, _ = _serve(port_engine(), prompts, gap=0.5)
    for serve_pass in (1, 2):
        toks, tr = _serve(port, prompts, gap=0.5)
        _, jr = _serve(ref, prompts, cls=JRequest, sched=JScheduler, gap=0.5)
        assert_same_serve(tr, jr, ("cache_hit_tokens", "cache_hit_requests"))
        assert tr["cache_hit_requests"] >= (2 if serve_pass == 1 else 4)
        for c, w in zip(cold, toks):
            np.testing.assert_array_equal(w, c)
    assert port.prefix_cache.stats == ref.prefix_cache.stats
    _assert_cache_consistent(port)

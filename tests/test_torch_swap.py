"""The port's swap-to-host preemption on the CPU, against the JAX package's.

``HostPagePool`` keeps the byte account of the reference's; the engine
refuses swap without the paged layout; a swap-out / swap-in round trip
restores the slot bitwise (only the committed counters restart at 0);
a swapped resume emits what the uninterrupted run, the recompute resume
and the JAX scheduler emit (tokens, events, the ``preempt_*`` counters),
a sampled one bitwise, logprobs included; a host pool too small for any
snapshot falls back to recompute; pages shared with the prefix cache stay
resident under the handle; ``reset_stats`` restarts both pools' peaks.

The reduced qwen2-1.5b in float32 (``torch_serving_setup``)."""
import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import Scheduler as JScheduler
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.tree import leaves_with_paths
from torch_serving_setup import (assert_same_serve, ecfg, jax_engine,
                                 port_engine, preempt_workload)
import torch_threads  # noqa: F401  (torch threads per xdist worker)

PREEMPT_KEYS = ("preempt_swap", "preempt_recompute", "swap_drops",
                "recomputed_prefill_tokens")


def _assert_pools_drained(eng):
    assert eng.allocator.n_used == 0 and not any(eng._slot_pages)
    assert len(eng.host_pool) == 0 and eng.host_pool.used_bytes == 0


def _solo(eng, prompt, budget, sp=None):
    return Scheduler(eng).serve([Request(prompt, max_new_tokens=budget,
                                         sampling=sp)])["results"][0]


def test_host_page_pool_accounting():
    hp = cache_ops.HostPagePool(100)
    assert hp.can_store(100) and not hp.can_store(101)
    assert hp.put("a", "h1", 60)
    assert "a" in hp and len(hp) == 1
    assert hp.used_bytes == 60 and hp.peak_used == 60
    assert not hp.put("b", "h2", 50)
    assert "b" not in hp and hp.used_bytes == 60
    with pytest.raises(ValueError):
        hp.put("a", "dup", 1)
    assert hp.pop("a") == "h1"
    assert hp.used_bytes == 0 and hp.peak_used == 60
    with pytest.raises(KeyError):
        hp.pop("a")
    assert hp.get("a") is None
    hp.reset_stats()
    assert hp.peak_used == 0
    assert cache_ops.HostPagePool(0).can_store(10 ** 12)
    with pytest.raises(ValueError):
        cache_ops.HostPagePool(-1)


def test_swap_config_validation():
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(**ecfg(kv_layout="contiguous", swap="host"))
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(**ecfg(kv_layout="contiguous", prefix_cache=True))
    with pytest.raises(ValueError, match="swap"):
        EngineConfig(**ecfg(swap="disk"))
    eng = port_engine(pool_pages=5)
    assert eng.host_pool is None and not eng.has_swap(0)
    with pytest.raises(ValueError, match="swap"):
        Scheduler(eng, swap=True)


def test_swap_roundtrip_restores_slot_bitwise():
    """swap_out_slot then swap_in_slot gives the slot back its batch-1
    view bit for bit (its pages are new ids), but for the committed
    counters, which restart at 0; the bytes moved are the estimate's."""
    eng = port_engine(pool_pages=6, swap="host")
    state = eng.blank_state()
    state, _, _ = eng.prefill_into_slot(state, np.arange(1, 7, dtype=np.int32),
                                        0, max_new=8)
    state = eng.step(state)

    def view():
        # the slot's claimed span only: a -1 table entry reads page 0,
        # whose owner changes when swap-in allocates other pages
        row = state["block_table"][0]
        claimed = int((row >= 0).sum()) * eng.ecfg.page_size
        return cache_ops.map_tree(
            lambda _, leaf, tag: leaf if tag == cache_ops.NOT_PAGED
            else leaf.narrow(cache_ops.view_width_axis(leaf.dim(), tag), 0,
                             claimed),
            cache_ops.extract_slot(eng._core(state), 0, row, eng.pspec),
            eng.pspec)

    before = view()
    est = eng.swap_bytes_estimate(0)
    state, ok = eng.swap_out_slot(state, 0, rid="r0")
    assert ok and eng.swap_last_bytes == est == eng.host_pool.used_bytes
    assert not eng._slot_pages[0] and eng.has_swap("r0")
    assert int(state["block_table"][0].max()) == -1
    assert eng.can_swap_in("r0")
    state, last = eng.swap_in_slot(state, 0, "r0")
    assert last == int(before["last"][0])
    after = view()
    before["new_count"].zero_()
    before["slot_iters"].zero_()
    got, want = leaves_with_paths(after), leaves_with_paths(before)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f"{path} not restored bitwise"
        else:
            assert a == b, path
    assert eng.host_pool.used_bytes == 0
    eng.free_slot(state, 0)
    _assert_pools_drained(eng)


def _serve_both(reqs_of, **kw):
    port, ref = port_engine(**kw), jax_engine(**kw)
    tr = Scheduler(port).serve(reqs_of(Request, SamplingParams))
    jr = JScheduler(ref).serve(reqs_of(JRequest, JSamplingParams))
    return port, tr, jr


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_swapped_resume_equals_solo_recompute_and_jax(sampled):
    """The tight pool evicts one request to the host; it comes back and
    emits the uninterrupted run's tokens and logprobs bitwise (greedy and
    seeded sampled alike), the recompute twin's tokens, and the JAX
    scheduler's tokens, events and counters."""
    prompts, budgets = preempt_workload()

    def reqs(cls, sp_cls):
        return [cls(p, max_new_tokens=b, rid=i,
                    sampling=sp_cls(temperature=0.8, seed=100 + i)
                    if sampled else None)
                for i, (p, b) in enumerate(zip(prompts, budgets))]

    eng, tr, jr = _serve_both(reqs, pool_pages=5, swap="host")
    assert_same_serve(tr, jr, PREEMPT_KEYS)
    assert tr["preempt_swap"] >= 1 and tr["recomputed_prefill_tokens"] == 0
    assert tr["preemptions"] == tr["preempt_swap"] + tr["preempt_recompute"]
    assert tr["host_pool"]["peak_bytes"] > 0
    assert [e[1] for e in tr["events"]].count("swap_in") == tr["preempt_swap"]
    _assert_pools_drained(eng)
    recompute = port_engine(pool_pages=5)
    rc = Scheduler(recompute).serve(reqs(Request, SamplingParams))
    assert rc["preemptions"] >= 1 and rc["preempt_swap"] == 0
    for got, twin, r in zip(tr["results"], rc["results"],
                            reqs(Request, SamplingParams)):
        solo = _solo(recompute, r.prompt, r.max_new_tokens, r.sampling)
        np.testing.assert_array_equal(got["tokens"], solo["tokens"])
        np.testing.assert_array_equal(got["logprobs"], solo["logprobs"])
        np.testing.assert_array_equal(got["tokens"], twin["tokens"])


def test_host_pool_exhaustion_falls_back_to_recompute():
    prompts, budgets = preempt_workload()

    def reqs(cls, _):
        return [cls(p, max_new_tokens=b, rid=i)
                for i, (p, b) in enumerate(zip(prompts, budgets))]

    eng, tr, jr = _serve_both(reqs, pool_pages=5, swap="host",
                              host_pool_bytes=64)
    assert_same_serve(tr, jr, PREEMPT_KEYS)
    assert tr["preemptions"] >= 1 and tr["preempt_swap"] == 0
    assert tr["preempt_recompute"] == tr["preemptions"]
    assert tr["recomputed_prefill_tokens"] > 0
    assert tr["host_pool"] == {"capacity_bytes": 64, "used_bytes": 0,
                               "peak_bytes": 0}
    ref = port_engine(pool_pages=5)
    for got, p, b in zip(tr["results"], prompts, budgets):
        np.testing.assert_array_equal(got["tokens"],
                                      _solo(ref, p, b)["tokens"])
    _assert_pools_drained(eng)


def test_swap_composes_with_prefix_cache_shared_pages_stay_resident():
    """Identical prompts share cached pages: a victim's shared pages stay
    on the device under its handle, only its own pages move, and the
    streams are a cache-off, swap-off engine's and the JAX scheduler's."""
    prompt = np.arange(11, 28, dtype=np.int32)
    budgets = [14, 14, 8]

    def reqs(cls, _):
        return [cls(prompt, max_new_tokens=b, rid=i)
                for i, b in enumerate(budgets)]

    eng, tr, jr = _serve_both(reqs, pool_pages=5, swap="host",
                              prefix_cache=True)
    assert_same_serve(tr, jr, PREEMPT_KEYS + ("cache_hit_tokens",
                                              "cache_hit_requests"))
    assert tr["preempt_swap"] >= 1 and tr["cache_hit_requests"] >= 1
    ref = port_engine(pool_pages=5)
    for got, b in zip(tr["results"], budgets):
        np.testing.assert_array_equal(got["tokens"],
                                      _solo(ref, prompt, b)["tokens"])
    alloc, cache = eng.allocator, eng.prefix_cache
    held = cache.pages()
    assert len(held) == len(set(held)) and alloc.n_used == len(held)
    assert all(alloc.refcount(p) == 1 for p in held)
    cache.flush(alloc)
    _assert_pools_drained(eng)


def test_swap_keeps_shared_pages_resident_under_the_handle():
    """Engine level: with a prefix hit mapped into the victim's row, the
    pages it shares are neither copied nor freed by swap-out; the handle
    holds the slot's reference until swap-in maps them again."""
    eng = port_engine(pool_pages=12, swap="host", prefix_cache=True)
    prompt = np.arange(11, 37, dtype=np.int32)
    state = eng.blank_state()
    state, _, _ = eng.prefill_into_slot(state, prompt, 0, max_new=8)
    state, _, _ = eng.prefill_into_slot(state, prompt, 1, max_new=8)
    pages = list(eng._slot_pages[1])
    shared = [p for p in pages if eng.allocator.refcount(p) > 1]
    assert shared and eng.last_hit_tokens > 0
    row_b, page_b = eng._swap_layout()
    assert eng.swap_bytes_estimate(1) == row_b + page_b * (
        len(pages) - len(shared))
    state, ok = eng.swap_out_slot(state, 1, rid=7)
    assert ok and all(eng.allocator.refcount(p) >= 2 for p in shared)
    with pytest.raises(RuntimeError, match="still holds pages"):
        eng.swap_in_slot(state, 0, 7)
    state, _ = eng.swap_in_slot(state, 1, 7)
    assert eng._slot_pages[1][:len(shared)] == shared
    assert eng.drop_swap(7) is False


def test_reset_stats_covers_both_pools():
    eng = port_engine(pool_pages=5, swap="host")
    prompts, budgets = preempt_workload()
    rep = Scheduler(eng).serve([Request(p, max_new_tokens=b)
                                for p, b in zip(prompts, budgets)])
    assert rep["preempt_swap"] >= 1
    assert eng.host_pool.peak_used > 0 and eng.allocator.peak_used > 0
    assert rep["peak_pages"] == eng.allocator.peak_used
    eng.reset_stats()
    assert eng.host_pool.peak_used == 0
    assert eng.allocator.peak_used == eng.allocator.n_used == 0

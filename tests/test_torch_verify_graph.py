"""The verify forward's CUDA graphs (``serving/verify_graph.py``) on the CPU.

A CPU engine never captures: its ``verify`` is ``eager``, and every verify
counts as eager in ``tracing.counters()`` and in ``AsyncEngine.health()``,
for both layouts and every drafter mode; an engine engages only on a CUDA
device without a mesh (``tests/torch_sharding_child.py`` holds a meshed
engine to ``eager``). The graph's key follows what the serving path does
to the state: admission, growth, steps, swap and release write the caches
and the block table in place and keep it; a replaced cache leaf, block
table or weight, another block shape or other flags change it. The pieces'
seams: ``kernels.ops.outside_graph`` calls the module's attribute (a
wrapper on it sees the call) or hands the call to the split, the paged
kernel's entry writes ``out=``, and a verify forward splits at each of the
target's paged calls alone. ``VerifyGraph``'s bookkeeping runs on the CPU
with torch.cuda's graph calls stood in by a recorder: pieces around the
paged calls, the calls' state operands kept as places, no reference to a
dropped state. Replay against eager on the card is in
``tests/test_torch_gpu.py``; the benchmark's reader of the replays in
``bench/tests/test_bench_verify_graph_share.py``."""
import asyncio
import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_engine
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.streaming import AsyncEngine
from repro_torch.serving.verify_graph import (VerifyGraph, eager, engages,
                                              graph_key)
import torch_threads  # noqa: F401  (torch threads per xdist worker)


def requests(n=3):
    rng = np.random.default_rng(0)
    return [Request(rng.integers(1, 200, 6 + 3 * i).astype(np.int32),
                    max_new_tokens=5 + i) for i in range(n)]


def verify_counts():
    c = tracing.counters()["serving"]
    return {k: c[f"verify_graph.{k}"] for k in ("captures", "replays",
                                                 "eager")}


@pytest.mark.parametrize("mode", ["parallel", "ar", "none"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cpu_engine_runs_every_verify_eagerly(layout, mode):
    eng = build_engine(reduced=True, device="cpu", mode=mode, K=2,
                       max_new=8, max_len=64, batch=2, kv_layout=layout,
                       page_size=8, pool_pages=7)
    assert eng.verify is eager
    before, steps0 = verify_counts(), tracing.counters()["serving"]["steps"]
    Scheduler(eng).serve(requests())
    after = verify_counts()
    steps = tracing.counters()["serving"]["steps"] - steps0
    assert steps > 0
    assert {k: after[k] - before[k] for k in after} == {
        "captures": 0, "replays": 0, "eager": steps}


def test_health_reports_the_verify_counts():
    eng = build_engine(reduced=True, device="cpu", K=2, max_new=8,
                       max_len=64, batch=2, kv_layout="paged", page_size=8,
                       pool_pages=7)

    async def serve():
        aeng = AsyncEngine(eng)
        await aeng.start()
        try:
            h = await aeng.submit(np.arange(1, 9, dtype=np.int32), None, 6)
            async for _ in h:
                pass
            return aeng.health()
        finally:
            await aeng.close()
    before = verify_counts()
    steps0 = tracing.counters()["serving"]["steps"]
    health = asyncio.run(asyncio.wait_for(serve(), 60))
    got = health["counters"]["serving"]
    steps = got["steps"] - steps0
    assert steps > 0
    assert {k: got[f"verify_graph.{k}"] - before[k] for k in before} == {
        "captures": 0, "replays": 0, "eager": steps}


def test_engages_on_one_card_alone():
    assert engages(torch.device("cuda"), None)
    assert not engages(torch.device("cuda"), object())   # a mesh
    assert not engages(torch.device("cpu"), None)
    assert not engages(torch.device("meta"), None)


def test_key_follows_replaced_leaves_not_in_place_writes():
    eng = build_engine(reduced=True, device="cpu", K=2, max_new=8,
                       max_len=64, batch=2, kv_layout="paged", page_size=8,
                       pool_pages=12, swap="host")
    vt = torch.zeros((2, 3), dtype=torch.int32)

    def key(state, tparams=eng.tparams, block=vt, taps=True):
        return graph_key(block, taps, False, state["tcache"],
                         state["block_table"], tparams)
    state = eng.blank_state()
    k0 = key(state)
    rng = np.random.default_rng(1)
    for slot in (0, 1):
        state, *_ = eng.prefill_into_slot(
            state, rng.integers(1, 200, 10).astype(np.int32), slot)
    for _ in range(3):
        state = eng.step(state)
        for slot in (0, 1):
            state, ok = eng.ensure_capacity(
                state, slot, int(state["last"][slot]) + eng.commit_stride)
            assert ok
    state, ok = eng.swap_out_slot(state, 1, rid=7)
    assert ok
    state, _ = eng.swap_in_slot(state, 1, rid=7)
    state = eng.free_slot(state, 0)
    assert key(state) == k0

    # in place, by hand, and a whole other session
    state["tcache"]["blocks"][0]["k"].fill_(1)
    state["block_table"][1] = 3
    assert key(state) == k0
    assert key(eng.blank_state()) != k0

    # a replaced leaf, table or weight; another block or flag
    blocks = state["tcache"]["blocks"]
    old = blocks[0]["k"]
    blocks[0]["k"] = old.clone()
    assert key(state) != k0
    blocks[0]["k"] = old
    assert key(state) == k0
    table = state["block_table"]
    state["block_table"] = table.clone()
    assert key(state) != k0
    state["block_table"] = table
    tparams = dict(eng.tparams, final_norm=eng.tparams["final_norm"].clone())
    assert key(state, tparams=tparams) != k0
    assert key(state, block=torch.zeros((2, 4), dtype=torch.int32)) != k0
    assert key(state, taps=False) != k0


def test_outside_graph_calls_the_module_attribute(monkeypatch):
    seen = []
    plain = ops.paged_decode_attention

    def wrapper(q, *a, **kw):
        seen.append(tuple(q.shape))
        return plain(q, *a, **kw)
    monkeypatch.setattr(ops, "paged_decode_attention", wrapper)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 3, 4, 32), generator=g)
    kp, vp = (torch.randn((5, 4, 2, 32), generator=g) for _ in range(2))
    pos = torch.arange(20, dtype=torch.int32).reshape(5, 4)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    qpos = torch.full((2, 3), 9, dtype=torch.int32)
    args = (q, kp, vp, pos, table, qpos)
    got = ops.outside_graph("paged_decode_attention", *args, scale=0.2)
    assert seen == [(2, 3, 4, 32)]
    torch.testing.assert_close(got, plain(*args, scale=0.2), rtol=0, atol=0)
    split = []
    with ops.graph_split(lambda name, a, kw: split.append((name, a, kw))
                         or "split"):
        assert ops.outside_graph("paged_decode_attention", *args,
                                 scale=0.2) == "split"
    assert [(n, len(a), kw) for n, a, kw in split] == [
        ("paged_decode_attention", 6, {"scale": 0.2})]
    assert seen == [(2, 3, 4, 32)]                      # no call made


@pytest.mark.parametrize("stats", [False, True])
def test_paged_attention_writes_out(stats):
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 3, 4, 32), generator=g)
    kp, vp = (torch.randn((5, 4, 2, 32), generator=g) for _ in range(2))
    pos = torch.arange(20, dtype=torch.int32).reshape(5, 4)
    table = torch.tensor([[0, -1], [4, 2]], dtype=torch.int32)
    qpos = torch.full((2, 3), 12, dtype=torch.int32)
    args = (q, kp, vp, pos, table, qpos)
    want = ops.paged_decode_attention(*args, scale=0.3, return_stats=stats)
    out = tuple(torch.full_like(w, 7.0) for w in want) if stats \
        else torch.full_like(want, 7.0)
    got = ops.paged_decode_attention(*args, scale=0.3, return_stats=stats,
                                     out=out)
    assert got is out
    for o, w in zip(got, want) if stats else [(got, want)]:
        torch.testing.assert_close(o, w, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_forward_splits_at_each_paged_call(layout):
    """A verify forward run under a split that makes each call it is
    handed: one split per target layer when paged (phase 1 of its two-phase
    decode), none when contiguous, none in the drafter's forwards, and the
    same tokens as without the split."""
    def engine():
        return build_engine(reduced=True, device="cpu", K=2, max_new=8,
                            max_len=64, batch=2, kv_layout=layout,
                            page_size=8, pool_pages=12)
    eng, ref = engine(), engine()
    names, forwards = [], []

    def split(name, args, kw):
        names.append(name)
        return getattr(ops, name)(*args, **kw)

    def verify(model, tparams, vt, **kw):
        forwards.append(vt.shape)
        with ops.graph_split(split):
            return eager(model, tparams, vt, **kw)
    eng.verify = verify
    got = Scheduler(eng).serve(requests())
    want = Scheduler(ref).serve(requests())
    assert forwards
    per = eng.tcfg.n_layers if layout == "paged" else 0
    assert names == ["paged_decode_attention"] * (per * len(forwards))
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


class _Recorder:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a capture runs
    the forward's operations at once and a replay does nothing."""
    log: list = []

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.log.append("begin")

    def capture_end(self):
        self.log.append("end")

    def replay(self):
        self.log.append("replay")


class _Stream:
    def wait_stream(self, other):
        pass


def test_capture_in_pieces_keeps_no_state(monkeypatch):
    for name, value in (("CUDAGraph", _Recorder), ("Stream", _Stream),
                        ("graph_pool_handle", lambda: 0),
                        ("current_stream", lambda *a: _Stream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("synchronize", lambda *a: None),
                        ("empty_cache", lambda: None),
                        ("memory_reserved", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, value)
    eng = build_engine(reduced=True, device="cpu", K=2, max_new=8,
                       max_len=64, batch=2, kv_layout="paged", page_size=8,
                       pool_pages=12)
    eng.verify = graphs = VerifyGraph()
    state = eng.blank_state()
    rng = np.random.default_rng(2)
    for slot in (0, 1):
        state, *_ = eng.prefill_into_slot(
            state, rng.integers(1, 200, 10).astype(np.int32), slot)
    before = verify_counts()
    _Recorder.log = []
    for _ in range(3):
        state = eng.step(state)
    after = verify_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "eager": 1, "captures": 1, "replays": 1}
    L = eng.tcfg.n_layers
    assert len(graphs._pieces) == L + 1 and len(graphs._calls) == L
    # each piece is replayed once as it is captured, then once a replay
    assert _Recorder.log == ["begin", "end", "replay"] * (L + 1) \
        + ["replay"] * (L + 1)
    for layer, (name, args, kw, out) in enumerate(graphs._calls):
        assert name == "paged_decode_attention"
        assert [tuple(a) for a in args[1:5]] == [
            ("cache", "blocks", layer, "k"), ("cache", "blocks", layer, "v"),
            ("cache", "blocks", layer, "positions"), ("block_table",)]
        assert args[5] is graphs._pos and kw["return_stats"]
    pools = [weakref.ref(state["tcache"]["blocks"][0][k])
             for k in ("k", "v", "positions")]
    pools.append(weakref.ref(state["block_table"]))
    del state
    gc.collect()
    assert [ref() for ref in pools] == [None] * 4

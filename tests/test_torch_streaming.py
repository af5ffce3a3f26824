"""The port's streaming front end on the CPU, against the JAX package's.

``AsyncEngine`` streams, token for token and logprob within 3e-5, what the
JAX package's ``virtual_twin_report`` gives for the same workload on
converted weights, greedy and sampled. Against the port's own virtual twin:
random churn with mid-stream aborts over a pool that preempts (survivors
exact, an aborted stream a prefix of its twin, no page leaked, the event
trace monotone under wall stamps), a stop token, ``adaptive_k``, the abort
of a queued request, ``close(drain=False)``, backpressure, a rejected
submit's ticket, a submit that got its ticket during the close, the
abort of a swapped-out request (its host bytes freed at once), a failing
dispatch loop, and the NDJSON socket server (round trip, and a dropped
connection aborting its requests). ``health()`` has the JAX engine's keys
and the port's counters, and interpolates its wait percentiles.

The reduced qwen2-1.5b in float32 (``torch_serving_setup``). Every async
test runs under ``asyncio.wait_for`` with a 60 s limit, so a livelocked
loop fails instead of hanging the suite."""
import ast
import asyncio
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from repro.serving import AsyncEngine as JAsyncEngine
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import virtual_twin_report as jvirtual_twin_report
from repro_torch.launch.serve_stream import start_stream_server
from repro_torch.serving import (AsyncEngine, Request, SamplingParams,
                                 Scheduler, virtual_twin_report)
from torch_serving_setup import jax_engine, port_engine, preempt_workload
import torch_threads  # noqa: F401  (torch threads per xdist worker)

LIMIT_S = 60


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def assert_pool_drained(eng):
    assert eng.allocator.n_free == eng.pool_pages, "leaked pages"
    assert not any(eng._slot_pages), "a slot still holds pages"


def make_workload(seed, n, sp_cls=SamplingParams, max_budget=8):
    """n requests of 2-8 tokens; odd ones sampled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(1, 200, size=int(rng.integers(2, 9))).astype(np.int32)
        sp = None if i % 2 == 0 else sp_cls(temperature=0.8, seed=50 + i)
        out.append((p, sp, int(rng.integers(2, max_budget + 1))))
    return out


def policy_workload(policy, sp_cls):
    rng = np.random.default_rng(1 if policy == "greedy" else 2)
    return [(rng.integers(1, 200, size=int(rng.integers(2, 9))).astype(np.int32),
             None if policy == "greedy"
             else sp_cls(temperature=0.7, top_p=0.9, seed=7 + i),
             int(rng.integers(3, 9)))
            for i in range(5)]


@lru_cache(maxsize=None)
def jax_paged_engine():
    return jax_engine()


@lru_cache(maxsize=None)
def jax_twin(policy):
    """The JAX package's virtual twin of ``policy_workload``, once per
    module."""
    rep = jvirtual_twin_report(jax_paged_engine(),
                               policy_workload(policy, JSamplingParams))
    return [(np.asarray(r["tokens"]), np.asarray(r["logprobs"]))
            for r in rep["results"]]


async def stream_all(aeng, workload):
    async def one(p, sp, b):
        return [pair async for pair in aeng.generate(p, sp,
                                                     max_new_tokens=b)]
    streams = await asyncio.gather(*(one(*w) for w in workload))
    return streams, await aeng.close()


# ---------------------------------------------------------------------------
# streamed == the virtual twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["greedy", "sampled"])
def test_streamed_equals_jax_virtual_twin(policy):
    """Concurrent streams, arriving in an order the twin never saw, yield
    the JAX twin's tokens exactly and its logprobs within 3e-5."""
    eng = port_engine()
    workload = policy_workload(policy, SamplingParams)
    streams, rep = run(stream_all(AsyncEngine(eng), workload))
    assert rep["aborted"] == 0 and rep["n_requests"] == len(workload)
    for got, (toks, lps) in zip(streams, jax_twin(policy)):
        assert [t for t, _ in got] == toks.tolist()
        np.testing.assert_allclose(np.asarray([lp for _, lp in got]), lps,
                                   rtol=3e-5, atol=3e-5)
    assert_pool_drained(eng)


def test_churn_random_aborts_no_leaks_survivors_exact():
    """A pool that preempts, max_pending 4, about half the requests aborted
    after 1-3 tokens: survivors equal the twin, an aborted stream is a
    prefix of its twin, no page leaks, and the event trace is monotone in
    wall time with submit <= admit <= finish per request."""
    eng = port_engine(pool_pages=5)
    workload = make_workload(seed=4, n=8, max_budget=12)
    twin = virtual_twin_report(eng, workload)
    assert twin["preemptions"] > 0
    assert_pool_drained(eng)
    rng = np.random.default_rng(5)
    abort_after = {i: int(rng.integers(1, 4))
                   for i in range(len(workload)) if rng.random() < 0.5}

    async def go():
        aeng = AsyncEngine(eng, max_pending=4)

        async def one(i, p, sp, b):
            out, handle = [], await aeng.submit(p, sp, max_new_tokens=b)
            async for tok, _ in handle:
                out.append(tok)
                if len(out) == abort_after.get(i):
                    handle.abort()
            return out, handle.aborted

        res = await asyncio.gather(*(one(i, *w)
                                     for i, w in enumerate(workload)))
        return res, await aeng.close()

    res, rep = run(go())
    n_aborted = sum(ab for _, ab in res)
    assert n_aborted and rep["aborted"] == n_aborted
    assert sum(r["aborted"] for r in rep["results"]) == n_aborted
    for (got, ab), ref in zip(res, twin["results"]):
        full = ref["tokens"].tolist()
        if ab:
            assert got == full[:len(got)], "an aborted stream retracted"
        else:
            assert got == full, "a survivor parted from the twin"
    times = [t for t, _, _ in rep["events"]]
    assert times == sorted(times)
    assert [k for _, k, _ in rep["events"]].count("abort") == n_aborted
    for r in rep["results"]:
        if not r["aborted"]:
            assert r["latency_s"] >= r["wait_s"] >= 0.0
    assert_pool_drained(eng)


def test_streamed_tokens_stop_at_the_stop_token():
    """Nothing past a stop token is ever streamed."""
    eng = port_engine()
    p = np.random.default_rng(3).integers(1, 200, size=5).astype(np.int32)
    ref = virtual_twin_report(eng, [(p, None, 12)])["results"][0]
    stop = int(ref["tokens"][4])
    want = ref["tokens"].tolist()
    want = want[:want.index(stop) + 1]

    async def go():
        aeng = AsyncEngine(eng, eos_id=stop)
        out = [t async for t, _ in aeng.generate(p, max_new_tokens=12)]
        await aeng.close()
        return out

    assert run(go()) == want
    assert_pool_drained(eng)


def test_streamed_equals_virtual_twin_with_controller():
    """``adaptive_k``: wall pacing moves the clock, never the controller."""
    eng = port_engine()
    workload = make_workload(seed=61, n=5)
    twin = virtual_twin_report(eng, workload, adaptive_k=True)
    streams, rep = run(stream_all(AsyncEngine(eng, adaptive_k=True),
                                  workload))
    assert rep["n_requests"] == len(workload) and "speculation" in rep
    for got, ref in zip(streams, twin["results"]):
        assert [t for t, _ in got] == ref["tokens"].tolist()
    assert_pool_drained(eng)


# ---------------------------------------------------------------------------
# aborts, close, backpressure
# ---------------------------------------------------------------------------

def test_abort_waiting_request_before_admission():
    eng = port_engine()
    workload = make_workload(seed=6, n=2)
    twin = virtual_twin_report(eng, workload)
    extra = np.random.default_rng(7).integers(1, 200, size=4).astype(np.int32)

    async def go():
        aeng = AsyncEngine(eng, max_pending=8)
        handles = [await aeng.submit(p, sp, max_new_tokens=b)
                   for p, sp, b in workload]
        victim = await aeng.submit(extra, max_new_tokens=8)
        assert victim.abort()
        assert not victim.abort(), "abort is idempotent"
        streams = [[t async for t, _ in h] for h in handles]
        vic = [t async for t, _ in victim]
        return streams, vic, await aeng.close()

    streams, vic, rep = run(go())
    aborted = [r for r in rep["results"] if r["aborted"]]
    assert rep["aborted"] == 1 and len(aborted) == 1
    assert aborted[0]["n_new"] == 0 and vic == []
    for got, ref in zip(streams, twin["results"]):
        assert got == ref["tokens"].tolist()
    assert_pool_drained(eng)


def test_close_without_drain_aborts_inflight():
    eng = port_engine()
    p = np.random.default_rng(8).integers(1, 200, size=6).astype(np.int32)

    async def go():
        aeng = AsyncEngine(eng)
        handles = [await aeng.submit(p, max_new_tokens=16) for _ in range(3)]
        await asyncio.sleep(0)
        rep = await aeng.close(drain=False)
        return [h.aborted for h in handles], rep

    aborted, rep = run(go())
    assert all(aborted) and rep["aborted"] == 3
    assert_pool_drained(eng)


def test_submit_waiting_for_a_ticket_at_close_raises():
    """max_pending 1: a submit waiting for the ticket when
    ``close(drain=False)`` aborts the request that holds it gets the ticket
    during the close; it gives it back and raises instead of entering the
    closing session, and every stream ends."""
    eng = port_engine()
    p = np.random.default_rng(12).integers(1, 200, size=5).astype(np.int32)

    async def go():
        aeng = AsyncEngine(eng, max_pending=1)
        first = await aeng.submit(p, max_new_tokens=16)
        waiting = asyncio.get_running_loop().create_task(
            aeng.submit(p, max_new_tokens=4))
        await asyncio.sleep(0)
        rep = await aeng.close(drain=False)
        got = [pair async for pair in first]
        with pytest.raises(RuntimeError, match="closing"):
            await waiting
        return first, got, rep, aeng._sem._value

    first, got, rep, tickets = run(go())
    assert first.aborted and len(got) < 16
    assert rep["n_requests"] == 1 and rep["aborted"] == 1
    assert tickets == 1
    assert_pool_drained(eng)


def test_backpressure_bounds_inflight_without_deadlock():
    """max_pending 2: health() never sees more in flight, every request
    still ends with the twin's stream."""
    eng = port_engine()
    workload = make_workload(seed=9, n=6, max_budget=5)
    twin = virtual_twin_report(eng, workload)

    async def go():
        aeng = AsyncEngine(eng, max_pending=2)
        await aeng.start()
        seen, stop = [], asyncio.Event()

        async def monitor():
            while not stop.is_set():
                seen.append(aeng.health()["inflight"])
                await asyncio.sleep(0)

        mon = asyncio.get_running_loop().create_task(monitor())
        streams = await asyncio.gather(*(
            asyncio.create_task(_collect(aeng, w)) for w in workload))
        stop.set()
        await mon
        return streams, seen, await aeng.close()

    streams, seen, rep = run(go())
    assert 1 <= max(seen) <= 2
    assert rep["n_requests"] == len(workload) and rep["aborted"] == 0
    for got, ref in zip(streams, twin["results"]):
        assert got == ref["tokens"].tolist()
    assert_pool_drained(eng)


async def _collect(aeng, w):
    p, sp, b = w
    return [t async for t, _ in aeng.generate(p, sp, max_new_tokens=b)]


def test_rejected_submit_returns_ticket():
    """A request that could never fit gives its ticket back: with
    max_pending 1 the next one is served."""
    eng = port_engine()
    p = np.random.default_rng(10).integers(1, 200, size=4).astype(np.int32)

    async def go():
        aeng = AsyncEngine(eng, max_pending=1)
        with pytest.raises(ValueError):
            await aeng.submit(p, max_new_tokens=10_000)
        out = [t async for t, _ in aeng.generate(p, max_new_tokens=3)]
        return out, await aeng.close()

    out, rep = run(go())
    assert len(out) == 3 and rep["n_requests"] == 1
    assert_pool_drained(eng)


def test_abort_swapped_request_frees_host_bytes_at_once():
    """A request swapped out to the host, aborted: its bytes leave the host
    pool right away, health() shows the gauges, survivors equal their
    uninterrupted runs."""
    eng = port_engine(pool_pages=5, swap="host")
    prompts, budgets = preempt_workload()

    async def go():
        aeng = AsyncEngine(eng)
        handles = [await aeng.submit(p, max_new_tokens=b)
                   for p, b in zip(prompts, budgets)]
        while aeng.health()["swapped"] == 0:
            assert not all(h.done for h in handles), "nothing was swapped"
            await asyncio.sleep(0.005)
        h = aeng.health()
        assert h["swapped"] == 1 and h["host_pool_used_bytes"] > 0
        assert h["host_pool_peak_bytes"] >= h["host_pool_used_bytes"]
        assert h["host_pool_bytes"] == 0             # unbounded
        victim = next(hd for hd in handles if eng.has_swap(hd.rid))
        assert victim.abort()
        assert eng.host_pool.used_bytes == 0 and len(eng.host_pool) == 0
        assert aeng.health()["swapped"] == 0
        outs = [[t async for t, _ in hd] for hd in handles
                if hd is not victim]
        await aeng.close()
        return handles.index(victim), outs

    v, outs = run(go())
    ref = port_engine(pool_pages=5)
    keep = [i for i in range(len(prompts)) if i != v]
    for i, got in zip(keep, outs):
        solo = Scheduler(ref).serve([Request(prompts[i],
                                             max_new_tokens=budgets[i])])
        assert got == solo["results"][0]["tokens"].tolist(), i
    assert_pool_drained(eng)
    assert eng.host_pool.used_bytes == 0


def test_dispatch_error_reaches_every_open_stream(monkeypatch):
    """A failing step: every open stream raises the error, as does a later
    submit and close."""
    eng = port_engine()

    def broken(*a, **kw):
        raise RuntimeError("step failed")

    monkeypatch.setattr(eng, "step", broken)
    p = np.arange(1, 6, dtype=np.int32)

    async def go():
        aeng = AsyncEngine(eng)
        handles = [await aeng.submit(p, max_new_tokens=8) for _ in range(3)]
        errors = []
        for h in handles:
            with pytest.raises(RuntimeError, match="step failed"):
                async for _ in h:
                    pass
            errors.append(True)
        with pytest.raises(RuntimeError, match="step failed"):
            await aeng.submit(p, max_new_tokens=2)
        with pytest.raises(RuntimeError, match="step failed"):
            await aeng.close()
        return errors, aeng.health()

    errors, h = run(go())
    assert errors == [True] * 3 and h["inflight"] == 0


# ---------------------------------------------------------------------------
# health()
# ---------------------------------------------------------------------------

def test_health_has_the_jax_engines_keys():
    eng = port_engine()
    p = np.random.default_rng(11).integers(1, 200, size=4).astype(np.int32)

    async def go():
        aeng = AsyncEngine(eng)
        await aeng.start()
        empty = aeng.health()
        out = [t async for t, _ in aeng.generate(p, max_new_tokens=4)]
        h = aeng.health()
        rep = await aeng.close()
        jaeng = JAsyncEngine(jax_paged_engine())
        await jaeng.start()
        jh = jaeng.health()
        await jaeng.close()
        return empty, out, h, rep, jh

    empty, out, h, rep, jh = run(go())
    # beside the JAX engine's keys, the port's counters (``tracing``)
    assert set(h) == set(jh) | {"counters"} == set(empty)
    assert h["counters"]["serving"]["admissions"] >= 1
    assert empty["finished"] == 0 and empty["p50_wait_s"] == 0.0
    assert len(out) == 4 and h["finished"] == 1 and h["queue_depth"] == 0
    assert h["slots"] == eng.batch and h["pool_pages"] == eng.pool_pages
    assert 0.0 <= h["pool_occupancy"] <= 1.0
    assert h["p99_wait_s"] >= h["p50_wait_s"] >= 0.0
    assert rep["results"][0]["latency_s"] >= rep["results"][0]["wait_s"] >= 0


def test_health_wait_percentiles_interpolate():
    """Waits of 1, 2, 3 and 10 s: the percentiles lie between order
    statistics (numpy's linear rule), not on them."""
    eng = port_engine()
    p = np.random.default_rng(13).integers(1, 200, size=4).astype(np.int32)

    async def go():
        aeng = AsyncEngine(eng)
        await aeng.start()
        for wait in (3.0, 1.0, 10.0, 2.0):
            r = Request(p, max_new_tokens=2)
            r.status, r.t_submit, r.t_admit = "finished", 100.0, 100.0 + wait
            aeng.scheduler._finished.append(r)
        h = aeng.health()
        aeng.scheduler._finished.clear()
        await aeng.close()
        return h

    h = run(go())
    assert h["p50_wait_s"] == pytest.approx(2.5)
    assert h["p99_wait_s"] == pytest.approx(3.0 + 0.97 * 7.0)


def test_clock_moves_only_through_advance():
    """Wall sessions must not get virtual stamps: outside ``_advance`` the
    scheduler adds nothing to ``_clock`` (the idle jump of ``serve()``
    sets it)."""
    path = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "serving" / "scheduler.py")
    adds = [fn.name for fn in ast.walk(ast.parse(path.read_text()))
            if isinstance(fn, ast.FunctionDef)
            for node in ast.walk(fn) if isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Attribute)
            and node.target.attr == "_clock"]
    assert adds == ["_advance"]


# ---------------------------------------------------------------------------
# the NDJSON socket server
# ---------------------------------------------------------------------------

def test_ndjson_socket_roundtrip():
    """generate (greedy and sampled), abort, health and a bad op over a
    socket on 127.0.0.1: the streams equal the twin, the aborted stream
    ends with an aborted done event, the bad op gets an error."""
    eng = port_engine()
    rng = np.random.default_rng(12)
    p0 = rng.integers(1, 200, size=5).astype(np.int32)
    p1 = rng.integers(1, 200, size=7).astype(np.int32)
    sp1 = SamplingParams(temperature=0.8, seed=3)
    twin = virtual_twin_report(eng, [(p0, None, 5), (p1, sp1, 6)])

    async def go():
        aeng = AsyncEngine(eng)
        server = await start_stream_server(aeng, port=0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)

        def send(obj):
            writer.write((json.dumps(obj) + "\n").encode())

        send({"op": "generate", "id": "g", "prompt": p0.tolist(),
              "max_new_tokens": 5})
        send({"op": "generate", "id": "s", "prompt": p1.tolist(),
              "max_new_tokens": 6, "temperature": 0.8, "seed": 3})
        send({"op": "generate", "id": "a", "prompt": p0.tolist(),
              "max_new_tokens": 16})
        send({"op": "abort", "id": "a"})
        send({"op": "health"})
        send({"op": "nonsense"})
        await writer.drain()
        toks, lps, done, health, errors = {}, {}, {}, None, []
        while len(done) < 3 or health is None or not errors:
            msg = json.loads(await reader.readline())
            ev = msg.get("event")
            if ev == "tokens":
                toks.setdefault(msg["id"], []).extend(msg["tokens"])
                lps.setdefault(msg["id"], []).extend(msg["logprobs"])
            elif ev == "done":
                done[msg["id"]] = msg
            elif ev == "health":
                health = msg
            elif ev == "error":
                errors.append(msg)
        writer.close()
        server.close()
        await server.wait_closed()
        await aeng.close()
        return toks, lps, done, health, errors

    toks, lps, done, health, errors = run(go())
    assert toks["g"] == twin["results"][0]["tokens"].tolist()
    assert toks["s"] == twin["results"][1]["tokens"].tolist()
    np.testing.assert_allclose(np.asarray(lps["s"], np.float32),
                               twin["results"][1]["logprobs"], rtol=1e-5)
    assert not done["g"]["aborted"] and done["g"]["n_new"] == 5
    assert not done["s"]["aborted"] and done["s"]["n_new"] == 6
    assert done["a"]["aborted"] and done["a"]["n_new"] < 16
    got_a = toks.get("a", [])
    assert got_a == twin["results"][0]["tokens"].tolist()[:len(got_a)]
    assert health["slots"] == eng.batch
    assert any("unknown op" in e["message"] for e in errors)
    assert_pool_drained(eng)


def test_socket_disconnect_aborts_inflight():
    """A dropped connection aborts its requests and their pages return. One
    slot and a second, queued request: the queued one cannot finish before
    the disconnect lands."""
    eng = port_engine(batch=1)
    rng = np.random.default_rng(13)
    p = rng.integers(1, 200, size=6).astype(np.int32)
    q = rng.integers(1, 200, size=5).astype(np.int32)

    async def go():
        aeng = AsyncEngine(eng)
        server = await start_stream_server(aeng, port=0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for cid, prompt in (("x", p), ("y", q)):
            writer.write((json.dumps(
                {"op": "generate", "id": cid, "prompt": prompt.tolist(),
                 "max_new_tokens": 16}) + "\n").encode())
        await writer.drain()
        await reader.readline()              # the first tokens: running
        writer.close()
        for _ in range(2000):
            if aeng.health()["inflight"] == 0:
                break
            await asyncio.sleep(0.01)
        server.close()
        await server.wait_closed()
        return await aeng.close()

    rep = run(go())
    assert rep["aborted"] >= 1
    assert_pool_drained(eng)

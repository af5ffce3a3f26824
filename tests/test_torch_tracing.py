"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

Without a profiler nothing is recorded and the counters still count. Under
a CPU ``torch.profiler`` session a paged ``Scheduler.serve`` of the reduced
qwen2-1.5b gives the span tree: each ``sched.dispatch`` holds
``sync_every`` ``engine.step`` spans, each step its phases in order, each
``engine.admit`` the request's rid (the scheduler's ``admit`` events, in
order) and its parts; ``sync`` spans match the ``host_syncs`` and
``readback_bytes`` counters; and the spans lie inside a
``record_function`` range opened around the same call in the same
profile. A span site with no profiler costs a check of a flag.
``launch.profile_serve``'s tables by span, of steps and of one
admission."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.launch.serve import build_engine
from repro_torch.serving.scheduler import Request, Scheduler
import torch_threads  # noqa: F401  (torch threads per xdist worker)

SYNC_EVERY = 2
PHASES = ["step.draft", "step.verify", "step.accept", "step.commit",
          "step.extend"]


@pytest.fixture(scope="module")
def engine():
    # a pool of 7 pages: the third request waits for the first to end
    return build_engine(reduced=True, device="cpu", K=2, max_new=8,
                        max_len=64, batch=2, kv_layout="paged", page_size=8,
                        pool_pages=7)


def requests():
    rng = np.random.default_rng(0)
    return [Request(rng.integers(1, 200, 6 + 3 * i).astype(np.int32),
                    max_new_tokens=5 + i) for i in range(3)]


def profile(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def children(spans, parent):
    return [s for s in spans if s.parent is parent]


@pytest.fixture(scope="module")
def traced(engine):
    """(spans, the serve's report, counters before, counters after)."""
    tracing.clear()
    before = tracing.counters()["serving"]
    rep, _ = profile(lambda: Scheduler(engine, sync_every=SYNC_EVERY)
                     .serve(requests()))
    after = tracing.counters()["serving"]
    spans = tracing.spans()
    tracing.clear()
    return spans, rep, before, after


def test_nothing_recorded_without_a_profiler(engine):
    tracing.clear()
    before = tracing.counters()["serving"]
    rep = Scheduler(engine).serve(requests()[:1])
    after = tracing.counters()["serving"]
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert after["steps"] - before["steps"] == rep["iterations"]
    assert after["admissions"] - before["admissions"] == 1
    assert after["host_syncs"] > before["host_syncs"]


def test_the_span_tree(traced):
    spans, rep, _, _ = traced
    assert all(s.t1 is not None and s.t0 <= s.t1 for s in spans)
    for s in spans:           # a child lies inside its parent
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1
    dispatch = [s for s in spans if s.name == "sched.dispatch"]
    steps = [s for s in spans if s.name == "engine.step"]
    assert dispatch and len(steps) == rep["iterations"]
    for d in dispatch:
        assert [c.name for c in children(spans, d)] == \
            ["engine.step"] * SYNC_EVERY
    for st in steps:
        kids = children(spans, st)
        assert [c.name for c in kids] == PHASES
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    for name in ("sched.admit_waiting", "sched.grow", "sched.dispatch",
                 "sched.harvest"):
        assert all(s.parent is None for s in spans if s.name == name)
    for h in (s for s in spans if s.name == "sched.harvest"):
        assert [c.name for c in children(spans, h)] == ["sync"]


def test_admission_spans_carry_the_request(traced):
    spans, rep, _, _ = traced
    admits = [s for s in spans if s.name == "engine.admit"]
    events = [rid for _, kind, rid in rep["events"] if kind == "admit"]
    assert [s.attrs["rid"] for s in admits] == events
    lens = {r["rid"]: 6 + 3 * i for i, r in enumerate(rep["results"])}
    for a in admits:
        assert a.parent.name == "sched.admit_waiting"
        assert a.attrs["tokens"] == lens[a.attrs["rid"]]
        kids = children(spans, a)
        names = [c.name for c in kids]
        assert {"prefill.target", "prefill.drafter", "admit.write"} <= \
            set(names)
        # the prompt's read, then the last position, logprob and token
        assert names.count("sync") == 4
        assert all(c.attrs["rid"] == a.attrs["rid"] for c in kids)


def test_sync_spans_match_the_counters(traced):
    spans, rep, before, after = traced
    syncs = [s for s in spans if s.name == "sync"]
    assert len(syncs) == after["host_syncs"] - before["host_syncs"]
    assert sum(s.attrs["bytes"] for s in syncs) == \
        after["readback_bytes"] - before["readback_bytes"]
    assert after["steps"] - before["steps"] == rep["iterations"]
    assert after["admissions"] - before["admissions"] == 3
    assert after["admitted_prompt_tokens"] - \
        before["admitted_prompt_tokens"] == 6 + 9 + 12
    assert after["page_claims"] > before["page_claims"]


def ranges(prof, name):
    """(start, end) ns of the profile's ``record_function`` ranges."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == name)


def test_stamps_share_the_profilers_clock():
    """A ``sync`` span opened right inside a ``record_function`` range
    lies inside it, to 50 us at either end: the two clocks agree to that
    (a load on the host only widens the gaps)."""
    t = torch.arange(8)
    tracing.clear()

    def reads():
        for _ in range(200):
            with torch.profiler.record_function("probe.read"):
                tracing.to_host(t)
    _, prof = profile(reads)
    syncs = tracing.spans()
    tracing.clear()
    got = ranges(prof, "probe.read")
    assert len(got) == len(syncs) == 200
    gaps = [g for (r0, r1), s in zip(got, syncs)
            for g in (s.t0 - r0, r1 - s.t1)]
    assert min(gaps) > -50_000


def test_step_spans_lie_inside_a_range_around_the_call(engine, monkeypatch):
    """``engine.step`` spans against ranges opened around ``Engine.step``,
    as the benchmark's harness opens them: one span a range, inside it
    (what lies between is the call's own host work)."""
    orig = engine.step

    def ranged(*a, **kw):
        with torch.profiler.record_function("probe.step"):
            return orig(*a, **kw)
    monkeypatch.setattr(engine, "step", ranged)
    tracing.clear()
    _, prof = profile(lambda: Scheduler(engine).serve(requests()[:2]))
    steps = [s for s in tracing.spans() if s.name == "engine.step"]
    tracing.clear()
    got = ranges(prof, "probe.step")
    assert len(got) == len(steps) > 0
    for (r0, r1), s in zip(got, steps):
        assert r0 <= s.t0 + 50_000 and s.t1 <= r1 + 50_000


def test_a_span_site_without_a_profiler_costs_a_flag_check():
    """With no profiler a span site checks the flag and hands back one
    shared do-nothing context: no record, no object made, no attribute
    kept. (Its time, 0.6 us a site, is measured, not asserted: a test's
    clock on a shared host is not a yardstick.)"""
    off = tracing.span("x", rid=1)
    assert tracing.span("y") is off and tracing.request(3) is off

    @tracing.spanned("z")
    def f(v):
        return v + 1
    tracing.clear()
    for i in range(1000):
        with tracing.span("x", rid=i) as rec:
            assert rec is None
        with tracing.request(i):
            assert f(i) == i + 1
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_the_log_is_capped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("a"):
            for _ in range(4):
                with tracing.span("b"):
                    pass
    spans = tracing.spans()
    assert [s.name for s in spans] == ["a", "b", "b"]
    assert tracing.dropped() == 2 and tracing.spans() == spans
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_profile_serve_tables():
    """``launch.profile_serve``'s table by program span and its counters
    a step, on synthetic records and kernels (ns)."""
    from repro_torch.launch import profile_serve as PS
    step = tracing.Span("engine.step", None, 0, {})
    step.t1 = 1_000_000
    draft = tracing.Span("step.draft", step, 100_000, {})
    draft.t1 = 400_000
    kernels = [(200_000, 300_000), (250_000, 350_000), (900_000, 1_200_000)]
    table = PS.span_table([step, draft], kernels, steps=2)
    assert table["engine.step"] == {"calls": 1, "host_ms_per_step": 0.5,
                                    "device_ms_per_step": 0.125,
                                    "idle_ms_per_step": 0.375}
    assert table["step.draft"]["device_ms_per_step"] == 0.075
    before = {"serving": {"steps": 3, "host_syncs": 1}, "launches": {"f": 0},
              "collectives": {"use": {"calls": 0}}}
    after = {"serving": {"steps": 7, "host_syncs": 1}, "launches": {"f": 8},
             "collectives": {"use": {"calls": 0}}}
    assert PS.counters_per_step(before, after, 4) == {
        "serving.steps": 1.0, "launches.f": 2.0}


def test_profile_serve_admission_table(engine):
    """``launch.profile_serve``'s table of one admission, profiled: the
    admission and its parts, each once, and its four readbacks."""
    from repro_torch.launch import profile_serve as PS
    prompt = np.arange(1, 12, dtype=np.int32)
    state = engine.blank_state()
    state, table = PS.admission_table(engine, state, prompt, 0, 6)
    engine.free_slot(state, 0)
    assert {k: r["calls"] for k, r in table.items()} == {
        "engine.admit": 1, "prefill.target": 1, "prefill.drafter": 1,
        "admit.write": 1, "sync": 4}
    adm = table["engine.admit"]
    assert adm["host_ms_per_admission"] > 0
    assert adm["device_ms_per_admission"] == 0       # no card here
    assert adm["idle_ms_per_admission"] == adm["host_ms_per_admission"]
    assert tracing.spans() == []

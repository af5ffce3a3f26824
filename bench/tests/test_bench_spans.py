"""The reductions of the program's spans (``bench/lib/spans.py``) on
synthetic spans and kernels: self time with nested children, device time
clipped to spans, the per-iteration ratios, and None without spans; the
six readers silent on a program log with nothing in it; the program's log
read into spans.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import sys

import pytest
import torch

from bench.lib import common
from bench.lib import spans as S
from bench.lib.record import Record, TraceData

READERS = ("sched_self_ms_per_iteration", "admit_ms_p50",
           "step_device_idle_share", "draft_device_ms_per_iteration",
           "host_syncs_per_iteration", "readback_mb_per_iteration")


def sp(i, name, parent, start, end, **attrs):
    return S.Span(i, name, parent, start, end, attrs)


def stretch():
    """Two iterations of 0.1 s from t = 10 s: an admission pass (one
    admission of 0.05 s with its four readbacks of 4 bytes), a grow pass
    of 0.01 s, a dispatch pass holding the step (its draft 0.02 s and
    extend 0.01 s) and a harvest pass with one readback of 1000 bytes."""
    out = []

    def add(name, parent, a, b, **attrs):
        out.append(sp(len(out), name, parent, a, b, **attrs))
        return len(out) - 1

    for k in range(2):
        t = 10.0 + 0.2 * k
        aw = add("sched.admit_waiting", None, t, t + 0.06)
        if k == 0:
            ad = add("engine.admit", aw, t + 0.005, t + 0.055, rid=7)
            for j in range(4):
                add("sync", ad, t + 0.01 + 0.01 * j, t + 0.011 + 0.01 * j,
                    bytes=4)
        add("sched.grow", None, t + 0.06, t + 0.07)
        d = add("sched.dispatch", None, t + 0.07, t + 0.17)
        st = add("engine.step", d, t + 0.075, t + 0.165)
        add("step.draft", st, t + 0.08, t + 0.1)
        add("step.extend", st, t + 0.15, t + 0.16)
        h = add("sched.harvest", None, t + 0.17, t + 0.19)
        add("sync", h, t + 0.175, t + 0.185, bytes=1000)
    return out


def test_self_time_with_nested_children():
    s = stretch()
    # admit pass 0.06 less its admission 0.05, twice less nothing; grow
    # 0.01; dispatch 0.1 less the step 0.09; harvest 0.02 less its sync
    # 0.01: (0.01 + 0.06 + 2 * 0.01 + 2 * 0.01 + 2 * 0.01) / 2 iterations
    assert S.sched_self_ms_per_iteration(s) == pytest.approx(65.0)
    # children that overlap are counted once, and only inside the parent
    parent = sp(0, "sched.grow", None, 1.0, 2.0)
    kids = [sp(1, "x", 0, 0.5, 1.2), sp(2, "y", 0, 1.1, 1.3),
            sp(3, "z", 0, 1.9, 2.5)]
    assert S.self_seconds(parent, kids) == pytest.approx(0.6)


def test_busy_time_is_clipped_to_spans():
    s = stretch()
    t0 = 10.0
    kernels = [("a", t0 + 0.09, 0.02),      # 0.01 inside the draft
               ("b", t0 + 0.095, 0.01),     # overlaps a: counted once
               ("c", t0 + 0.155, 0.01),     # 0.005 inside the extend
               ("d", t0 + 0.5, 0.05)]       # outside every span
    assert S.device_seconds(kernels, [x for x in s if x.name == "step.draft"
                                      ]) == pytest.approx(0.01)
    assert S.draft_device_ms_per_iteration(s, kernels) == pytest.approx(
        (10.0 + 5.0) / 2)
    # the steps: 0.02 + 0.01 busy of 2 x 0.09 in the first, 0 in the second
    busy_first = 0.02 + 0.01
    assert S.step_device_idle_share(s, kernels) == pytest.approx(
        100 * (1 - busy_first / 0.18))


def test_per_iteration_ratios_and_the_median_admission():
    s = stretch()
    assert S.iterations(s) == 2
    assert S.host_syncs_per_iteration(s) == pytest.approx(6 / 2)
    assert S.readback_mb_per_iteration(s) == pytest.approx(
        (16 + 2000) * 1e-6 / 2)
    assert S.admit_ms_p50(s) == pytest.approx(50.0)


def test_none_without_spans_or_iterations():
    for spans in (None, []):
        assert S.sched_self_ms_per_iteration(spans) is None
        assert S.admit_ms_p50(spans) is None
        assert S.step_device_idle_share(spans, [("k", 0.0, 1.0)]) is None
        assert S.draft_device_ms_per_iteration(spans, [("k", 0, 1)]) is None
        assert S.host_syncs_per_iteration(spans) is None
        assert S.readback_mb_per_iteration(spans) is None
    # spans but no step: no iterations to divide by
    only = [sp(0, "sched.grow", None, 0.0, 1.0), sp(1, "sync", 0, 0, 1)]
    assert S.host_syncs_per_iteration(only) is None
    assert S.step_device_idle_share(only, [("k", 0.0, 1.0)]) is None
    assert S.step_device_idle_share(stretch(), []) is None


def test_readers_silent_without_program_spans(monkeypatch):
    """A log with nothing in it, and a program without the module (as
    before the program recorded spans): every reader gives None."""
    from repro_torch import tracing
    tracing.clear()
    rec = Record(setup_s=1.0, window=(0.0, 1.0), requests=[],
                 step_times=[], flops=[],
                 trace=TraceData(window_s=1.0, iterations=2,
                                 kernels=[("k", 0.0, 0.5)], spans=[],
                                 calls=[]))
    for name in READERS:
        assert common.metric_reader(name)(rec) is None, name
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("engine.step"):
            pass
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    with pytest.raises(ImportError):
        from repro_torch import tracing  # noqa: F401, F811
    assert S.program_spans() is None
    for name in READERS:
        assert common.metric_reader(name)(rec) is None, name
    tracing.clear()


def test_program_log_read_into_spans():
    from repro_torch import tracing
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("engine.step"):
            with tracing.span("step.draft"):
                pass
        tracing.to_host(torch.zeros(3, dtype=torch.int32))
    got = S.program_spans()
    tracing.clear()
    assert [(s.id, s.name, s.parent) for s in got] == [
        (0, "engine.step", None), (1, "step.draft", 0), (2, "sync", None)]
    assert got[0].start <= got[1].start <= got[1].end <= got[0].end
    assert got[2].attrs == {"bytes": 12}
    assert S.host_syncs_per_iteration(got) == 1.0
    assert S.program_spans() is None

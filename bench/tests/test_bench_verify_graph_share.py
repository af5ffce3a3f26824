"""The reader of ``verify_graph_share`` on the program's own spans,
recorded under a CPU profiler: the steps that hold a ``verify.replay``
span, over all steps; nothing without spans, or for a program without the
verify graph's counters.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_verify_graph_share.py
"""
import pytest
import torch

from bench.lib import common
from repro_torch import tracing


def _record(steps_with_replay, steps_without, stray=False):
    """Spans of a CPU profiler session: steps whose verify replays, steps
    whose verify ran eagerly, and with ``stray`` a replay outside any
    step."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for replay in [True] * steps_with_replay + [False] * steps_without:
            with tracing.span("engine.step"):
                with tracing.span("step.draft"):
                    pass
                with tracing.span("step.verify"):
                    if replay:
                        with tracing.span("verify.replay"):
                            pass
        if stray:
            with tracing.span("verify.replay"):
                pass


@pytest.mark.parametrize("with_replay,without,stray,want", [
    (3, 0, False, 100.0),
    (2, 1, True, 200.0 / 3),
    (0, 4, False, 0.0),
])
def test_verify_graph_share_reads_the_program_spans(with_replay, without,
                                                    stray, want):
    read = common.metric_reader("verify_graph_share")
    tracing.clear()
    try:
        _record(with_replay, without, stray)
        assert read(None) == pytest.approx(want)
    finally:
        tracing.clear()


def test_verify_graph_share_is_silent_without_the_program_s_graph(
        monkeypatch):
    read = common.metric_reader("verify_graph_share")
    tracing.clear()
    try:
        assert read(None) is None                     # no spans
        _record(2, 0)
        monkeypatch.setattr(tracing, "counters", lambda: {"serving": {
            "steps": 2}})                             # a program without it
        assert read(None) is None
    finally:
        tracing.clear()

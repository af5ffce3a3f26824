"""The program's own spans in a traced run, and their reductions.

The port records spans inside its serving path (``repro_torch.tracing``)
while a ``torch.profiler`` session records, so its log holds the traced
stretch alone: the scheduler's passes (``sched.*``), the engine's step and
admission (``engine.step``, ``engine.admit``), the step's phases
(``step.draft``, ``step.verify``, ``step.accept``, ``step.commit``,
``step.extend``) and each device-to-host readback (``sync``, with its
``bytes``). Its stamps are on the clock of the profiler's events, the
clock of ``TraceData.kernels``. A program without that module, or a log
with nothing in it, gives None, and every reduction below then gives None.

Iterations are the ``engine.step`` spans. The device time inside a span is
the busy union of the stretch's kernels intersected with the span's
interval: a kernel launched just before a span ends may run a few
microseconds into the next span, and counts there.
"""
from __future__ import annotations

import bisect
from typing import List, NamedTuple, Optional, Sequence

from bench.lib import trace as T
from bench.lib.common import percentile


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]            # the id of the span it was opened in
    start: float                     # seconds, the profiler's clock
    end: float
    attrs: dict


def program_spans() -> Optional[List[Span]]:
    """The program's log (``repro_torch.tracing.spans()``) as ``Span``s;
    None where the program records no spans."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    recs = tracing.spans()
    if not recs:
        return None
    ids = {id(r): i for i, r in enumerate(recs)}
    return [Span(i, r.name,
                 None if r.parent is None else ids.get(id(r.parent)),
                 r.t0 * 1e-9, (r.t0 if r.t1 is None else r.t1) * 1e-9,
                 dict(r.attrs))
            for i, r in enumerate(recs)]


def iterations(spans: Sequence[Span]) -> int:
    return sum(1 for s in spans if s.name == "engine.step")


def _covered(a: float, b: float, merged, starts) -> float:
    """Seconds of [a, b] that ``merged`` covers: sorted, disjoint
    (start, end) intervals, ``starts`` their starts."""
    total = 0.0
    for x, y in merged[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if x >= b:
            break
        total += max(0.0, min(y, b) - max(x, a))
    return total


def self_seconds(s: Span, kids: Sequence[Span]) -> float:
    """The span's duration less what its direct children ``kids``
    cover."""
    merged = T.busy_intervals([(c.name, c.start, c.end - c.start)
                               for c in kids])
    return (s.end - s.start) - _covered(s.start, s.end, merged,
                                        [x for x, _ in merged])


def device_seconds(kernels, spans: Sequence[Span]) -> float:
    """Busy seconds of the card inside the spans' intervals."""
    busy = T.busy_intervals(kernels)
    starts = [x for x, _ in busy]
    return sum(_covered(s.start, s.end, busy, starts) for s in spans)


def _per_iteration(spans, value) -> Optional[float]:
    if not spans:
        return None
    n = iterations(spans)
    return value(spans) / n if n else None


# ---------------------------------------------------------------------------
# the per-layer metrics
# ---------------------------------------------------------------------------

def sched_self_ms_per_iteration(spans) -> Optional[float]:
    """Self time of the scheduler's passes, ms an iteration."""
    def total(sp):
        kids: dict = {}
        for c in sp:
            kids.setdefault(c.parent, []).append(c)
        return 1e3 * sum(self_seconds(s, kids.get(s.id, ()))
                         for s in sp if s.name.startswith("sched."))
    return _per_iteration(spans, total)


def admit_ms_p50(spans) -> Optional[float]:
    """The median ``engine.admit`` span, ms."""
    p = percentile([s.end - s.start for s in spans or ()
                    if s.name == "engine.admit"], 50)
    return None if p is None else 1e3 * p


def step_device_idle_share(spans, kernels) -> Optional[float]:
    """Percent of the ``engine.step`` spans' time the card was idle."""
    steps = [s for s in spans or () if s.name == "engine.step"]
    host = sum(s.end - s.start for s in steps)
    if not kernels or host <= 0:
        return None
    return 100.0 * (1.0 - device_seconds(kernels, steps) / host)


def draft_device_ms_per_iteration(spans, kernels) -> Optional[float]:
    """The drafter's device ms an iteration: busy inside ``step.draft``
    and ``step.extend``."""
    if not kernels:
        return None
    return _per_iteration(spans, lambda sp: 1e3 * device_seconds(
        kernels, [s for s in sp if s.name in ("step.draft", "step.extend")]))


def host_syncs_per_iteration(spans) -> Optional[float]:
    return _per_iteration(
        spans, lambda sp: sum(1 for s in sp if s.name == "sync"))


def readback_mb_per_iteration(spans) -> Optional[float]:
    """Bytes the ``sync`` spans read back, in 10^6, an iteration."""
    return _per_iteration(spans, lambda sp: 1e-6 * sum(
        s.attrs.get("bytes", 0) for s in sp if s.name == "sync"))

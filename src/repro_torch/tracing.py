"""Spans and counters of the serving path.

``span(name, **attrs)`` (a context manager) and ``spanned(name)`` (a
decorator) mark a piece of the program's work: the scheduler's passes
(``sched.*``), the engine's step and admission (``engine.*``), the step's
phases (``step.*``), the admission's parts (``prefill.*``, ``admit.*``)
and every device-to-host readback (``sync``). A span is recorded only
while a ``torch.profiler`` session records (the benchmark's traced
stretch, ``launch/profile_serve.py``); otherwise a span site costs one
check of the profiler's flag. Each record holds its name, the record of
the span it was opened in (``parent``), its start and end in nanoseconds
of ``time.time_ns()`` (the clock of the profiler's events: ``start_ns`` of
a kineto event) and its attributes: a span opened inside ``request(rid)``
carries that ``rid``, and ``annotate`` adds to the innermost open span's.
Records go to an in-memory log of at most ``MAX_SPANS``; what does not fit
is counted (``dropped()``). ``spans()`` reads the log, as often as asked;
``clear()`` empties it.

The program opens no profiler range (``record_function``) for its spans:
kineto mirrors every range onto the device as a user annotation, which a
reader of the device trace would count as an operation.

Counters are always on, plain integer adds (``count``): steps, admissions
and their prompt tokens, page claims, host syncs and the bytes they read
back. ``counters()`` returns them beside the kernels' launch counts
(``kernels.ops.launches``) and the collectives' (``sharding.utils
.counters()``), read where they are kept.

``to_host(t)`` is the one way the serving path reads a tensor back: a
``sync`` span with its ``bytes``, counted in ``host_syncs`` and
``readback_bytes``.
"""
from __future__ import annotations

import functools
import time

import torch

MAX_SPANS = 100_000

_profiling = torch._C._autograd._profiler_enabled


class Span:
    """One record of the log: ``parent`` is the record it was opened in
    (None at the top), ``t0`` / ``t1`` nanoseconds (``t1`` None while it
    is open)."""
    __slots__ = ("name", "parent", "t0", "t1", "attrs")

    def __init__(self, name, parent, t0, attrs):
        self.name, self.parent, self.t0, self.t1 = name, parent, t0, None
        self.attrs = attrs


_log: list = []
_stack: list = []          # the open records (None for one not kept)
_rid: list = []            # the request whose work is under way
_dropped = 0


class _Open:
    __slots__ = ("rec",)

    def __init__(self, name, attrs):
        global _dropped
        parent = _stack[-1] if _stack else None
        if _rid and "rid" not in attrs:
            attrs["rid"] = _rid[-1]
        rec = None
        if len(_log) < MAX_SPANS:
            rec = Span(name, parent, time.time_ns(), attrs)
            _log.append(rec)
        else:
            _dropped += 1
        self.rec = rec

    def __enter__(self):
        _stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        _stack.pop()
        if self.rec is not None:
            self.rec.t1 = time.time_ns()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records ``name`` over its body while a
    profiler records, and does nothing otherwise."""
    if not _profiling():
        return _OFF
    return _Open(name, attrs)


def spanned(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _Open(name, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost open span (nothing when none is
    recorded)."""
    if _stack and _stack[-1] is not None:
        _stack[-1].attrs.update(attrs)


class _Request:
    __slots__ = ("rid",)

    def __init__(self, rid):
        self.rid = rid

    def __enter__(self):
        _rid.append(self.rid)

    def __exit__(self, *exc):
        _rid.pop()
        return False


def request(rid):
    """A context manager under which every span opened carries ``rid``
    (the scheduler's request id): the spans of one request share it."""
    if not _profiling():
        return _OFF
    return _Request(rid)


def spans() -> list:
    """The log's records, in the order they were opened."""
    return list(_log)


def dropped() -> int:
    """Spans not kept because the log was full."""
    return _dropped


def clear() -> None:
    """Empty the log and the count of dropped spans."""
    global _dropped
    _log.clear()
    _dropped = 0


_counts = {"steps": 0, "admissions": 0, "admitted_prompt_tokens": 0,
           "page_claims": 0, "pages_claimed": 0, "host_syncs": 0,
           "readback_bytes": 0}


def count(name: str, n: int = 1) -> None:
    _counts[name] += n


def counters() -> dict:
    """{"serving": this module's counters, "launches": the kernels' calls,
    "collectives": the mesh's}, each as it reads now."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import utils as SH
    return {"serving": dict(_counts), "launches": dict(ops.launches),
            "collectives": SH.counters()}


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted and, while a profiler records, spanned."""
    n = t.numel() * t.element_size()
    _counts["host_syncs"] += 1
    _counts["readback_bytes"] += n
    with span("sync", bytes=n):
        return t.cpu()

"""The device trace of a stretch of the window, and its reductions.

``Stretch`` profiles a few seconds with ``torch.profiler`` (CPU and CUDA
activity), synchronising the card at both ends, and keeps the kernels,
copies and sets that ran on the card and the harness's own spans
(``bench.*`` ranges of ``record_function``). The reductions below are pure
functions of those lists, pinned by the CPU tests: the busy union (one
stream or several), a kernel's device time by name, the longest idle gaps
by the harness span the host was in, the top device operations.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "bench."

# kernel names, as the CUDA sources declare them (csrc/*.cuh): a call of
# ``paged_decode_attention`` is the paged decode body and, when split,
# the combine pass launched right after it
KERNELS = {
    "paged_decode_attention": re.compile(
        r"decode_tc_attention_kernel<\d+,\s*(true|1)>"),
    "decode_attention": re.compile(
        r"decode_tc_attention_kernel<\d+,\s*(false|0)>"),
    "flash_attention": re.compile(r"flash_tc_attention_kernel"),
}
COMBINE = re.compile(r"decode_combine_attention_kernel")
GEMM = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.IGNORECASE)


class Stretch:
    """One profiled stretch; ``start()`` and ``stop()`` between the
    engine's passes."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = 0.0           # host perf_counter

    def _sync(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def start(self) -> None:
        torch = self.torch
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def warm(self) -> None:
        """Profile one small operation: the profiler's first start, which
        loads and sets up the tracer (seconds on the card), then falls in
        the set-up and not in the window."""
        self.start()
        dev = "cuda" if self.torch.cuda.is_available() else "cpu"
        self.torch.ones(8, device=dev).sum().item()
        self.stop()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def events(self):
        """(kernels, spans): device operations (name, start s, duration s)
        sorted by start, and the harness's spans (name, start s, end s),
        on the trace's clock. The spans' mirrors on the device (kineto's
        GPU user annotations) are not operations."""
        kernels, spans = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            s, d = _ns(e, "start") * 1e-9, _ns(e, "duration") * 1e-9
            if str(e.device_type()).endswith("CUDA"):
                if not name.startswith(SPAN_PREFIX):
                    kernels.append((name, s, d))
            elif name.startswith(SPAN_PREFIX):
                spans.append((name, s, s + d))
        kernels.sort(key=lambda k: k[1])
        return kernels, spans


def _ns(event, what: str) -> int:
    """An event's start or duration in ns (``*_ns`` where the profiler
    has it, else ``*_us``)."""
    f = getattr(event, f"{what}_ns", None)
    return f() if f is not None else int(getattr(event, f"{what}_us")()
                                          * 1000)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def busy_intervals(kernels: Sequence[Tuple[str, float, float]]
                   ) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, merged and sorted: time in
    which anything ran on the card, however many streams overlap."""
    out: List[List[float]] = []
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(a, b) for a, b in out]


def busy_seconds(kernels) -> float:
    return sum(b - a for a, b in busy_intervals(kernels))


def kernel_seconds(kernels, kernel: str) -> Tuple[float, int]:
    """(device seconds, launches) of the program kernel ``kernel``
    (``KERNELS``); a combine pass counts with the body launched before
    it."""
    total, n, owner = 0.0, 0, None
    for name, _, d in kernels:
        if COMBINE.search(name):
            if owner == kernel:
                total += d
            continue
        owner = next((k for k, p in KERNELS.items() if p.search(name)), None)
        if owner == kernel:
            total += d
            n += 1
    return total, n


def gemm_seconds(kernels) -> float:
    return sum(d for name, _, d in kernels if GEMM.search(name))


def launches(kernels) -> int:
    """Kernels (not copies or sets) in the list."""
    return sum(1 for name, _, _ in kernels
               if not name.lower().startswith(("memcpy", "memset")))


def roofline_share(kernels, calls, kernel: str) -> Optional[float]:
    """The recorded calls' least time at the peaks over the kernel's
    device time, as a percentage; None when either side is empty."""
    least = sum(w.least_s() for k, w in calls if k == kernel)
    dev, n = kernel_seconds(kernels, kernel)
    if not n or dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev


def idle_gaps(kernels, spans, top: int = 10) -> List[List]:
    """The card's idle time between its first and last operation,
    attributed to the innermost
    harness span covering the middle of each gap ("outside the harness's
    spans" where none does), summed by span and sorted, longest first."""
    by: Dict[str, float] = {}
    busy = busy_intervals(kernels)
    edge = busy[0][0] if busy else 0.0
    for a, b in busy:
        if a > edge:
            mid = (edge + a) / 2
            inner = [s for s in spans if s[1] <= mid <= s[2]]
            name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "outside the harness's spans")
            by[name] = by.get(name, 0.0) + (a - edge)
        edge = max(edge, b)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]


def top_ops(kernels, top: int = 10) -> List[List]:
    """The device operations that took most time, by name."""
    by: Dict[str, float] = {}
    for name, _, d in kernels:
        by[name[:160]] = by.get(name[:160], 0.0) + d
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]

"""What a run hands the metric readers: host stamps of every request
and scheduler iteration, the counted FLOPs of each admission and step,
and, in a traced run, the device trace of a stretch of the window."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from bench.lib.counts import Work


@dataclass
class ReqRecord:
    """One request as its client saw it (host ``perf_counter`` seconds)."""
    due: float                       # open loop: its schedule; closed: sent
    prompt_len: int
    budget: int
    t_sent: float = 0.0              # when its client called submit
    iters: int = 0                   # decode iterations it was live
    t_first: Optional[float] = None  # first streamed token
    times: List[float] = field(default_factory=list)  # each token's arrival
    t_admit: float = 0.0             # the scheduler's admission stamp
    finished: bool = False           # ran to its budget
    error: Optional[str] = None      # its stream raised
    rid: int = -1
    prompt: object = None            # np.ndarray
    tokens: List[int] = field(default_factory=list)


@dataclass
class TraceData:
    """A profiled stretch: kernels (name, start s, duration s) in device
    order, the harness's spans (name, start s, end s), the recorded
    kernel calls (kernel, Work), its host length and iterations."""
    window_s: float
    iterations: int
    kernels: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    calls: List[Tuple[str, Work]]


@dataclass
class Record:
    setup_s: float
    window: Tuple[float, float]
    requests: List[ReqRecord]
    step_times: List[float]                 # each step's dispatch
    flops: List[Tuple[float, float]]        # (host time, FLOPs), bf16
    trace: Optional[TraceData] = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def iterations(self) -> int:
        w0, w1 = self.window
        return sum(1 for t in self.step_times if w0 <= t < w1)

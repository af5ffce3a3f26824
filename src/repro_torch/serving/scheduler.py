"""Continuous-batching scheduler over the engine's slots (PyTorch).

Counterpart of the JAX package's ``serving/scheduler.py`` (``Request`` and
``Scheduler.serve``, the virtual-clock loop), without what the port does
not carry yet: the prefix cache, swap-to-host, adaptive K, the wall-clock
streaming front end and ``LLMEngine``. Each request carries its own
decoding policy (``serving/sampling.SamplingParams``), so one batch mixes
greedy and sampled requests.

Request lifecycle::

    QUEUED --arrive--> (eligible) --admit--> DECODING --EOS / budget--> FINISHED
       ^                                        |
       +------ preempted (pages freed, tokens kept host-side) <---+

The engine's decode state is a fixed batch of B slots, every iteration
steps all B under a per-slot active mask. A finished request frees its slot
at once and the next eligible request is prefilled straight into the live
batch (``Engine.prefill_into_slot``). Rows are independent through
attention, caches and verification, so admitting into slot i never changes
what slot j emits.

The clock is virtual: every dispatched iteration advances it by
``iter_cost``, every admission prefill by ``prefill_cost``, and with
nothing live it jumps to the next arrival. No request is admitted before
its arrival; admission is FIFO by (arrival_time, submission order) with
head-of-line blocking. The clock is derived from step counts, so traces
replay bit-identically, and equal the JAX scheduler's on the same workload.

Under incremental page growth a slot claims pages as its length crosses
page boundaries, so the pool can run out mid-decode. Then the
lowest-priority running slot is preempted: its pages return to the pool,
its prompt and generated tokens stay on the host, and it is re-admitted
later by recompute-prefill of that prefix, which continues the stream token
for token: a greedy stream is a function of its prefix, and a sampled one
resumes with ``prefill_into_slot(resume=True)`` at the step boundary it
had, re-deriving the same per-position keys. A resume gates on its whole
remaining need, so the pressure that evicted it cannot evict it again at
once. With ``preempt=False`` slots stall instead.

Termination is host-driven: after every ``sync_every`` iterations one
readback brings the per-slot counters and committed tokens to the host;
streams are trimmed at the first ``eos_id`` or stop token of the request's
policy (inclusive) and at their budget (speculative commits overshoot it by
up to K).
"""
from __future__ import annotations

import bisect
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.engine import Engine
from repro_torch.serving.sampling import SamplingParams

QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
FINISHED = "finished"

_rid_counter = itertools.count()


@dataclass(eq=False)          # identity semantics: membership means THIS one
class Request:
    """One generation request. ``prompt`` is a 1-D token array; the prefill
    commits the first generated token, which counts toward the budget.
    ``sampling`` is its decoding policy (None: the engine's
    ``ecfg.sampling``). The budget is ``max_new_tokens``, else
    ``sampling.max_new_tokens``, else the engine's default.
    ``arrival_time`` is in virtual time units."""
    prompt: Any
    max_new_tokens: Optional[int] = None
    arrival_time: float = 0.0
    sampling: Optional[SamplingParams] = None
    rid: int = field(default_factory=lambda: next(_rid_counter))
    # lifecycle (managed by the scheduler)
    status: str = QUEUED
    slot: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    out_logprobs: List[float] = field(default_factory=list)
    # metrics
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_finish: float = 0.0
    vt_admit: Optional[float] = None   # virtual clock at first admission
    vt_finish: float = 0.0
    n_preempt: int = 0
    iters: int = 0                 # decode iterations this request was live
    # internal bookkeeping
    _prev_new: int = 0             # device-side new_count at the last sync
    _prev_last: int = 0            # device-side last position at the last sync
    _iters_base: int = 0           # iters accumulated before the last resume
    _committed: int = 0            # tokens committed across all admissions
    _prefills: int = 0             # prefill-committed tokens (1 + resumes)
    _seq: int = 0                  # submission index (FIFO tie-break)
    _scanned: int = 0              # out_tokens prefix already stop-scanned
    _stop_set: frozenset = frozenset()   # eos + stop ids, set at submission

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if not (self.arrival_time >= 0.0 and np.isfinite(self.arrival_time)):
            raise ValueError(f"bad arrival_time {self.arrival_time!r}")

    @property
    def acceptance_length(self) -> float:
        """Mean tokens committed per decode iteration, prefill-committed
        tokens excluded (the paper's AL, per request)."""
        return (self._committed - self._prefills) / max(self.iters, 1)


class Scheduler:
    """Continuous-batching loop over an Engine's B slots.

    ``eos_id``: the token that ends every request, beside each request's
    own stop tokens (its output is trimmed after the first); a finished
    slot is freed at once (paged: its pages return to the pool).
    ``sync_every``: iterations dispatched between host syncs; outputs are
    the same for any value. ``iter_cost`` / ``prefill_cost``: virtual-clock
    cost of one iteration / one admission prefill. ``preempt``: evict the
    lowest-priority running slot when the pool runs out (default), else
    stall slots."""

    def __init__(self, engine: Engine, eos_id: Optional[int] = None,
                 sync_every: int = 1,
                 iter_cost: float = 1.0, prefill_cost: float = 1.0,
                 preempt: Optional[bool] = None):
        self.engine = engine
        self.eos_id = eos_id
        self.sync_every = max(int(sync_every), 1)
        self.iter_cost = float(iter_cost)
        self.prefill_cost = float(prefill_cost)
        self.preempt = True if preempt is None else bool(preempt)

    def _prio(self, r: Request) -> Tuple[float, int]:
        return (r.arrival_time, r._seq)

    @staticmethod
    def _committed_stream(req: Request) -> np.ndarray:
        return np.concatenate([req.prompt,
                               np.asarray(req.out_tokens, np.int32)])

    def _start_serve(self) -> None:
        eng = self.engine
        B = eng.batch
        self._state = eng.blank_state()
        self._active = np.zeros((B,), bool)
        self._max_new = np.zeros((B,), np.int32)
        self._k_row = np.full((B,), eng.ecfg.K, np.int32)
        self._slot_req: List[Optional[Request]] = [None] * B
        self._waiting: List[Request] = []     # arrived, sorted by _prio
        self._finished: List[Request] = []
        self._events: List[Tuple[float, str, int]] = []
        self._clock = 0.0
        self._n_iters = 0
        self._n_preempt = 0
        self._next_seq = 0
        self._t_start = time.perf_counter()

    def _event(self, kind: str, rid: int, t: Optional[float] = None) -> None:
        """Append to the event trace, kept sorted by time: an arrival the
        idle clock already jumped past is inserted in place."""
        t = self._clock if t is None else t
        ev = (t, kind, rid)
        if self._events and t < self._events[-1][0]:
            bisect.insort(self._events, ev, key=lambda e: e[0])
        else:
            self._events.append(ev)

    def _prepare(self, r: Request, t_submit: float) -> None:
        """Validate and default-fill one request; raises before any state is
        touched."""
        eng = self.engine
        if r.status != QUEUED or r.out_tokens:
            raise ValueError(f"request {r.rid} is {r.status}; Request "
                             "objects are single-use")
        if r.sampling is None:
            r.sampling = eng.ecfg.sampling
        if r.max_new_tokens is None:
            r.max_new_tokens = (r.sampling.max_new_tokens
                                if r.sampling.max_new_tokens is not None
                                else eng.ecfg.max_new_tokens)
        # prompt + budget + the worst speculative overshoot must fit
        if r.prompt.size + r.max_new_tokens + eng.ecfg.K + 1 > eng.ecfg.max_len:
            raise ValueError(
                f"request {r.rid}: prompt {r.prompt.size} + max_new_tokens "
                f"{r.max_new_tokens} (+K overshoot) exceeds max_len "
                f"{eng.ecfg.max_len}")
        if eng.paged:
            n = eng.pages_needed(r.prompt.size, r.max_new_tokens)
            if n > eng.pool_pages:
                raise ValueError(f"request {r.rid}: needs {n} KV pages but "
                                 f"the pool only has {eng.pool_pages}")
        r.t_submit = t_submit
        r._seq = self._next_seq
        self._next_seq += 1
        stops = set(r.sampling.stop_token_ids)
        if self.eos_id is not None:
            stops.add(self.eos_id)
        r._stop_set = frozenset(stops)

    def _finish_slot(self, s: int) -> None:
        req = self._slot_req[s]
        req.status = FINISHED
        req.t_finish = time.perf_counter()
        req.vt_finish = self._clock
        self._active[s] = False
        self._slot_req[s] = None
        self._finished.append(req)
        self._event("finish", req.rid)
        self._state = self.engine.free_slot(self._state, s)

    def _preempt_slot(self, s: int) -> None:
        """Evict slot s: its pages return to the pool, the request is
        re-queued at its original priority with its tokens kept, to resume
        by recompute-prefill."""
        req = self._slot_req[s]
        req.status = QUEUED
        req.slot = None
        req.n_preempt += 1
        req._iters_base = req.iters
        self._n_preempt += 1
        self._active[s] = False
        self._slot_req[s] = None
        self._state = self.engine.free_slot(self._state, s)
        self._event("preempt", req.rid)
        bisect.insort(self._waiting, req, key=self._prio)

    def _lowest_prio_active(self) -> Optional[int]:
        live = [s for s in range(self.engine.batch) if self._active[s]]
        if not live:
            return None
        return max(live, key=lambda s: self._prio(self._slot_req[s]))

    @staticmethod
    def _resumes_sampled(req: Request) -> bool:
        """A sampled request re-admitted after a preemption resumes without
        a commit (``prefill_into_slot(resume=True)``)."""
        return bool(req.out_tokens) and not req.sampling.is_greedy

    def _head_admissible(self, req: Request) -> bool:
        # a resumed request gates on its whole remaining need; ``resume``
        # mirrors the admission's flag so the gate prices its exact claim
        return self.engine.can_admit(
            req.prompt.size + len(req.out_tokens),
            req.max_new_tokens - len(req.out_tokens), full=req.n_preempt > 0,
            resume=self._resumes_sampled(req))

    def _clip_and_check_done(self, req: Request) -> bool:
        """Trim at the first stop token (``eos_id`` or the request's
        ``stop_token_ids``, inclusive) and at the budget; True when the
        request is complete. Only tokens appended since the last call are
        scanned."""
        out = req.out_tokens
        done = False
        for i in range(req._scanned, len(out)):
            if out[i] in req._stop_set:
                del out[i + 1:]
                del req.out_logprobs[i + 1:]
                done = True
                break
        if len(out) >= req.max_new_tokens:
            del out[req.max_new_tokens:]          # speculative overshoot
            del req.out_logprobs[req.max_new_tokens:]
            done = True
        req._scanned = len(out)
        return done

    def _admit(self, req: Request, s: int) -> None:
        """Prefill ``req`` into slot s: its prompt, or on a resume the prompt
        and the tokens it generated before it was evicted (a sampled resume
        commits nothing new; the next step restarts its verification at the
        same committed prefix and key as the uninterrupted run)."""
        eng = self.engine
        prompt = (self._committed_stream(req) if req.out_tokens
                  else req.prompt)
        resume = self._resumes_sampled(req)
        remaining = req.max_new_tokens - len(req.out_tokens)
        req.status = PREFILLING
        req.slot = s
        first_admission = req.vt_admit is None
        if first_admission:
            req.vt_admit = self._clock
        self._event("admit", req.rid)
        self._state, first, last = eng.prefill_into_slot(
            self._state, prompt, s, max_new=remaining, sampling=req.sampling,
            resume=resume)
        if first_admission:
            req.t_admit = time.perf_counter()
        self._clock += self.prefill_cost
        if first is None:                  # no-commit resume (sampled)
            req._prev_new, req._prev_last = 0, last
        else:
            req.out_tokens.append(first)
            req.out_logprobs.append(eng.last_logprob)
            req._committed += 1
            req._prefills += 1
            req._prev_new, req._prev_last = 1, last
        req.status = DECODING
        self._slot_req[s] = req
        self._active[s] = True
        self._max_new[s] = remaining
        if self._clip_and_check_done(req):      # EOS at the first token
            self._finish_slot(s)

    def _admit_waiting(self) -> None:
        """Admit eligible requests into free slots, FIFO with head-of-line
        blocking; a head that outranks a runner preempts it for room."""
        B = self.engine.batch
        while self._waiting:
            free = [s for s in range(B) if not self._active[s]
                    and self._slot_req[s] is None]
            if not free:
                break
            head = self._waiting[0]
            if not self._head_admissible(head):
                if self.preempt:
                    while not self._head_admissible(head):
                        v = self._lowest_prio_active()
                        if v is None or (self._prio(self._slot_req[v])
                                         <= self._prio(head)):
                            break
                        self._preempt_slot(v)
                if not self._head_admissible(head):
                    break                # the head waits for frees (FIFO)
            self._admit(self._waiting.pop(0), free[0])

    def _grow(self) -> np.ndarray:
        """Grow each live slot to cover the coming sync block (incremental
        paging); when the pool runs out, preempt the lowest-priority slot,
        or stall without preemption. Returns the run mask."""
        eng = self.engine
        stalled = np.zeros((eng.batch,), bool)
        if eng.incremental:
            by_prio = sorted(np.flatnonzero(self._active),
                             key=lambda s: self._prio(self._slot_req[s]))
            for s in by_prio:
                if not self._active[s]:      # already evicted this pass
                    continue
                req = self._slot_req[s]
                cap = req.prompt.size + req.max_new_tokens + eng.ecfg.K + 1
                # a step at position c writes KV c..c+stride-1 and moves c by
                # at most stride, so sync_every steps need exactly
                # last + sync_every * stride positions
                target = min(req._prev_last + self.sync_every
                             * eng.commit_stride, cap)
                self._state, ok = eng.ensure_capacity(self._state, int(s),
                                                      target)
                while not ok and self.preempt:
                    v = self._lowest_prio_active()
                    self._preempt_slot(v)
                    if v == s:
                        break
                    self._state, ok = eng.ensure_capacity(self._state,
                                                          int(s), target)
                if not ok and self._active[s]:
                    stalled[s] = True        # retry once pages free up
        run = self._active & ~stalled
        if not run.any():
            raise RuntimeError("page pool exhausted and every live slot is "
                               "stalled; enable preemption or grow pool_pages")
        return run

    def _dispatch(self, run: np.ndarray) -> None:
        """``sync_every`` iterations over the live slots."""
        dev = self.engine.device
        act = torch.as_tensor(run, device=dev)
        max_new = torch.as_tensor(self._max_new, device=dev)
        k_row = torch.as_tensor(self._k_row, device=dev)
        for _ in range(self.sync_every):
            self._state = self.engine.step(self._state, act, max_new, k_row)
            self._n_iters += 1
            self._clock += self.iter_cost

    def _harvest(self) -> None:
        """One readback of the per-slot counters, tokens and logprobs; trim
        each stream and retire the finished slots."""
        st = self._state
        B = self.engine.batch
        packed = torch.cat([
            st["tokens"], st["logprobs"].view(torch.int32),
            torch.stack([st["new_count"], st["slot_iters"], st["last"]], 1),
        ], 1).cpu().numpy()
        W = st["tokens"].shape[1]
        tokens = packed[:, :W]
        logprobs = np.ascontiguousarray(packed[:, W:2 * W]).view(np.float32)
        new_count, slot_iters, last = packed[:, 2 * W:].T
        for s in range(B):
            req = self._slot_req[s]
            if req is None or not self._active[s]:
                continue
            req.iters = req._iters_base + int(slot_iters[s])
            if new_count[s] > req._prev_new:
                lo, hi = req._prev_last + 1, int(last[s]) + 1
                req.out_tokens.extend(tokens[s, lo:hi].tolist())
                req.out_logprobs.extend(logprobs[s, lo:hi].astype(float)
                                        .tolist())
                req._committed += int(new_count[s]) - req._prev_new
                req._prev_new = int(new_count[s])
                req._prev_last = int(last[s])
            if self._clip_and_check_done(req):
                self._finish_slot(s)

    def serve(self, requests: Sequence,
              max_iters: int = 100_000) -> Dict[str, Any]:
        """Run every request to completion; returns aggregate and
        per-request metrics (wall clock and virtual time). Entries may be
        Requests or raw prompts (the engine's budget, arrival 0)."""
        reqs = [r if isinstance(r, Request) else Request(r) for r in requests]
        self._start_serve()
        for r in reqs:
            self._prepare(r, self._t_start)
        pending = deque(sorted(reqs, key=self._prio))   # not yet arrived

        with torch.no_grad():
            while pending or self._waiting or self._active.any():
                while (pending and pending[0].arrival_time
                       <= self._clock + 1e-9):
                    r = pending.popleft()
                    bisect.insort(self._waiting, r, key=self._prio)
                    self._event("arrive", r.rid, t=r.arrival_time)
                if not self._waiting and not self._active.any():
                    self._clock = max(self._clock, pending[0].arrival_time)
                    continue
                self._admit_waiting()
                if not self._active.any():
                    if self._waiting:
                        raise RuntimeError(
                            "no active slot and the head request cannot be "
                            "admitted: page pool leak?")
                    continue                 # everything ended at prefill
                run = self._grow()
                self._dispatch(run)
                if self._n_iters > max_iters:
                    raise RuntimeError("scheduler exceeded max_iters")
                self._harvest()
        wall = time.perf_counter() - self._t_start
        return self._report(wall)

    def _report(self, wall: float) -> Dict[str, Any]:
        """``*_s``: host wall stamps, taken after a blocking readback (so
        they mark committed work); ``*_vt``: the virtual clock."""
        results = [{
            "rid": r.rid,
            "tokens": np.asarray(r.out_tokens, np.int32),
            "logprobs": np.asarray(r.out_logprobs, np.float32),
            "n_new": len(r.out_tokens),
            "iters": r.iters,
            "acceptance_length": r.acceptance_length,
            "arrival_time": r.arrival_time,
            "n_preempt": r.n_preempt,
            "wait_s": r.t_admit - r.t_submit,
            "latency_s": r.t_finish - r.t_submit,
            "wait_vt": r.vt_admit - r.arrival_time,
            "latency_vt": r.vt_finish - r.arrival_time,
        } for r in sorted(self._finished, key=lambda r: r.rid)]
        total = sum(r["n_new"] for r in results)
        lat_vt = [r["latency_vt"] for r in results] or [0.0]
        wait_vt = [r["wait_vt"] for r in results] or [0.0]
        dec_tok = sum(r._committed - r._prefills for r in self._finished)
        dec_it = sum(r.iters for r in self._finished)
        return {
            "results": results,
            "n_requests": len(results),
            "iterations": self._n_iters,
            "total_new_tokens": total,
            "wall_s": wall,
            "otps": total / max(wall, 1e-9),
            "mean_acceptance_length": float(np.mean(
                [r["acceptance_length"] for r in results])) if results else 0.0,
            # decode-committed tokens over decode iterations: a 1-iteration
            # straggler does not weigh as much as a long stream
            "weighted_acceptance_length": dec_tok / max(dec_it, 1),
            "makespan_vt": self._clock,
            "otps_vt": total / max(self._clock, 1e-9),
            "preemptions": self._n_preempt,
            "peak_pages": (self.engine.allocator.peak_used
                           if self.engine.paged else 0),
            "p50_latency_vt": float(np.percentile(lat_vt, 50)),
            "p99_latency_vt": float(np.percentile(lat_vt, 99)),
            "p50_wait_vt": float(np.percentile(wait_vt, 50)),
            "p99_wait_vt": float(np.percentile(wait_vt, 99)),
            "events": self._events,
        }

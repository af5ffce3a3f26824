"""Continuous-batching scheduler over the engine's slots (PyTorch).

Counterpart of the JAX package's ``serving/scheduler.py``: ``Request``, the
``Scheduler`` with the prefix cache's admission, swap-to-host preemption and
the adaptive-K controller, the ``LLMEngine`` front end and the round-based
baseline ``serve_round_based``. Each request carries its own decoding policy
(``serving/sampling.SamplingParams``), so one batch mixes greedy and
sampled requests.

Request lifecycle::

    QUEUED --arrive--> (eligible) --admit--> DECODING --EOS / budget--> FINISHED
       ^                                        |
       +------ preempted (pages freed, tokens kept host-side) <---+

    (any state before FINISHED) --abort--> ABORTED   [streaming driver:
    pages freed at once, the output so far kept host-side]

The loop core (admit -> grow -> dispatch -> harvest) is a set of Scheduler
methods shared by two drivers: the virtual-clock ``serve()`` below and the
wall-clock ``serving/streaming.AsyncEngine``, which streams each request's
final tokens as its syncs commit. They differ only in who advances the
clock (``_advance``) and who reads the emit buffer (``_flush``).

The engine's decode state is a fixed batch of B slots, every iteration
steps all B under a per-slot active mask. A finished request frees its slot
at once and the next eligible request is prefilled straight into the live
batch (``Engine.prefill_into_slot``). Rows are independent through
attention, caches and verification, so admitting into slot i never changes
what slot j emits.

Under ``serve()`` the clock is virtual: every dispatched iteration advances
it by ``iter_cost``, every admission prefill by ``prefill_cost``, and with
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
once. With ``preempt=False`` slots stall instead. With
``EngineConfig(swap="host")`` an eviction parks the victim's pages and rows
in the engine's host pool instead, and the resume is a bitwise restore
(``Engine.swap_in_slot``); the scheduler falls back to recompute when the
host pool is full or the bytes-moved cost model says recompute is cheaper.
With a prefix cache a freed slot's committed stream is indexed, and an
admission gates on its need after the hit.

Under a storage-sharded engine (``EngineConfig(shard_model=True)``) every
rank of the mesh runs this same host scheduler on the virtual clock over
the same requests: admissions, page growth, preemptions, swaps, the prefix
cache and the adaptive-K controller decide from replicated tokens and
counters only, so every rank makes the same engine calls in the same
order and their gathers match. Under the wall-clock ``AsyncEngine`` what
enters from outside (submissions, with their rid, arrival and
``t_submit``; aborts; the clock) is rank 0's alone: it broadcasts a record
of it before each pass, and the other ranks apply the record
(``_submit``, ``_abort``, ``_advance(now=)``) and then run the same core,
which decides from the same replicated state.

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
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng, tracing
from repro_torch.models.registry import make_extras, takes_extras
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.speculation import (SpeculationConfig,
                                             SpeculationController)

QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
FINISHED = "finished"
ABORTED = "aborted"

_rid_counter = itertools.count()


@dataclass(eq=False)          # identity semantics: membership means THIS one
class Request:
    """One generation request. ``prompt`` is a 1-D token array; the prefill
    commits the first generated token, which counts toward the budget.
    ``sampling`` is its decoding policy (None: the engine's
    ``ecfg.sampling``). The budget is ``max_new_tokens``, else
    ``sampling.max_new_tokens``, else the engine's default.
    ``arrival_time`` is in virtual time units (wall seconds since the
    session opened, under ``AsyncEngine``). ``extras`` carries the
    request's modality inputs (vision or encoder embeds, leading batch axis
    1, as ``models.registry.make_extras(cfg, 1, "prefill", key)`` builds
    them); a VLM or encoder-decoder request without them gets a
    deterministic stub keyed by its prompt at its first admission."""
    prompt: Any
    max_new_tokens: Optional[int] = None
    arrival_time: float = 0.0
    extras: Optional[dict] = None
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
    n_swap: int = 0                # preemptions that swapped to the host
    iters: int = 0                 # decode iterations this request was live
    cached_tokens: int = 0         # prompt positions served from the prefix
    #                                cache over all its admissions
    # internal bookkeeping
    _prev_new: int = 0             # device-side new_count at the last sync
    _prev_last: int = 0            # device-side last position at the last sync
    _iters_base: int = 0           # iters accumulated before the last resume
    _committed: int = 0            # tokens committed across all admissions
    _prefills: int = 0             # prefill-committed tokens (1 + resumes)
    _seq: int = 0                  # submission index (FIFO tie-break)
    _scanned: int = 0              # out_tokens prefix already stop-scanned
    _emitted: int = 0              # out_tokens prefix already streamed out
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
    own stop tokens (its output is trimmed after the first).
    ``free_on_finish``: blank a finished slot's rows at once (a paged
    engine always frees, its pages return to the pool; an admission
    overwrites a slot either way).
    ``sync_every``: iterations dispatched between host syncs; outputs are
    the same for any value. ``iter_cost`` / ``prefill_cost``: virtual-clock
    cost of one iteration / one admission prefill. ``preempt``: evict the
    lowest-priority running slot when the pool runs out (default), else
    stall slots.

    ``swap`` (default: the engine's ``EngineConfig.swap``): evict to the
    host pool when ``2 * bytes * swap_cost_per_byte <= prefill_cost +
    prefill_cost_per_token * prefix_tokens`` and the pool can hold the
    snapshot, else recompute; swap-out and swap-in advance the clock by
    ``swap_cost_per_byte`` times the bytes moved, an admission prefill by
    ``prefill_cost + prefill_cost_per_token * prompt``. Both costs default
    to 0.

    ``adaptive_k``: True (default knobs) or a ``SpeculationConfig`` turns
    on the per-request ``SpeculationController``: each request's
    acceptance EMA, keyed by rid and kept across preemption, sets its
    ``k_row`` at admission and at every harvest, and incremental growth
    reserves the row's ``k_row + 1`` stride instead of ``K + 1``. Greedy
    streams are unchanged; a sampled one stays a function of its own
    stream. None / False keeps the fixed K."""

    def __init__(self, engine: Engine, eos_id: Optional[int] = None,
                 free_on_finish: bool = True, sync_every: int = 1,
                 iter_cost: float = 1.0, prefill_cost: float = 1.0,
                 preempt: Optional[bool] = None, adaptive_k: Any = None,
                 swap: Optional[bool] = None,
                 swap_cost_per_byte: float = 0.0,
                 prefill_cost_per_token: float = 0.0):
        self.engine = engine
        self.eos_id = eos_id
        self.free_on_finish = free_on_finish
        self.sync_every = max(int(sync_every), 1)
        self.iter_cost = float(iter_cost)
        self.prefill_cost = float(prefill_cost)
        self.preempt = True if preempt is None else bool(preempt)
        self.swap = engine.swap_enabled if swap is None else bool(swap)
        if self.swap and not engine.swap_enabled:
            raise ValueError(
                "Scheduler(swap=True) needs EngineConfig(swap='host')")
        self.swap_cost_per_byte = float(swap_cost_per_byte)
        self.prefill_cost_per_token = float(prefill_cost_per_token)
        if adaptive_k is None or adaptive_k is False:
            self.spec: Optional[SpeculationController] = None
        elif isinstance(adaptive_k, SpeculationController):
            self.spec = adaptive_k
        else:
            self.spec = SpeculationController(
                engine.ecfg.K, adaptive_k
                if isinstance(adaptive_k, SpeculationConfig) else None)
        # one session at a time, opened by _begin_session: serve()'s, or a
        # streaming.AsyncEngine's
        self._wall_t0: Optional[float] = None

    # ------------------------------------------------------------------
    # the loop core both drivers call; session state lives on the instance
    # from _begin_session to _end_session
    # ------------------------------------------------------------------
    def _prio(self, r: Request) -> Tuple[float, int]:
        return (r.arrival_time, r._seq)

    @staticmethod
    def _committed_stream(req: Request) -> np.ndarray:
        return np.concatenate([req.prompt,
                               np.asarray(req.out_tokens, np.int32)])

    def _begin_session(self) -> None:
        eng = self.engine
        B = eng.batch
        # a prefix-cache engine starts from the last session's pools
        self._state = eng.serve_state()
        self._active = np.zeros((B,), bool)
        self._max_new = np.zeros((B,), np.int32)
        self._k_row = np.full((B,), eng.ecfg.K, np.int32)
        self._slot_req: List[Optional[Request]] = [None] * B
        self._waiting: List[Request] = []     # arrived, sorted by _prio
        self._finished: List[Request] = []    # finished and aborted
        self._events: List[Tuple[float, str, int]] = []
        self._emit: List[Tuple[Request, List[int], List[float]]] = []
        self._unreleased: List[int] = []      # aborted slots, rows not reset
        self._clock = 0.0
        self._n_iters = 0
        self._n_preempt = 0
        self._n_swap = 0             # swap-to-host evictions
        self._n_recompute = 0        # recompute-prefill evictions
        self._n_swap_drop = 0        # handles dropped for pressure relief
        self._recomputed_tokens = 0  # prefix tokens re-fed by resumes,
        #                              net of prefix-cache hits
        self._next_seq = 0
        self._wall_t0 = None         # None: the virtual clock
        self._given_clock: Optional[float] = None
        self._t_start = time.perf_counter()

    def _advance(self, cost: float, now: Optional[float] = None) -> None:
        """Move the session clock past one piece of work: the virtual clock
        adds its cost, the wall clock reads the time since the session
        opened. ``now`` gives the wall clock's reading instead (a follower
        rank of ``AsyncEngine`` takes rank 0's), which then holds until the
        next reading is given."""
        if now is not None:
            self._given_clock = float(now)
        if self._wall_t0 is None:
            self._clock += cost
        elif self._given_clock is not None:
            self._clock = self._given_clock
        else:
            self._clock = time.perf_counter() - self._wall_t0

    def _event(self, kind: str, rid: int, t: Optional[float] = None) -> None:
        """Append to the event trace, kept sorted by time: an arrival the
        idle clock already jumped past is inserted in place."""
        t = self._clock if t is None else t
        ev = (t, kind, rid)
        if self._events and t < self._events[-1][0]:
            bisect.insort(self._events, ev, key=lambda e: e[0])
        else:
            self._events.append(ev)

    def _prepare(self, r: Request, t_submit: Optional[float] = None) -> None:
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
        # prompt (after a VLM target's vision tokens) + budget + the worst
        # speculative overshoot must fit
        if (r.prompt.size + eng.pos_offset + r.max_new_tokens + eng.ecfg.K
                + 1 > eng.ecfg.max_len):
            raise ValueError(
                f"request {r.rid}: prompt {r.prompt.size} + max_new_tokens "
                f"{r.max_new_tokens} (+K overshoot) exceeds max_len "
                f"{eng.ecfg.max_len}")
        if eng.paged:
            n = eng.pages_needed(r.prompt.size, r.max_new_tokens)
            if n > eng.pool_pages:
                raise ValueError(f"request {r.rid}: needs {n} KV pages but "
                                 f"the pool only has {eng.pool_pages}")
        r.t_submit = time.perf_counter() if t_submit is None else t_submit
        r._seq = self._next_seq
        self._next_seq += 1
        stops = set(r.sampling.stop_token_ids)
        if self.eos_id is not None:
            stops.add(self.eos_id)
        r._stop_set = frozenset(stops)

    def _submit(self, r: Request, t_submit: Optional[float] = None) -> None:
        """A wall-clock arrival: validate (``_prepare``; raises before any
        state is touched), queue at its priority and log it at the current
        clock. ``t_submit``: rank 0's stamp, on a follower rank."""
        self._prepare(r, t_submit)
        bisect.insort(self._waiting, r, key=self._prio)
        self._event("arrive", r.rid)

    def _flush(self, req: Request) -> None:
        """Queue the request's newly final tokens (those the stop / budget
        scan passed, which no later sync trims) for the streaming driver;
        ``serve()`` discards the buffer every pass."""
        if len(req.out_tokens) > req._emitted:
            self._emit.append((req, req.out_tokens[req._emitted:],
                               req.out_logprobs[req._emitted:]))
            req._emitted = len(req.out_tokens)

    def _finish_slot(self, s: int) -> None:
        req = self._slot_req[s]
        req.status = FINISHED
        # both callers come after a blocking readback of the request's
        # committed tokens, so the stamp marks work the device finished
        req.t_finish = time.perf_counter()
        req.vt_finish = self._clock
        self._active[s] = False
        self._slot_req[s] = None
        self._finished.append(req)
        if self.spec is not None:
            self.spec.finish(req.rid)
        self._event("finish", req.rid)
        if self.free_on_finish or self.engine.paged:
            self._state = self.engine.free_slot(
                self._state, s, final_tokens=self._committed_stream(req))

    def _abort(self, req: Request) -> bool:
        """Cancel a request now: a queued one leaves the wait queue, a
        running one's pages return to the pool at once (its slot's device
        rows are reset before the next admission or step,
        ``_release_aborted``), a swapped-out one's host snapshot is
        dropped. Tokens harvested so far stay. False when the request had
        already ended. Only the streaming driver cancels."""
        if req.status in (FINISHED, ABORTED):
            return False
        if req.slot is not None:
            s = req.slot
            self._active[s] = False
            self._slot_req[s] = None
            self.engine.free_pages(s, final_tokens=self._committed_stream(req))
            self._unreleased.append(s)
        elif req in self._waiting:
            self._waiting.remove(req)
        # a swapped-out request holds host bytes and resident page
        # references while it waits
        self.engine.drop_swap(req.rid)
        req.status = ABORTED
        req.slot = None
        req.t_finish = time.perf_counter()
        req.vt_finish = self._clock
        self._finished.append(req)
        if self.spec is not None:
            self.spec.finish(req.rid)
        self._event("abort", req.rid)
        return True

    def _release_aborted(self) -> None:
        """Reset the device rows of slots freed by ``_abort``: the dispatch
        pass runs it, so a client's abort touches host state only."""
        while self._unreleased:
            self._state = self.engine.release_slot(self._state,
                                                   self._unreleased.pop())

    def _swap_beats_recompute(self, req: Request, s: int) -> bool:
        """Swap when moving the snapshot's bytes both ways costs no more
        than re-feeding the committed prefix, and the host pool can hold
        it. With the default zero byte cost, swap wins while it fits."""
        eng = self.engine
        if not self.swap:
            return False
        est = eng.swap_bytes_estimate(s)
        if not eng.host_pool.can_store(est):
            return False            # host pool full: recompute instead
        prefix = req.prompt.size + len(req.out_tokens)
        return (2.0 * est * self.swap_cost_per_byte
                <= self.prefill_cost + self.prefill_cost_per_token * prefix)

    def _preempt_slot(self, s: int) -> None:
        """Evict slot s, re-queueing the request at its original priority:
        to the host pool (resume: a bitwise restore) when swap is on and
        worth it, else by freeing its pages and keeping its tokens on the
        host (resume: recompute-prefill). Both are lossless."""
        eng = self.engine
        req = self._slot_req[s]
        swapped = False
        if self._swap_beats_recompute(req, s):
            with tracing.request(req.rid):
                self._state, swapped = eng.swap_out_slot(self._state, s,
                                                         req.rid)
        req.status = QUEUED
        req.slot = None
        req.n_preempt += 1
        req._iters_base = req.iters
        self._n_preempt += 1
        self._active[s] = False
        self._slot_req[s] = None
        if swapped:
            req.n_swap += 1
            self._n_swap += 1
            self._advance(self.swap_cost_per_byte * eng.swap_last_bytes)
            self._event("swap_out", req.rid)
        else:
            self._n_recompute += 1
            self._state = eng.free_slot(
                self._state, s, final_tokens=self._committed_stream(req))
            self._event("preempt", req.rid)
        bisect.insort(self._waiting, req, key=self._prio)

    def _drop_one_swap(self, exclude: Optional[Request] = None) -> bool:
        """Pressure relief of last resort: a swap handle pins its resident
        (cache-shared) pages, which a recompute eviction would have left
        evictable, so a pool wedged behind swapped prefixes drops the
        lowest-priority handle (that request resumes by recompute) instead
        of deadlocking. False when nothing is droppable."""
        eng = self.engine
        cands = [r for r in self._waiting
                 if r is not exclude and eng.has_swap(r.rid)]
        if not cands:
            return False
        victim = max(cands, key=self._prio)
        eng.drop_swap(victim.rid)
        self._n_swap_drop += 1
        self._event("swap_drop", victim.rid)
        return True

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

    def _admission_stream(self, req: Request) -> np.ndarray:
        """The tokens an admission prefills: the prompt, or on a resume the
        committed stream (less its last token for a sampled resume)."""
        if not req.out_tokens:
            return req.prompt
        stream = self._committed_stream(req)
        return stream[:-1] if self._resumes_sampled(req) else stream

    def _head_admissible(self, req: Request) -> bool:
        # a resumed request gates on its whole remaining need; ``resume``
        # mirrors the admission's flag so the gate prices its exact claim,
        # and the prefilled tokens price the need after a prefix-cache hit
        eng = self.engine
        plen = req.prompt.size + len(req.out_tokens)
        rem = req.max_new_tokens - len(req.out_tokens)
        if eng.has_swap(req.rid):
            # a swapped resume needs device pages for its host spans only
            return eng.can_swap_in(req.rid, plen, rem, full=req.n_preempt > 0)
        return eng.can_admit(plen, rem, full=req.n_preempt > 0,
                             tokens=self._admission_stream(req),
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

    def _swap_admit(self, req: Request, s: int) -> None:
        """Resume a swapped-out request: its snapshot is written back into
        slot s, bitwise its eviction-time step boundary (no prefill); the
        committed counters restart at 0 against the remaining budget, as
        in ``_admit``."""
        eng = self.engine
        req.status = PREFILLING
        req.slot = s
        self._state, last = eng.swap_in_slot(self._state, s, req.rid)
        self._advance(self.swap_cost_per_byte * eng.swap_last_bytes)
        self._event("swap_in", req.rid)
        req._prev_new, req._prev_last = 0, last
        req.status = DECODING
        self._slot_req[s] = req
        self._active[s] = True
        self._max_new[s] = req.max_new_tokens - len(req.out_tokens)
        if self.spec is not None:
            self._k_row[s] = self.spec.k_for(req.rid)

    def _admit(self, req: Request, s: int) -> None:
        """Prefill ``req`` into slot s: its prompt, or on a resume the prompt
        and the tokens it generated before it was evicted (a sampled resume
        commits nothing new; the next step restarts its verification at the
        same committed prefix and key as the uninterrupted run). A swapped
        request is restored instead."""
        eng = self.engine
        if eng.has_swap(req.rid):
            self._swap_admit(req, s)
            return
        prompt = (self._committed_stream(req) if req.out_tokens
                  else req.prompt)
        resume = self._resumes_sampled(req)
        remaining = req.max_new_tokens - len(req.out_tokens)
        req.status = PREFILLING
        req.slot = s
        first_admission = req.vt_admit is None
        if first_admission:
            req.vt_admit = self._clock
        if req.extras is None and takes_extras(eng.tcfg):
            # deterministic stub frontend inputs keyed by the prompt (not
            # the rid), so re-serving a workload with fresh Requests replays
            # them; kept on the request, so a preemption's resume (a longer
            # prompt) replays them too
            seed = zlib.crc32(req.prompt.tobytes()) & 0x7FFFFFFF
            req.extras = make_extras(
                eng.tcfg, 1, "prefill",
                prng.fold_in(prng.PRNGKey(0, device=eng.device), seed))
        self._event("admit", req.rid)
        with tracing.request(req.rid):
            self._state, first, last = eng.prefill_into_slot(
                self._state, prompt, s, max_new=remaining,
                sampling=req.sampling, resume=resume, extras=req.extras)
        if first_admission:
            # after the prefill's readback of its last position, so the
            # stamp marks a committed admission, not a queued launch
            req.t_admit = time.perf_counter()
        req.cached_tokens += eng.last_hit_tokens
        if req.n_preempt:
            # prefix positions this resume forwarded again (net of hits)
            self._recomputed_tokens += max(
                int(prompt.size) - eng.last_hit_tokens, 0)
        self._advance(self.prefill_cost
                      + self.prefill_cost_per_token * int(prompt.size))
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
        if self.spec is not None:
            # rid-keyed: a resume continues from the state the stream had
            self._k_row[s] = self.spec.k_for(req.rid)
        done = self._clip_and_check_done(req)
        self._flush(req)
        if done:                             # EOS at the first token
            self._finish_slot(s)

    @tracing.spanned("sched.admit_waiting")
    def _admit_waiting(self) -> None:
        """Admit eligible requests into free slots, FIFO with head-of-line
        blocking; a head that outranks a runner preempts it for room."""
        self._release_aborted()
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
                # swap handles pin resident pages a recompute eviction
                # would release: drop lower-priority ones until the head
                # fits (dropping its own never helps)
                while (not self._head_admissible(head)
                       and self._drop_one_swap(exclude=head)):
                    pass
                if not self._head_admissible(head):
                    break                # the head waits for frees (FIFO)
            self._admit(self._waiting.pop(0), free[0])

    @tracing.spanned("sched.grow")
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
                cap = (req.prompt.size + eng.pos_offset + req.max_new_tokens
                       + eng.ecfg.K + 1)
                # a step at position c writes KV c..c+stride-1 and moves c by
                # at most stride, so sync_every steps need exactly
                # last + sync_every * stride positions; under adaptive K the
                # row's stride is k_row + 1 (a write past the row's pages
                # goes to the sink, like an invalidated entry)
                if self.spec is not None and eng.ecfg.drafter_mode != "none":
                    stride = int(self._k_row[s]) + 1
                else:
                    stride = eng.commit_stride
                target = min(req._prev_last + self.sync_every * stride, cap)
                self._state, ok = eng.ensure_capacity(self._state, int(s),
                                                      target)
                while not ok and self.preempt:
                    v = self._lowest_prio_active()
                    self._preempt_slot(v)
                    if v == s:
                        break
                    self._state, ok = eng.ensure_capacity(self._state,
                                                          int(s), target)
                while not ok and self._active[s] and self._drop_one_swap():
                    # growth wedged behind handle-pinned pages
                    self._state, ok = eng.ensure_capacity(self._state,
                                                          int(s), target)
                if not ok and self._active[s]:
                    stalled[s] = True        # retry once pages free up
        run = self._active & ~stalled
        if not run.any():
            raise RuntimeError("page pool exhausted and every live slot is "
                               "stalled; enable preemption or grow pool_pages")
        return run

    @tracing.spanned("sched.dispatch")
    def _dispatch(self, run: np.ndarray) -> None:
        """``sync_every`` iterations over the live slots."""
        dev = self.engine.device
        act = torch.as_tensor(run, device=dev)
        max_new = torch.as_tensor(self._max_new, device=dev)
        k_row = torch.as_tensor(self._k_row, device=dev)
        for _ in range(self.sync_every):
            self._state = self.engine.step(self._state, act, max_new, k_row)
            self._n_iters += 1
            self._advance(self.iter_cost)

    @tracing.spanned("sched.harvest")
    def _harvest(self) -> None:
        """One readback of the per-slot counters, tokens and logprobs (it
        blocks on every dispatched step, so later wall stamps mark committed
        work); trim each stream, flush its final tokens to the emit buffer
        and retire the finished slots."""
        st = self._state
        B = self.engine.batch
        packed = torch.cat([
            st["tokens"], st["logprobs"].view(torch.int32),
            torch.stack([st["new_count"], st["slot_iters"], st["last"]], 1),
        ], 1)
        packed = tracing.to_host(packed).numpy()
        W = st["tokens"].shape[1]
        tokens = packed[:, :W]
        logprobs = np.ascontiguousarray(packed[:, W:2 * W]).view(np.float32)
        new_count, slot_iters, last = packed[:, 2 * W:].T
        for s in range(B):
            req = self._slot_req[s]
            if req is None or not self._active[s]:
                continue
            prev_iters, prev_comm = req.iters, req._committed
            req.iters = req._iters_base + int(slot_iters[s])
            if new_count[s] > req._prev_new:
                lo, hi = req._prev_last + 1, int(last[s]) + 1
                req.out_tokens.extend(tokens[s, lo:hi].tolist())
                req.out_logprobs.extend(logprobs[s, lo:hi].astype(float)
                                        .tolist())
                req._committed += int(new_count[s]) - req._prev_new
                req._prev_new = int(new_count[s])
                req._prev_last = int(last[s])
            if self.spec is not None and req.iters > prev_iters:
                # this request's committed tokens over its iterations since
                # the last sync; frozen rows carry no signal
                self.spec.observe(req.rid, req._committed - prev_comm,
                                  req.iters - prev_iters)
                self._k_row[s] = self.spec.k_for(req.rid)
            done = self._clip_and_check_done(req)
            self._flush(req)
            if done:
                self._finish_slot(s)

    def _end_session(self, wall: float) -> Dict[str, Any]:
        self._release_aborted()
        self.engine.retain_state(self._state)   # keep cached pages warm
        return self._report(wall)

    def serve(self, requests: Sequence,
              max_iters: int = 100_000) -> Dict[str, Any]:
        """Run every request to completion; returns aggregate and
        per-request metrics (wall clock and virtual time). Entries may be
        Requests or raw prompts (the engine's budget, arrival 0). The
        virtual-clock driver of the loop core; ``streaming.AsyncEngine``
        is its wall-clock twin, with the same streams."""
        reqs = [r if isinstance(r, Request) else Request(r) for r in requests]
        self._begin_session()
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
                self._emit.clear()           # nobody streams here
            return self._end_session(time.perf_counter() - self._t_start)

    def _report(self, wall: float) -> Dict[str, Any]:
        """``*_s``: host wall stamps, taken after a blocking readback (so
        they mark committed work); ``*_vt``: the session clock, virtual
        under ``serve()``, wall seconds under the streaming driver.
        Aborted requests are in ``results`` with ``aborted`` true and their
        partial output; latency and AL aggregates cover the completed ones,
        token totals both."""
        results = [{
            "rid": r.rid,
            "tokens": np.asarray(r.out_tokens, np.int32),
            "logprobs": np.asarray(r.out_logprobs, np.float32),
            "n_new": len(r.out_tokens),
            "iters": r.iters,
            "acceptance_length": r.acceptance_length,
            "arrival_time": r.arrival_time,
            "n_preempt": r.n_preempt,
            "n_swap": r.n_swap,
            "cached_tokens": r.cached_tokens,
            "aborted": r.status == ABORTED,
            "wait_s": r.t_admit - r.t_submit,
            "latency_s": r.t_finish - r.t_submit,
            "wait_vt": (r.vt_admit - r.arrival_time
                        if r.vt_admit is not None else float("nan")),
            "latency_vt": r.vt_finish - r.arrival_time,
            **({"k_final": self.spec.request_report(r.rid)["k_final"]}
               if self.spec is not None else {}),
        } for r in sorted(self._finished, key=lambda r: r.rid)]
        total = sum(r["n_new"] for r in results)
        done = [r for r in results if not r["aborted"]]
        lat_vt = [r["latency_vt"] for r in done] or [0.0]
        wait_vt = [r["wait_vt"] for r in done] or [0.0]
        done_reqs = [r for r in self._finished if r.status == FINISHED]
        dec_tok = sum(r._committed - r._prefills for r in done_reqs)
        dec_it = sum(r.iters for r in done_reqs)
        hp = self.engine.host_pool            # None unless swap="host"
        return {
            "results": results,
            "n_requests": len(results),
            "iterations": self._n_iters,
            "total_new_tokens": total,
            "wall_s": wall,
            "otps": total / max(wall, 1e-9),
            "mean_acceptance_length": float(np.mean(
                [r["acceptance_length"] for r in done])) if done else 0.0,
            # decode-committed tokens over decode iterations: a 1-iteration
            # straggler does not weigh as much as a long stream
            "weighted_acceptance_length": dec_tok / max(dec_it, 1),
            **({"speculation": self.spec.report()}
               if self.spec is not None else {}),
            "mean_latency_s": float(np.mean(
                [r["latency_s"] for r in done])) if done else 0.0,
            "makespan_vt": self._clock,
            "otps_vt": total / max(self._clock, 1e-9),
            "preemptions": self._n_preempt,
            # every eviction is one of swap or recompute; swap_drops counts
            # handles later demoted to recompute
            "preempt_swap": self._n_swap,
            "preempt_recompute": self._n_recompute,
            "swap_drops": self._n_swap_drop,
            "recomputed_prefill_tokens": self._recomputed_tokens,
            "host_pool": {
                "capacity_bytes": hp.capacity if hp is not None else 0,
                "used_bytes": hp.used_bytes if hp is not None else 0,
                "peak_bytes": hp.peak_used if hp is not None else 0,
            },
            "peak_pages": (self.engine.allocator.peak_used
                           if self.engine.paged else 0),
            "aborted": len(results) - len(done),
            "cache_hit_tokens": sum(r["cached_tokens"] for r in results),
            "cache_hit_requests": sum(1 for r in results
                                      if r["cached_tokens"] > 0),
            "p50_latency_vt": float(np.percentile(lat_vt, 50)),
            "p99_latency_vt": float(np.percentile(lat_vt, 99)),
            "p50_wait_vt": float(np.percentile(wait_vt, 50)),
            "p99_wait_vt": float(np.percentile(wait_vt, 99)),
            "events": self._events,
        }


class LLMEngine:
    """Offline batch generation over Engine + Scheduler, one
    :class:`SamplingParams` per prompt (vLLM's ``LLM.generate``).

        llm = LLMEngine(engine, eos_id=2)
        outs = llm.generate(prompts, SamplingParams(temperature=0.8, seed=7))
        outs[0]["tokens"]            # int32 generated ids, stop-trimmed

    ``generate`` takes one policy for every prompt or a list with one per
    prompt (None: the engine's default), so one batch mixes greedy and
    sampled requests. Results come in prompt order; the scheduler's whole
    report of the last call is ``last_report``."""

    def __init__(self, engine: Engine, eos_id: Optional[int] = None,
                 **scheduler_kwargs):
        self.engine = engine
        self.scheduler = Scheduler(engine, eos_id=eos_id, **scheduler_kwargs)
        self.last_report: Optional[Dict[str, Any]] = None

    def generate(self, prompts: Sequence,
                 sampling_params=None) -> List[Dict[str, Any]]:
        """One result dict per prompt (``tokens``, ``n_new``,
        ``acceptance_length``, ...), in prompt order."""
        n = len(prompts)
        if sampling_params is None or isinstance(sampling_params,
                                                 SamplingParams):
            sampling_params = [sampling_params] * n
        if len(sampling_params) != n:
            raise ValueError(
                f"{len(sampling_params)} sampling_params for {n} prompts")
        reqs = [Request(p, sampling=sp)
                for p, sp in zip(prompts, sampling_params)]
        order = {r.rid: i for i, r in enumerate(reqs)}
        self.last_report = self.scheduler.serve(reqs)
        return sorted(self.last_report["results"],
                      key=lambda res: order[res["rid"]])


def serve_round_based(engine: Engine, prompts: Sequence,
                      budgets: Optional[Sequence[int]] = None,
                      batch: Optional[int] = None) -> Dict[str, Any]:
    """The baseline continuous batching is measured against: fixed batches
    of ``batch`` (the engine's) equal-length prompts, the queue refilled
    only between whole rounds, so a finished row idles until the round's
    longest one ends. Each row freezes on the device at its own budget
    (``budgets``, default the engine's). A short last round is padded with
    copies of its last prompt at budget 0. A contiguous engine: the round
    is one ``Engine.prefill`` and ``Engine.step`` calls, polled every 4
    steps."""
    batch = batch or engine.batch
    default = engine.ecfg.max_new_tokens
    queue = [np.asarray(p, np.int32) for p in prompts]
    buds = list(budgets) if budgets is not None else [default] * len(queue)
    toks, rounds, al_num, al_den = 0, 0, 0, 0
    t0 = time.perf_counter()
    with torch.no_grad():
        while queue:
            cur, queue = queue[:batch], queue[batch:]
            bud, buds = buds[:len(cur)], buds[len(cur):]
            n_real = len(cur)
            while len(cur) < batch:              # pad the last round
                cur.append(cur[-1])
                bud.append(0)                    # padded rows stay frozen
            state = engine.prefill(np.stack(cur))
            max_new = torch.as_tensor(np.maximum(bud, 1), dtype=torch.int32,
                                      device=engine.device)
            it = 0
            while True:
                state = engine.step(state, max_new=max_new)
                it += 1
                if it % 4 == 0 or it < 2:
                    nc = state["new_count"].cpu().numpy()
                    if (nc >= np.asarray(bud))[:n_real].all():
                        break
            # nc holds the readback that ended the loop
            nc = nc[:n_real]
            toks += int(np.minimum(nc, bud[:n_real]).sum())  # trim overshoot
            al_num += int(state["committed"])
            al_den += max(int(state["row_iters"]), 1)
            rounds += 1
    wall = time.perf_counter() - t0
    return {
        "otps": toks / max(wall, 1e-9),
        "total_new_tokens": toks,
        "wall_s": wall,
        "mean_acceptance_length": al_num / max(al_den, 1),
        "rounds": rounds,
    }

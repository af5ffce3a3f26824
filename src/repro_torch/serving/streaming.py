"""Wall-clock streaming front end over the scheduler's loop core (PyTorch).

Counterpart of the JAX package's ``serving/streaming.py``. The scheduler's
core (``_admit_waiting`` -> ``_grow`` -> ``_dispatch`` -> ``_harvest``) has
two drivers: the deterministic virtual-clock ``Scheduler.serve`` and this
module's :class:`AsyncEngine`, which paces the same core by real time on an
asyncio loop and streams each request's ``(token, logprob)`` pairs out as
its syncs commit. A request's stream is a function of its own prompt and
policy (rows are independent, sampled keys are ``fold_in(seed,
position)``), so a streamed run yields exactly what the virtual twin
(:func:`virtual_twin_report`) yields for the same workload, whatever the
arrival timing, batch composition, preemptions or aborts of other requests.

Semantics:

- a stream yields only final tokens: the emit buffer is filled after the
  incremental stop / budget trim, so no yielded token is ever retracted;
- ``abort()`` (or closing a ``generate()`` iterator early) cancels a
  request at once: a queued one leaves the wait queue, a running one's
  pages return to the pool (its slot's rows are reset by the dispatch task
  before its next admission), a swapped-out one's host bytes are freed;
- backpressure: at most ``max_pending`` requests are in flight (queued and
  running); ``submit()`` awaits a free ticket, and a rejected submit
  returns it;
- ``health()`` reports queue depth, running slots, pool occupancy, wait
  percentiles (interpolated) and the program's counters
  (``tracing.counters()``, the verify forwards captured, replayed from a
  CUDA graph and run eagerly among them).

Everything runs on one event loop. Only the dispatch task launches work on
the device, one blocking sync at a time; ``submit``, ``abort`` and
``health`` touch host state between its syncs. ``launch/serve_stream.py``
puts an NDJSON socket server in front of this class.

Over a storage-sharded engine (``EngineConfig(shard_model=True)``) every
rank of the mesh makes an ``AsyncEngine``; rank 0 decides and every rank
replays. Rank 0 serves the clients and runs the event loop; before each
pass of the core (admit, grow, dispatch, harvest) it broadcasts one record
(``Mesh.broadcast``, host objects over gloo): the submissions since the
last record (rid, prompt, policy, budget, extras, arrival, ``t_submit``)
and aborts, in their order, its clock, and whether the session closes.
The other ranks run :meth:`AsyncEngine.follow`: apply each record, then
make the same engine calls, which decide from the same replicated state,
so their gathers match. Streams, ``health()`` and the report live on rank
0; a follower's ``submit`` raises. Rank 0's own work inside a pass (its
deliveries to the streams) never interrupts the pass's engine calls: an
error there is raised after them, and a failure of rank 0 outside the
engine calls goes out in the next record, on which every follower raises
instead of waiting in a gather. The exchange runs whenever the engine has
a mesh, a one-rank mesh too.
"""
from __future__ import annotations

import asyncio
import contextlib
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import ABORTED, FINISHED, Request, Scheduler


class StreamHandle:
    """One streamed request: an async iterator of ``(token, logprob)``
    pairs, and ``abort()``. Made by :meth:`AsyncEngine.submit`."""

    def __init__(self, engine: "AsyncEngine", request: Request,
                 queue: "asyncio.Queue"):
        self._engine = engine
        self.request = request
        self._queue = queue
        self._exhausted = False

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        """Finished or aborted: no more tokens will come."""
        return self.request.status in (FINISHED, ABORTED)

    @property
    def aborted(self) -> bool:
        return self.request.status == ABORTED

    def abort(self) -> bool:
        """Cancel this request (idempotent); see ``AsyncEngine.abort``."""
        return self._engine.abort(self)

    def __aiter__(self) -> "StreamHandle":
        return self

    async def __anext__(self) -> Tuple[int, float]:
        if self._exhausted:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is None:                      # finished or aborted
            self._exhausted = True
            raise StopAsyncIteration
        if isinstance(item, BaseException):   # the dispatch loop failed
            self._exhausted = True
            raise item
        return item


class AsyncEngine:
    """Wall-clock asyncio serving over one :class:`Engine`.

    It owns a ``Scheduler`` session driven by a dispatch task on the
    running loop. ``eos_id`` / ``sync_every`` / ``preempt`` /
    ``free_on_finish`` / ``adaptive_k`` go to the scheduler;
    ``max_pending`` bounds the requests in flight (default
    ``4 * engine.batch``). The engine is the session's alone while it is
    open.

        aeng = AsyncEngine(engine, eos_id=2)
        async for tok, lp in aeng.generate(prompt, SamplingParams(
                temperature=0.8, seed=7)):
            ...                      # as each sync commits
        aeng.health()["queue_depth"]
        report = await aeng.close()  # the scheduler's report

    Over a mesh of several ranks, each rank makes its own, with the same
    arguments; rank 0 (``leader``) is used as above, every other rank
    calls ``follow()``, which returns when rank 0 closes.
    """

    def __init__(self, engine: Engine, eos_id: Optional[int] = None,
                 sync_every: int = 1, preempt: Optional[bool] = None,
                 free_on_finish: bool = True,
                 max_pending: Optional[int] = None,
                 adaptive_k: Any = None):
        self.engine = engine
        self.mesh = getattr(engine, "mesh", None)
        self.leader = self.mesh is None or self.mesh.is_root
        self.scheduler = Scheduler(engine, eos_id=eos_id,
                                   free_on_finish=free_on_finish,
                                   sync_every=sync_every, preempt=preempt,
                                   adaptive_k=adaptive_k)
        self.max_pending = (int(max_pending) if max_pending
                            else 4 * engine.batch)
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.records = 0                 # decision records sent / applied
        self._ops: List[tuple] = []      # rank 0's since its last record
        self._queues: Dict[int, asyncio.Queue] = {}
        self._done: set = set()          # rids whose end was delivered
        self._inflight = 0
        self._n_fin = 0                  # _finished entries delivered
        self._task: Optional[asyncio.Task] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._wake: Optional[asyncio.Event] = None
        self._closing = False
        self._error: Optional[BaseException] = None
        self._front_error: Optional[BaseException] = None
        self._report: Optional[Dict[str, Any]] = None

    def _leader_only(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(
                f"AsyncEngine.{what} on rank {self.mesh.coords}: rank 0 "
                "serves the clients; the other ranks call follow()")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> None:
        """Open the session and start the dispatch task (idempotent;
        ``submit`` calls it)."""
        self._leader_only("start")
        if self._task is not None:
            return
        self._open()
        self._sem = asyncio.Semaphore(self.max_pending)
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._run())

    def _open(self) -> None:
        sched = self.scheduler
        sched._begin_session()
        # wall-clock mode: _advance reads elapsed real time, so the
        # session's *_vt columns and event stamps are wall seconds
        sched._wall_t0 = sched._t_start

    async def close(self, drain: bool = True) -> Dict[str, Any]:
        """End the session and return the scheduler's report: after every
        request in flight finishes (``drain``), or aborting them."""
        self._leader_only("close")
        if self._task is None:
            await self.start()           # an empty session
        if not drain:
            for req in list(self.scheduler._waiting):
                self.abort(req)
            for req in list(self.scheduler._slot_req):
                if req is not None:
                    self.abort(req)
        self._closing = True
        self._wake.set()
        await self._task
        if self._report is None:
            sched = self.scheduler
            self._report = sched._end_session(
                time.perf_counter() - sched._t_start)
        if self._error is not None:
            raise self._error
        return self._report

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    async def submit(self, prompt, sampling_params: Optional[SamplingParams]
                     = None, max_new_tokens: Optional[int] = None,
                     extras: Optional[dict] = None) -> StreamHandle:
        """Await a backpressure ticket, queue the request and return its
        :class:`StreamHandle`. ``extras``: the request's modality inputs
        (``Request.extras``; a VLM or encoder-decoder request without them
        gets the prompt-keyed stub). A request that could never be served
        (budget past ``max_len`` or the pool) raises ValueError and gives
        its ticket back; so does one that waited for its ticket while the
        session began to close, with RuntimeError."""
        self._leader_only("submit")
        await self.start()
        if self._error is not None:
            raise self._error
        if self._closing:
            raise RuntimeError("AsyncEngine is closing")
        await self._sem.acquire()
        sched = self.scheduler
        try:
            # the session may have failed or begun to close while this
            # submit waited for its ticket
            if self._error is not None:
                raise self._error
            if self._closing:
                raise RuntimeError("AsyncEngine is closing")
            sched._advance(0.0)          # read the wall clock
            req = Request(prompt, max_new_tokens=max_new_tokens,
                          arrival_time=sched._clock, extras=extras,
                          sampling=sampling_params)
            sched._submit(req)
        except BaseException:
            self._sem.release()
            raise
        if self.mesh is not None:
            self._ops.append(("submit", dict(
                rid=req.rid, prompt=req.prompt, sampling=req.sampling,
                max_new_tokens=req.max_new_tokens,
                extras=None if req.extras is None else {
                    k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in req.extras.items()},
                arrival_time=req.arrival_time, t_submit=req.t_submit)))
        self._inflight += 1
        q: asyncio.Queue = asyncio.Queue()
        self._queues[req.rid] = q
        self._wake.set()
        return StreamHandle(self, req, q)

    async def generate(self, prompt,
                       sampling_params: Optional[SamplingParams] = None,
                       max_new_tokens: Optional[int] = None,
                       extras: Optional[dict] = None
                       ) -> AsyncIterator[Tuple[int, float]]:
        """Stream one completion, ``(token, logprob)`` as each sync commits.
        Closing the iterator early aborts the request."""
        handle = await self.submit(prompt, sampling_params, max_new_tokens,
                                   extras)
        try:
            async for tok, lp in handle:
                yield tok, lp
        finally:
            if not handle.done:
                self.abort(handle)

    def abort(self, handle) -> bool:
        """Cancel a request (a StreamHandle or a Request) now; its pages
        return to the pool and the slot is admissible on the next pass.
        Tokens already streamed stay valid. False when it had already
        finished."""
        self._leader_only("abort")
        req = handle.request if isinstance(handle, StreamHandle) else handle
        sched = self.scheduler
        if self._task is None:
            return False
        sched._advance(0.0)
        if not sched._abort(req):
            return False
        if self.mesh is not None:
            self._ops.append(("abort", req.rid, sched._clock))
        self._deliver()                  # the end sentinel, the ticket
        self._wake.set()
        return True

    def health(self) -> Dict[str, Any]:
        """A monitoring snapshot of the live session (host state only)."""
        self._leader_only("health")
        sched, eng = self.scheduler, self.engine
        if self._task is None:
            raise RuntimeError("AsyncEngine not started")
        completed = [r for r in sched._finished if r.status == FINISHED]
        # wall stamps only: t_admit 0.0 marks a request that ended without
        # an admission
        waits = [r.t_admit - r.t_submit for r in completed
                 if r.t_admit > 0.0]

        def pct(p: float) -> float:
            return float(np.percentile(waits, p)) if waits else 0.0

        pool_total = eng.pool_pages if eng.paged else 0
        pool_free = eng.allocator.n_free if eng.paged else 0
        hp = eng.host_pool               # None unless swap="host"
        return {
            "queue_depth": len(sched._waiting),
            "running": int(sched._active.sum()),
            "slots": eng.batch,
            "inflight": self._inflight,
            "max_pending": self.max_pending,
            "pool_pages": pool_total,
            "pool_free": pool_free,
            "pool_occupancy": (1.0 - pool_free / pool_total
                               if pool_total else 0.0),
            # `is not None`: an empty HostPagePool is falsy
            "swapped": len(hp) if hp is not None else 0,
            "host_pool_bytes": hp.capacity if hp is not None else 0,
            "host_pool_used_bytes": hp.used_bytes if hp is not None else 0,
            "host_pool_peak_bytes": hp.peak_used if hp is not None else 0,
            "host_pool_occupancy": (hp.used_bytes / hp.capacity
                                    if hp is not None and hp.capacity
                                    else 0.0),
            "finished": len(completed),
            "aborted": len(sched._finished) - len(completed),
            "preemptions": sched._n_preempt,
            "p50_wait_s": pct(50),
            "p99_wait_s": pct(99),
            "uptime_s": time.perf_counter() - sched._t_start,
            "counters": tracing.counters(),
        }

    # ------------------------------------------------------------------
    # the dispatch task
    # ------------------------------------------------------------------
    def _deliver(self) -> None:
        """Move the core's emit buffer into the request queues; send the
        end sentinel and give the ticket back for each request that newly
        finished or was aborted."""
        sched = self.scheduler
        for req, toks, lps in sched._emit:
            q = self._queues.get(req.rid)
            if q is not None:
                for pair in zip(toks, lps):
                    q.put_nowait(pair)
        sched._emit.clear()
        while self._n_fin < len(sched._finished):
            req = sched._finished[self._n_fin]
            self._n_fin += 1
            if req.rid in self._done:
                continue
            self._done.add(req.rid)
            q = self._queues.pop(req.rid, None)
            if q is not None:
                q.put_nowait(None)
            self._inflight -= 1
            self._sem.release()

    def _deliver_in_pass(self) -> None:
        """``_deliver`` inside a pass: an error is kept, to be raised once
        the pass's engine calls have run (every rank makes them)."""
        try:
            self._deliver()
        except Exception as e:           # noqa: BLE001 (raised after)
            self._front_error = self._front_error or e

    def _fail(self, err: BaseException) -> None:
        """The dispatch task failed: the error reaches every open stream
        and later submits, and backpressure waiters are released."""
        self._error = err
        for rid, q in list(self._queues.items()):
            if rid not in self._done:
                self._done.add(rid)
                q.put_nowait(err)
                self._inflight -= 1
                self._sem.release()
        self._queues.clear()

    def _pass(self, deliver) -> None:
        """One pass of the loop core, the same on every rank: admit, grow,
        dispatch and harvest, ``deliver`` after the admissions (a request
        may finish at its first token) and after the harvest."""
        sched = self.scheduler
        sched._admit_waiting()
        deliver()
        if not sched._active.any():
            if sched._waiting:
                raise RuntimeError("no active slot and the head request "
                                   "cannot be admitted: page pool leak?")
            return
        run = sched._grow()
        sched._dispatch(run)
        sched._harvest()                 # blocks on the readback
        deliver()

    def _send(self, close: bool) -> None:
        """Rank 0: broadcast the record of the next pass (or of the close)
        to every rank of the mesh; nothing without a mesh."""
        if self.mesh is None:
            return
        ops, self._ops = self._ops, []
        self.mesh.broadcast({"ops": ops, "clock": self.scheduler._clock,
                             "close": close, "error": None})
        self.records += 1

    async def _run(self) -> None:
        """The wall-clock driver: admit, grow, dispatch and harvest in one
        blocking pass, then yield to the clients; wait on the wake event
        when there is nothing to do. Over a mesh, each pass is preceded by
        its record and the session ends with a closing one."""
        sched = self.scheduler
        in_pass = False
        try:
            while True:
                sched._advance(0.0)
                idle = not sched._waiting and not sched._active.any()
                if idle and not self._closing:
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                self._send(close=idle)
                if idle:
                    break
                in_pass = True
                with torch.no_grad():
                    self._pass(self._deliver_in_pass)
                in_pass = False
                if self._front_error is not None:
                    raise self._front_error
                # the clients' turn: submit and abort change core state
                # only here, between syncs
                await asyncio.sleep(0)
        except BaseException as e:       # noqa: BLE001 (reaches the clients)
            self._fail(e)
            if self.mesh is not None and not in_pass:
                # the followers wait for a record: it carries the failure
                # (inside the engine calls every rank fails alike)
                with contextlib.suppress(Exception):
                    self.mesh.broadcast({"error": repr(e)})
                    self.records += 1
            if not isinstance(e, Exception):
                raise                    # cancellation, interrupt, exit
        finally:
            sched._advance(0.0)
            with torch.no_grad():
                self._report = sched._end_session(
                    time.perf_counter() - sched._t_start)

    # ------------------------------------------------------------------
    # the other ranks
    # ------------------------------------------------------------------
    def follow(self) -> Dict[str, Any]:
        """A follower rank's session (every rank of the mesh but rank 0):
        apply each of rank 0's records, its submissions and aborts in their
        order at rank 0's clock, and run the same pass, until rank 0
        closes. Blocks; returns this rank's session report, whose results
        are the replayed streams. Raises RuntimeError when rank 0's record
        says it failed."""
        if self.leader:
            raise RuntimeError("follow() is for the ranks other than rank 0")
        sched = self.scheduler
        self._open()
        reqs: Dict[int, Request] = {}
        try:
            while True:
                rec = self.mesh.broadcast()
                self.records += 1
                if rec.get("error") is not None:
                    raise RuntimeError(f"rank 0 failed: {rec['error']}")
                for op in rec["ops"]:
                    if op[0] == "submit":
                        f = op[1]
                        req = Request(f["prompt"],
                                      max_new_tokens=f["max_new_tokens"],
                                      arrival_time=f["arrival_time"],
                                      extras=f["extras"],
                                      sampling=f["sampling"], rid=f["rid"])
                        sched._advance(0.0, now=f["arrival_time"])
                        sched._submit(req, f["t_submit"])
                        reqs[req.rid] = req
                    else:
                        _, rid, clock = op
                        sched._advance(0.0, now=clock)
                        sched._abort(reqs[rid])
                sched._advance(0.0, now=rec["clock"])
                if rec["close"]:
                    break
                with torch.no_grad():
                    self._pass(sched._emit.clear)
        finally:
            sched._advance(0.0)
            with torch.no_grad():
                self._report = sched._end_session(
                    time.perf_counter() - sched._t_start)
        return self._report


def virtual_twin_report(engine: Engine, workload, eos_id: Optional[int]
                        = None, **scheduler_kwargs) -> Dict[str, Any]:
    """Serve ``workload``, a list of ``(prompt, SamplingParams or None,
    max_new_tokens or None)``, through the virtual-clock driver and return
    its report, results in workload order: what a streamed run of the
    same workload must yield."""
    reqs = [Request(np.asarray(p, np.int32), sampling=sp,
                    max_new_tokens=mnt) for p, sp, mnt in workload]
    rep = Scheduler(engine, eos_id=eos_id, **scheduler_kwargs).serve(reqs)
    order = {r.rid: i for i, r in enumerate(reqs)}
    rep["results"] = sorted(rep["results"], key=lambda r: order[r["rid"]])
    return rep

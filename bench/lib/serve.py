"""The serving driver: one run of a serving cell.

Set-up builds the port's kernels (or loads them from the checkout's build
directory), draws the weights from the seed (``weights.py``), builds a
paged ``Engine`` and warms every prefill bucket of the mix and the step.
A closed loop then primes: every client's first request is admitted
before the window opens. The window drives
``repro_torch.serving.streaming.AsyncEngine`` (``submit`` and its streams)
for ``seconds``; a token counts when its client receives it. After the
window every request still in flight is aborted, the peak memory is read,
the engine is freed and the sample of finished requests goes to the
reference (``bench/check.py``).

``Probe`` watches the session from outside the program: it wraps the
engine's ``step`` and ``prefill_into_slot`` (counted FLOPs, iteration
stamps, which request each slot held), the drafter's ``draft_parallel``
(the drafts, kept for the check), and in a traced run the scheduler's
passes (spans) and the attention entry points of ``kernels.ops`` (each
call's shapes and live keys, for the rooflines).
"""
from __future__ import annotations

import asyncio
import contextlib
import functools
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import check
from bench.lib import counts, traffic as TR, weights as W
from bench.lib.common import percentile
from bench.lib.record import Record, ReqRecord, TraceData
from bench.lib.trace import Stretch


def model_configs(config: dict):
    """The port's ``ModelConfig`` and ``DrafterConfig`` of the file."""
    from repro_torch.configs.base import DrafterConfig, ModelConfig, MoEConfig
    t = dict(config["target"])
    if "moe" in t:
        t["moe"] = MoEConfig(**t["moe"])
    tcfg = ModelConfig(source=config["source"], **t)
    dcfg = DrafterConfig(**config["drafter"]).resolve(tcfg)
    return tcfg, dcfg


class Probe:
    """The harness's wrappers around one engine and its scheduler."""

    def __init__(self, engine, scheduler, flops: counts.ServeFlops,
                 trace: bool):
        from repro_torch.core import drafter as D
        from repro_torch.kernels import ops
        self.engine, self.sched, self.flops = engine, scheduler, flops
        self.trace = trace
        self.step_times: List[float] = []
        self.flop_events: List[tuple] = []
        # per step: the live slots [(slot, rid, c)] and the drafts tensor
        self.slots: List[tuple] = []
        self.draft_refs: List[torch.Tensor] = []
        self.calls: List[tuple] = []
        self.recording = False
        self._keys: Optional[np.ndarray] = None
        self._in_draft = False
        self._undo: List[tuple] = []
        self._patch(engine, "step", self._step)
        self._patch(engine, "prefill_into_slot", self._admit)
        self._patch(D, "draft_parallel", self._draft)
        if trace:
            self._patch(ops, "paged_decode_attention", self._paged)
            self._patch(ops, "flash_attention", self._flash)
            for name in ("_admit_waiting", "_grow", "_dispatch", "_harvest"):
                self._patch(scheduler, name, functools.partial(
                    self._spanned, f"bench.sched.{name.strip('_')}"))

    def _patch(self, owner, name, fn) -> None:
        """``fn(original, *args, **kwargs)`` in place of ``owner.name``."""
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig, name in vars(owner)))
        setattr(owner, name, functools.partial(fn, orig))

    def close(self) -> None:
        for owner, name, orig, own in reversed(self._undo):
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._undo.clear()

    @staticmethod
    def _spanned(label, orig, *a, **kw):
        with torch.profiler.record_function(label):
            return orig(*a, **kw)

    # the program's calls, observed
    def _step(self, orig, state, *a, **kw):
        t = time.perf_counter()
        sched = self.sched
        live = [(s, sched._slot_req[s].rid, sched._slot_req[s]._prev_last)
                for s in np.flatnonzero(sched._active)]
        keys = np.zeros(self.engine.batch, np.int64)
        for s, _, c in live:
            keys[s] = c
        self._keys = keys
        self.slots.append(live)
        self.flop_events.append((t, self.flops.step([c for *_, c in live])))
        self.step_times.append(t)
        with (torch.profiler.record_function("bench.engine.step")
              if self.trace else contextlib.nullcontext()):
            return orig(state, *a, **kw)

    def _admit(self, orig, state, prompt, slot, *a, **kw):
        with (torch.profiler.record_function("bench.engine.admit")
              if self.trace else contextlib.nullcontext()):
            out = orig(state, prompt, slot, *a, **kw)
        self.flop_events.append((time.perf_counter(),
                                 self.flops.admission(int(np.size(prompt)))))
        return out

    def _draft(self, orig, *a, **kw):
        self._in_draft = True
        try:
            out = orig(*a, **kw)
        finally:
            self._in_draft = False
        if len(self.draft_refs) < len(self.slots):
            self.draft_refs.append(out[0])
        return out

    def _paged(self, orig, q, k_pool, v_pool, pos_pool, block_table,
               q_positions, **kw):
        if self.recording and self._keys is not None:
            B, T, H, hd = q.shape
            keys = self._keys - 1 if self._in_draft else self._keys
            self.calls.append(("paged_decode_attention",
                               counts.paged_decode_attention(
                                   B, T, H, k_pool.shape[2], hd,
                                   block_table.shape[1],
                                   np.clip(keys, 0, None),
                                   elt=q.element_size())))
        return orig(q, k_pool, v_pool, pos_pool, block_table, q_positions,
                    **kw)

    def _flash(self, orig, q, k, v, **kw):
        if self.recording:
            B, Sq, H, hd = q.shape
            self.calls.append(("flash_attention", counts.flash_attention(
                B, Sq, k.shape[1], H, k.shape[2], hd,
                causal=kw.get("causal", True), kv_len=kw.get("kv_len", 0),
                elt=q.element_size())))
        return orig(q, k, v, **kw)

    def drafts(self, window) -> Dict[int, list]:
        """rid -> [(c, the K drafts of its row)] for the steps in the
        window (host copies, read once the window has closed)."""
        w0, w1 = window
        out: Dict[int, list] = {}
        for t, live, toks in zip(self.step_times, self.slots,
                                 self.draft_refs):
            if not w0 <= t < w1 or not live:
                continue
            rows = toks.cpu().numpy()
            for s, rid, c in live:
                out.setdefault(rid, []).append((int(c), rows[s].copy()))
        return out


def _by_5s(times, w0: float, w1: float) -> List[int]:
    """Events in each 5 s of the window: how steady the window ran."""
    n = max(1, int((w1 - w0) // 5))
    out = [0] * n
    for t in times:
        if w0 <= t < w0 + 5 * n:
            out[int((t - w0) // 5)] += 1
    return out


def _acceptance(recs) -> float:
    """Tokens committed a decode iteration over finished requests (the
    first token, the prefill's, left out): about 1 for a random drafter."""
    n = sum(len(r.tokens) - 1 for r in recs if r.finished and r.iters)
    it = sum(r.iters for r in recs if r.finished and r.iters)
    return n / it if it else 0.0


def _warm(engine, mix: dict, vocab: int, seed: int) -> None:
    """One admission per prefill bucket of the mix, a few steps each,
    through the scheduler (a session of its own)."""
    from repro_torch.serving.scheduler import Request, Scheduler
    rng = np.random.default_rng([int(seed), 0x3A3])
    reqs = [Request(rng.integers(0, vocab - 1, b).astype(np.int32),
                    max_new_tokens=4) for b in TR.buckets(mix)]
    Scheduler(engine).serve(reqs)


async def _drive(aeng, mix: dict, plan, seconds: float, stretch, probe,
                 recs: List[ReqRecord]):
    """The window: returns (the traffic's start, w0, w1, the traced
    stretch's iterations). A closed loop's traffic starts when its clients
    are primed, at w0; an open loop's with its lead."""
    from repro_torch.serving.scheduler import FINISHED
    stop = False
    primed = asyncio.Event()
    n_primed = [0]
    tasks: List[asyncio.Task] = []
    # tasks waiting in ``submit`` for a backpressure ticket: cancelled at
    # the window's end, before the close, whose aborts would hand them
    # tickets into a session that no longer dispatches
    in_submit: set = set()

    async def consume(spec, due: float, first: bool):
        rec = ReqRecord(due=due, prompt_len=int(spec.prompt.size),
                        budget=spec.budget, prompt=spec.prompt,
                        t_sent=time.perf_counter())
        recs.append(rec)
        me = asyncio.current_task()
        try:
            in_submit.add(me)
            try:
                h = await aeng.submit(spec.prompt, None, spec.budget)
            finally:
                in_submit.discard(me)
            rec.rid = h.rid
            async for _ in h:
                now = time.perf_counter()
                if rec.t_first is None:
                    rec.t_first = now
                    if first:
                        n_primed[0] += 1
                        if n_primed[0] == len(plan):
                            primed.set()
                rec.times.append(now)
            req = h.request
            rec.finished = req.status == FINISHED
            rec.t_admit = req.t_admit
            rec.tokens = list(req.out_tokens)
            rec.iters = req.iters
        except Exception as e:           # noqa: BLE001 (reported, counted)
            if not stop:                 # after the window: never admitted
                rec.error = repr(e)

    async def client(chain):
        for i, spec in enumerate(chain):
            if stop:
                return
            await consume(spec, time.perf_counter(), i == 0)

    async def arrivals(base: float, w1: float):
        for spec in plan:
            due = base + spec.due
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            if stop or due >= w1:
                return
            tasks.append(asyncio.ensure_future(consume(spec, due, False)))

    await aeng.start()
    if mix["loop"] == "closed":
        tasks = [asyncio.ensure_future(client(c)) for c in plan]
        await primed.wait()
        base = w0 = time.perf_counter()
        w1 = w0 + seconds
        gen = None
    else:
        base = time.perf_counter()
        w0 = base + float(mix.get("lead_s", 0.0))
        w1 = w0 + seconds
        gen = asyncio.ensure_future(arrivals(base, w1))
    it = n0 = 0
    if stretch is not None:
        # the traced stretch closes the window: the profiler's stop, which
        # blocks the loop while it collects the trace, falls after it
        await asyncio.sleep(max(0.0, w1 - min(5.0, 0.4 * seconds)
                                - time.perf_counter()))
        stretch.start()
        probe.recording = True
        n0 = len(probe.step_times)
    await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
    stop = True
    if stretch is not None:
        stretch.stop()
        probe.recording = False
        it = len(probe.step_times) - n0
    if gen is not None:
        gen.cancel()
    for t in list(in_submit):
        t.cancel()
    await aeng.close(drain=False)
    await asyncio.gather(*tasks, return_exceptions=True)
    return base, w0, w1, it


def run(cell: dict, config: dict, mix: dict, *, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, controls=()) -> dict:
    """One run of a serving cell; returns the record, the peak memory and
    the check's readings (and, for each precision of ``controls``, the
    control's readings on the same sample: ``bench/control.py``)."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.streaming import AsyncEngine
    dev = torch.device(device)
    parts = {"imports": time.perf_counter() - t_start}
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
    parts["kernels"] = time.perf_counter() - t_start
    tcfg, dcfg = model_configs(config)
    eng_cfg = mix["engine"]
    K = int(eng_cfg["K"])
    dtype = getattr(torch, config["target"]["dtype"])
    trees = W.draw({"target": W.target_layout(config["target"]),
                    "drafter": W.drafter_layout(config["drafter"],
                                                config["target"])},
                   seed, dev, dtype)
    tparams, dparams = trees["target"], trees["drafter"]
    parts["weights"] = time.perf_counter() - t_start
    ecfg = EngineConfig(
        K=K, max_new_tokens=int(mix["output_len"][1]),
        drafter_mode="parallel", cache_dtype=config["target"]["dtype"],
        max_len=int(eng_cfg["max_len"]), kv_layout="paged",
        page_size=int(eng_cfg["page_size"]),
        pool_pages=int(eng_cfg.get("pool_pages", 0)), bucket_prefill=True)
    engine = Engine(tcfg, dcfg, tparams, dparams, ecfg,
                    int(eng_cfg["slots"]), device=dev)
    vocab = tcfg.vocab_size
    parts["engine"] = time.perf_counter() - t_start
    _warm(engine, mix, vocab, seed)
    parts["warm"] = time.perf_counter() - t_start
    plan = (TR.closed_plan(mix, seed, vocab) if mix["loop"] == "closed"
            else TR.open_plan(mix, seed, vocab, seconds))
    aeng = AsyncEngine(engine)
    probe = Probe(engine, aeng.scheduler, counts.ServeFlops(config, K), trace)
    stretch = Stretch(torch) if trace else None
    if stretch is not None:
        stretch.warm()
    recs: List[ReqRecord] = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # the set-up's objects leave the collector's generations: the window's
    # collections scan what the window makes
    gc.collect()
    gc.freeze()
    try:
        t_open, w0, w1, stretch_iters = asyncio.run(
            _drive(aeng, mix, plan, seconds, stretch, probe, recs))
    finally:
        probe.close()
        gc.unfreeze()
    setup_s = t_open - t_start
    parts["primed"] = setup_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    drafts = probe.drafts((w0, w1))
    tdata = None
    if stretch is not None:
        kernels, spans = stretch.events()
        tdata = TraceData(window_s=stretch.t1 - stretch.t0,
                          iterations=stretch_iters, kernels=kernels,
                          spans=spans, calls=probe.calls)
    rec = Record(setup_s=setup_s, window=(w0, w1), requests=recs,
                 step_times=probe.step_times, flops=probe.flop_events,
                 trace=tdata)
    # the program's state goes before the reference runs
    del aeng, engine, probe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done = [r for r in recs
            if r.finished and r.times and w0 <= r.times[-1] <= w1]
    lim = config.get("check", {})
    picks = check.sample(done, int(mix["check"]["requests"]), seed)
    readings = check.served_readings(
        config, tparams, dparams, picks, drafts, K, seed,
        int(mix["check"]["draft_steps"]), dev)
    correct, checks = check.judge(readings, lim)
    ctl = {p: check.served_readings(
        config, tparams, dparams, picks, drafts, K, seed,
        int(mix["check"]["draft_steps"]), dev, control=p) for p in controls}
    attempted = sum(1 for r in recs if w0 <= r.due < w1)
    failed = sum(1 for r in recs if r.error is not None)
    late = [r.t_sent - r.due for r in recs if w0 <= r.due < w1]
    notes = {"setup_parts_s": parts,
             "generator_late_s": {"max": max(late, default=0.0),
                                  "p95": percentile(late, 95) or 0.0},
             "requests_finished": sum(1 for r in recs if r.finished),
             "tokens_by_5s": _by_5s([t for r in recs for t in r.times],
                                    w0, w1),
             "steps_by_5s": _by_5s(rec.step_times, w0, w1),
             "steps": len(rec.step_times), "window_iterations":
             rec.iterations(), "drafter_acceptance": _acceptance(recs)}
    return {"record": rec, "peak": peak, "notes": notes,
            "correct": correct and not failed, "checks": checks,
            "attempted": attempted, "failed": failed, "readings": readings,
            "controls": ctl}

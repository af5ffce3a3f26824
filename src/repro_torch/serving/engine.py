"""Batched speculative-decoding engine (PyTorch).

Counterpart of the JAX package's ``serving/engine.py``: whole-batch serving
(``prefill`` / ``step`` / ``run``, contiguous KV layout only) and the
per-slot primitives the continuous-batching scheduler drives
(``serving/scheduler.py``): ``blank_state``, ``prefill_into_slot`` (a
bucketed batch-1 admission prefill written into one slot of the live
batch), ``ensure_capacity`` (incremental page growth), ``free_slot`` and
``step`` under an active mask with per-slot budgets. Three drafter modes:

  "parallel" — P-EAGLE: one drafter forward drafts K tokens
  "ar"       — AR EAGLE-3 baseline: K sequential drafter forwards
  "none"     — vanilla autoregressive decoding (one target forward a token)

Verification policy is per request (``serving/sampling.py``): every slot
carries its own ``SamplingParams`` row in the decode state's
``"sampling"`` subtree, and one step runs the greedy prefix match for
``temperature == 0`` rows and seeded lossless rejection sampling against
the row-warped target for the rest (``core/spec_decode.mixed_verify``).
Greedy rows emit the target's greedy output in every mode: drafts only
decide how many tokens one verify forward commits. A sampled row's keys are
re-derived each step as ``fold_in(seed, position)``, so its stream is a
pure function of ``(seed, committed prefix)``, and equal to the JAX
engine's. When no slot samples, a step takes the greedy-only lane, which
launches no warp, sort or threefry op. KV caches inside the state are
updated in place by each step.

Two KV layouts: "contiguous" (every slot owns a max_len cache row) and
"paged" (every attention cache is a pool of ``page_size``-position pages
behind a per-slot ``block_table``, pages handed out by a
``cache_ops.BlockAllocator``). Unlike the JAX engine, whose paged step
gathers each slot's pages into a contiguous view and scatters it back, the
paged step reads and writes the pools through the table: phase 1 of every
decode attention runs the paged decode kernel. Sharding, the prefix cache
and swap-to-host are not ported yet.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import DrafterConfig, ModelConfig
from repro_torch.core import drafter as D
from repro_torch.core import spec_decode as SD
from repro_torch.models.registry import get_model
from repro_torch.serving import cache_ops
from repro_torch.serving.sampling import (SamplingParams,
                                          batch_sampling_state,
                                          blank_sampling_state, draft_keys,
                                          step_keys)

Tensor = torch.Tensor
DRAFTER_MODES = ("parallel", "ar", "none")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. A missing card raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass(frozen=True)
class EngineConfig:
    """Static configuration of an :class:`Engine`.

    Attributes:
      K: speculation depth, tokens drafted per iteration (ignored when
        ``drafter_mode == "none"``).
      max_new_tokens: default generation budget per row, the first token
        included (the scheduler passes per-request budgets).
      drafter_mode: "parallel", "ar" or "none".
      cache_dtype: KV cache and taps dtype ("bfloat16" on the card).
      max_len: cache positions per row; prompt + budget + K must fit.
      kv_layout: "contiguous" (a max_len row per slot) or "paged" (a shared
        pool of pages behind per-slot block tables; scheduler only).
      page_size: positions per page (paged).
      pool_pages: pages in the pool; 0 = batch * max_len / page_size.
      kv_growth: "incremental" (admission claims the prompt plus one
        speculative block; ``ensure_capacity`` grows a slot as it crosses
        page boundaries) or "upfront" (admission reserves the request's
        whole lifetime).
      bucket_prefill: pad admission prefills to the next power of two, so
        distinct prompt lengths share O(log2 max_len) shapes.
      sampling: the default ``SamplingParams`` of whole-batch ``prefill`` /
        ``run`` and of requests without their own; None is greedy.
      draft_sampling: sampled rows draw their K drafts from the row-warped
        drafter distribution (keys ``sampling.draft_keys``) and verify
        against it as the proposal q; off, drafts are the drafter argmax
        and q its one-hot. Greedy rows take the argmax either way.
      greedy: deprecated alias (one ``DeprecationWarning``): True is
        ``SamplingParams.greedy()``, False a temperature-1.0 default.
    """
    K: int = 5
    max_new_tokens: int = 64
    drafter_mode: str = "parallel"
    cache_dtype: str = "float32"
    max_len: int = 512
    kv_layout: str = "contiguous"
    page_size: int = 16
    pool_pages: int = 0
    kv_growth: str = "incremental"
    bucket_prefill: bool = True
    sampling: Optional[SamplingParams] = None
    draft_sampling: bool = False
    greedy: Optional[bool] = None

    def __post_init__(self):
        if self.greedy is not None:
            warnings.warn(
                "EngineConfig(greedy=...) is deprecated: decoding policy is "
                "per request; pass SamplingParams (Request(sampling=...) or "
                "EngineConfig(sampling=...)) instead",
                DeprecationWarning, stacklevel=3)
            if self.sampling is None:
                object.__setattr__(
                    self, "sampling",
                    SamplingParams.greedy() if self.greedy
                    else SamplingParams(temperature=1.0))
        if self.sampling is None:
            object.__setattr__(self, "sampling", SamplingParams.greedy())
        if self.drafter_mode not in DRAFTER_MODES:
            raise ValueError(f"unknown drafter_mode {self.drafter_mode!r}")
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kv_growth not in ("incremental", "upfront"):
            raise ValueError(f"unknown kv_growth {self.kv_growth!r}")


def make_decode_state(model, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                      ecfg: EngineConfig, batch: int, *, device,
                      new_count_fill: int = 1,
                      cache_rows: Optional[int] = None,
                      sampling: Optional[dict] = None) -> dict:
    """The decode-state skeleton: the JAX engine's leaves, on ``device``.
    ``new_count`` starts at ``new_count_fill`` (1: prefill commits the
    first generated token). The caches have ``cache_rows`` rows (default
    ``batch``). ``sampling`` is the per-slot policy subtree
    (``batch_sampling_state``); None fills every slot with
    ``ecfg.sampling``."""
    cdt = getattr(torch, ecfg.cache_dtype)
    rows = batch if cache_rows is None else cache_rows
    i32 = dict(dtype=torch.int32, device=device)
    state = {
        "tokens": torch.zeros((batch, ecfg.max_len), **i32),
        # log p(token) under the raw target softmax at each committed
        # position; prompt positions read 0
        "logprobs": torch.zeros((batch, ecfg.max_len), dtype=torch.float32,
                                device=device),
        "last": torch.zeros((batch,), **i32),
        "taps_last": torch.zeros((batch, 3 * tcfg.d_model), dtype=cdt,
                                 device=device),
        "tcache": model.make_cache(rows, ecfg.max_len, dtype=cdt,
                                   device=device),
        "new_count": torch.full((batch,), new_count_fill, **i32),
        "slot_iters": torch.zeros((batch,), **i32),
        "iters": torch.zeros((), **i32),
        "row_iters": torch.zeros((), **i32),
        "committed": torch.zeros((), **i32),
        "sampling": (sampling if sampling is not None else
                     batch_sampling_state(ecfg.sampling, batch,
                                          device=device)),
    }
    if ecfg.drafter_mode != "none":
        state["dcache"] = D.make_cache(dcfg, rows, ecfg.max_len, dtype=cdt,
                                       device=device)
    return state


def _token_logprob(logits: Tensor, tok: Tensor) -> Tensor:
    """log p(tok) under the raw softmax of ``logits``; broadcasts over
    leading axes: (B, V) + (B,) -> (B,), (B, K+1, V) + (B, K+1) -> (B, K+1)."""
    lp = torch.log_softmax(logits, dim=-1)
    return lp.gather(-1, tok[..., None].long())[..., 0]


def _scatter_drop(buf: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    """Row-wise ``buf[b, idx[b, j]] = val[b, j]``, dropping indices past the
    end (the JAX scatter's ``mode="drop"``). Returns a new tensor."""
    B, W = buf.shape
    ext = torch.cat([buf, buf.new_zeros((B, 1))], dim=1)
    ext.scatter_(1, idx.long().clamp(0, W), val.to(buf.dtype))
    return ext[:, :W]


class Engine:
    """Speculative-decoding engine over ``batch`` slots.

    Args:
      tcfg / dcfg: target and drafter configs (dcfg None for mode "none").
      tparams / dparams: parameter trees (``models.transformer`` /
        ``core.drafter`` layout), moved to ``device``.
      ecfg: static engine configuration.
      batch: slots (rows of the decode state).
      device: "cuda" (the default) or "cpu"; a missing card raises.
    """

    def __init__(self, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                 tparams: dict, dparams: Optional[dict], ecfg: EngineConfig,
                 batch: int, *, device="cuda"):
        self.device = resolve_device(device)
        if ecfg.drafter_mode != "none" and (dcfg is None or dparams is None):
            raise ValueError(f"drafter_mode {ecfg.drafter_mode!r} needs a "
                             f"drafter config and parameters")
        self.tcfg, self.dcfg, self.ecfg, self.batch = tcfg, dcfg, ecfg, batch
        self.model = get_model(tcfg)
        self.tparams = _to(tparams, self.device)
        self.dparams = _to(dparams, self.device)
        self.last_logprob = 0.0     # of the last admission's first token
        # host-side mirror of which slots hold a sampled policy: a step with
        # none takes the greedy-only lane (the same tokens, fewer launches)
        self._slot_sampled = [False] * batch
        self.paged = ecfg.kv_layout == "paged"
        self.incremental = self.paged and ecfg.kv_growth == "incremental"
        if self.paged:
            if ecfg.max_len % ecfg.page_size:
                raise ValueError(f"max_len {ecfg.max_len} must be a multiple "
                                 f"of page_size {ecfg.page_size}")
            self.pages_per_slot = ecfg.max_len // ecfg.page_size
            self.pool_pages = ecfg.pool_pages or batch * self.pages_per_slot
            self.allocator = cache_ops.BlockAllocator(self.pool_pages)
            self._slot_pages: List[List[int]] = [[] for _ in range(batch)]
            # which leaves become pools: read off a storage-free template
            self.pspec = cache_ops.paged_spec(self._state_template(
                1, device="meta"))

    def _state_template(self, batch: int, *, device, **kw) -> dict:
        return make_decode_state(self.model, self.tcfg, self.dcfg, self.ecfg,
                                 batch, device=device, **kw)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def _prefill_rows(self, prompts: Tensor, true_len: int, samp: dict,
                      greedy: bool) -> dict:
        """A fresh contiguous state for ``prompts`` (B, Pb), whose first
        ``true_len`` tokens are real and the rest right-padding (Pb ==
        true_len: none), under the policy rows ``samp``. Causal attention
        leaves the real positions blind to the pads; the head reads
        position true_len - 1, which commits the first generated token (the
        argmax for greedy rows, a draw from the warped target keyed by
        ``fold_in(seed, true_len)`` for sampled ones; ``greedy`` says every
        row is greedy and skips the warp), and the pads' cache entries are
        invalidated afterwards."""
        B, Pb = prompts.shape
        P = true_len
        state = self._state_template(B, device=self.device, sampling=samp)
        hp = torch.full((B,), P - 1, dtype=torch.int32, device=self.device)
        out = self.model.forward(self.tparams, prompts, mode="prefill",
                                 cache=state["tcache"], collect_taps=True,
                                 head_positions=hp)
        head = out.logits[:, 0]
        if greedy:
            first = head.argmax(-1).to(torch.int32)
        else:
            first = SD.sample_token(step_keys(samp, P), head,
                                    samp["temperature"], samp["top_k"],
                                    samp["top_p"])
        state["tokens"][:, :Pb] = prompts
        state["tokens"][:, P] = first
        state["logprobs"][:, P] = _token_logprob(head, first)
        state["last"].fill_(P)
        state["taps_last"] = out.taps[:, P - 1].contiguous()
        state["tcache"] = out.cache
        cp = torch.full((B,), P - 1, dtype=torch.int32, device=self.device)
        if Pb > P:
            cache_ops.commit(state["tcache"], cp)
        if self.ecfg.drafter_mode != "none" and Pb > 1:
            pos = torch.arange(Pb - 1, dtype=torch.int32,
                               device=self.device)[None].repeat(B, 1)
            # drafter position p pairs taps[p] with token p + 1
            D.extend(self.dcfg, self.tcfg, self.dparams, state["dcache"],
                     prompts[:, 1:], out.taps[:, :Pb - 1], pos)
            if Pb > P:
                cache_ops.commit(state["dcache"], cp - 1)
        return state

    def prefill(self, prompts,
                sampling: Optional[SamplingParams] = None) -> dict:
        """Whole-batch prefill of ``prompts`` (B, P): a fresh contiguous
        decode state committing the first generated token per row, every
        row under ``sampling`` (default ``ecfg.sampling``)."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                  device=self.device)
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for an engine of batch {self.batch}")
        K = self.ecfg.K if self.ecfg.drafter_mode != "none" else 0
        if P + self.ecfg.max_new_tokens + K > self.ecfg.max_len:
            raise ValueError(
                f"prompt {P} + max_new_tokens {self.ecfg.max_new_tokens} + "
                f"K {K} exceeds max_len {self.ecfg.max_len}")
        sp = sampling or self.ecfg.sampling
        samp = batch_sampling_state(sp, B, device=self.device)
        with torch.no_grad():
            return self._prefill_rows(prompts, P, samp, sp.is_greedy)

    def prefill_bucket(self, length: int) -> int:
        """Tokens the admission prefill of a ``length``-token prompt runs:
        the next power of two, or the exact length where bucketing is off
        or the bucket would reach max_len. (The JAX engine's chunked
        variant is for recurrent families, which the port does not carry.)"""
        pb = 1 << max(length - 1, 0).bit_length()
        if not self.ecfg.bucket_prefill or pb >= self.ecfg.max_len:
            return length
        return pb

    def _admission_prefill(self, prompt: Tensor,
                           sp: SamplingParams) -> dict:
        P = prompt.shape[1]
        padded = F.pad(prompt, (0, self.prefill_bucket(P) - P))
        samp = batch_sampling_state(sp, 1, device=self.device)
        return self._prefill_rows(padded, P, samp, sp.is_greedy)

    # ------------------------------------------------------------------
    # per-slot lifecycle (continuous batching; serving/scheduler.py)
    # ------------------------------------------------------------------
    def blank_state(self) -> dict:
        """An all-idle state: empty caches (positions -1), zero tokens,
        every slot frozen (new_count == max_new_tokens). Paged: the caches
        are page pools and ``block_table`` (B, max_len / page_size) is all
        -1. Slots come alive through ``prefill_into_slot``."""
        if not self.paged:
            return self._state_template(
                self.batch, device=self.device,
                new_count_fill=self.ecfg.max_new_tokens,
                sampling=blank_sampling_state(self.batch, device=self.device))
        state = self._state_template(
            self.batch, device=self.device,
            new_count_fill=self.ecfg.max_new_tokens, cache_rows=1,
            sampling=blank_sampling_state(self.batch, device=self.device))
        state = cache_ops.paged_state(state, self.pspec, self.ecfg.page_size,
                                      self.pool_pages)
        state["block_table"] = torch.full(
            (self.batch, self.pages_per_slot), -1, dtype=torch.int32,
            device=self.device)
        return state

    @property
    def commit_stride(self) -> int:
        """Most positions one iteration writes past the last committed one
        (K drafted + 1 bonus; 1 for vanilla AR)."""
        return (self.ecfg.K if self.ecfg.drafter_mode != "none" else 0) + 1

    def pages_for(self, length: int) -> int:
        """Pages covering ``length`` cache positions (capped at max_len)."""
        if not self.paged:
            return 0
        return -(-min(max(length, 1), self.ecfg.max_len)
                 // self.ecfg.page_size)

    def pages_needed(self, prompt_len: int,
                     max_new: Optional[int] = None) -> int:
        """Pages one request occupies over its lifetime: prompt + budget +
        the worst speculative overshoot."""
        if not self.paged:
            return 0
        budget = self.ecfg.max_new_tokens if max_new is None else max_new
        return self.pages_for(prompt_len + budget + self.ecfg.K + 1)

    def initial_pages(self, prompt_len: int,
                      max_new: Optional[int] = None, *,
                      resume: bool = False) -> int:
        """Pages an admission claims: the whole lifetime (upfront), or the
        prompt plus one speculative block (incremental). A sampled
        ``resume`` of a ``prompt_len`` stream commits nothing past its last
        token, so its next step writes one position less than a fresh
        admission's, and it claims one position less."""
        if not self.paged:
            return 0
        if not self.incremental:
            return self.pages_needed(prompt_len, max_new)
        return self.pages_for(prompt_len + self.commit_stride
                              - (1 if resume else 0))

    def can_admit(self, prompt_len: int, max_new: Optional[int] = None,
                  full: bool = False, resume: bool = False) -> bool:
        """Whether the pool can take one more request of this shape now
        (always, contiguous). ``full`` gates on the whole-lifetime need, as
        the scheduler does for a preempted request's resume, so the same
        pressure cannot evict it again at once; ``resume`` mirrors
        ``prefill_into_slot(resume=)``."""
        if not self.paged:
            return True
        need = (self.pages_needed(prompt_len, max_new) if full
                else self.initial_pages(prompt_len, max_new, resume=resume))
        return need <= self.allocator.n_free

    def slot_capacity(self, slot: int) -> int:
        """Cache positions the slot's page allocation covers."""
        if not self.paged:
            return self.ecfg.max_len
        return len(self._slot_pages[slot]) * self.ecfg.page_size

    @staticmethod
    def _core(state: dict) -> dict:
        return {k: v for k, v in state.items() if k != "block_table"}

    def ensure_capacity(self, state: dict, slot: int, length: int):
        """Grow ``slot``'s pages to cover ``length`` positions, claiming
        pages only when its length crossed a page boundary. Returns
        ``(state, ok)``; ``ok`` False when the pool is exhausted (the
        caller preempts or stalls the slot). A claimed page is blanked
        before the table maps it: a recycled page may hold its previous
        owner's positions. No-op (ok) unless paged and incremental."""
        if not self.incremental:
            return state, True
        need = self.pages_for(length)
        have = len(self._slot_pages[slot])
        if need <= have:
            return state, True
        got = self.allocator.alloc(need - have)
        if got is None:
            return state, False
        self._slot_pages[slot].extend(got)
        got_t = torch.tensor(got, dtype=torch.int32, device=self.device)
        cache_ops.blank_pages(self._core(state), got_t, self.pspec)
        state["block_table"][slot, have:need] = got_t
        return state, True

    def prefill_into_slot(self, state: dict, prompt, slot: int,
                          max_new: Optional[int] = None,
                          sampling: Optional[SamplingParams] = None,
                          resume: bool = False):
        """Admit one request into slot ``slot`` of a live state: prefill
        ``prompt`` (1-D) as a batch-1 state (bucketed) under the request's
        policy ``sampling`` (default ``ecfg.sampling``), then write its row,
        the policy row included, into the slot, in place; other slots are
        untouched. Paged: the slot first claims ``initial_pages`` pages
        (callers gate on ``can_admit``) and the prefilled caches are
        scattered into them.

        A fresh admission (``resume=False``) commits the first generated
        token and returns ``(state, first_token, last_position)``, leaving
        its logprob in ``last_logprob``. A preempted request resumes by
        admitting prompt + the tokens it generated. A greedy stream simply
        continues from that prefix. A sampled one passes ``resume=True``:
        the engine prefills ``prompt[:-1]``, forces the committed token to
        ``prompt[-1]`` and starts the slot's count at 0, so the slot holds
        the uninterrupted run's step-boundary state and the next step
        re-derives the same ``fold_in(seed, position)`` keys; it returns
        ``(state, None, last_position)``."""
        prompt = torch.as_tensor(np.asarray(prompt, np.int32).reshape(1, -1),
                                 device=self.device)
        res_tok = None
        if resume:
            prompt, res_tok = prompt[:, :-1], prompt[0, -1]
        sp = sampling or self.ecfg.sampling
        self._slot_sampled[slot] = not sp.is_greedy
        with torch.no_grad():
            if not self.paged:
                src = self._admission_prefill(prompt, sp)
                cache_ops.write_slot(state, _resume_fixup(src, res_tok), slot)
            else:
                if self._slot_pages[slot]:
                    raise RuntimeError(f"slot {slot} still holds pages; "
                                       "free_slot it before re-admission")
                n = self.initial_pages(prompt.shape[1] + (1 if resume else 0),
                                       max_new, resume=resume)
                pages = self.allocator.alloc(n)
                if pages is None:
                    raise RuntimeError(
                        f"page pool exhausted ({n} needed, "
                        f"{self.allocator.n_free} free); gate on can_admit")
                self._slot_pages[slot] = pages
                row = torch.full((self.pages_per_slot,), -1,
                                 dtype=torch.int32, device=self.device)
                row[:n] = torch.tensor(pages, dtype=torch.int32)
                src = self._admission_prefill(prompt, sp)
                cache_ops.admit_pages(self._core(state),
                                      _resume_fixup(src, res_tok), slot, row,
                                      self.pspec)
                state["block_table"][slot] = row
        last = int(src["last"][0])
        if resume:
            self.last_logprob = 0.0
            return state, None, last
        self.last_logprob = float(src["logprobs"][0, last])
        return state, int(src["tokens"][0, last]), last

    def free_slot(self, state: dict, slot: int) -> dict:
        """Blank slot ``slot`` in place and refreeze it (new_count =
        max_new_tokens) until its next admission; paged, its pages return
        to the pool and its table row becomes -1."""
        fills = {"new_count": self.ecfg.max_new_tokens}
        self._slot_sampled[slot] = False
        if not self.paged:
            return cache_ops.reset_slot(state, slot, fills=fills)
        self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        cache_ops.reset_slot(self._core(state), slot, self.pspec, fills)
        state["block_table"][slot] = -1
        return state

    # ------------------------------------------------------------------
    # one speculative iteration
    # ------------------------------------------------------------------
    def _mixed_policy(self) -> bool:
        """Whether a step needs the sampled lane: an admitted slot samples,
        or the engine default does (whole-batch prefill fills every row
        with it). False selects the greedy-only lane: the same tokens, no
        warp, sort or threefry launch."""
        return any(self._slot_sampled) or not self.ecfg.sampling.is_greedy

    def step(self, state: dict, active=None, max_new=None,
             k_row=None, greedy_only: Optional[bool] = None) -> dict:
        """One speculative iteration. The scheduler passes ``active`` (B,)
        bool, per-slot budgets ``max_new`` (B,) and draft caps ``k_row``
        (B,); without them every row is live under the engine's budget and
        full K. ``greedy_only`` picks the lane (default: greedy-only unless
        ``_mixed_policy``). A paged state needs its block table."""
        if self.paged and "block_table" not in state:
            raise ValueError("a paged Engine steps a paged state "
                             "(blank_state + prefill_into_slot)")

        def dev(x, dtype):
            return None if x is None else torch.as_tensor(
                x, dtype=dtype, device=self.device)
        if greedy_only is None:
            greedy_only = not self._mixed_policy()
        with torch.no_grad():
            return speculative_step(
                self.model, self.tcfg, self.dcfg, self.ecfg, self.tparams,
                self.dparams, state, active_mask=dev(active, torch.bool),
                max_new=dev(max_new, torch.int32),
                k_row=dev(k_row, torch.int32), greedy_only=greedy_only)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, prompts, sampling: Optional[SamplingParams] = None,
            max_iters: int = 10_000) -> Dict[str, Any]:
        """Prefill, then step until every row has its ``max_new_tokens``
        (checked every 8 steps, as the JAX engine does), every row under
        ``sampling`` (default ``ecfg.sampling``; a greedy policy takes the
        greedy-only lane). ``steps`` counts the step calls, ``iterations``
        those in which some row was live. Contiguous only: a paged engine
        serves through the scheduler."""
        if self.paged:
            raise ValueError("Engine.run is the whole-batch contiguous loop; "
                             "drive a paged engine through "
                             "serving.scheduler.Scheduler")
        sp = sampling or self.ecfg.sampling
        t0 = time.perf_counter()
        state = self.prefill(prompts, sampling=sp)
        self._sync()
        t_prefill = time.perf_counter() - t0

        steps = 0
        t0 = time.perf_counter()
        while steps < max_iters:
            state = self.step(state, greedy_only=sp.is_greedy)
            steps += 1
            if steps % 8 == 0 or steps < 2:
                if bool((state["new_count"] >= self.ecfg.max_new_tokens).all()):
                    break
        self._sync()
        t_decode = time.perf_counter() - t0

        new_tok = int(state["new_count"].sum())
        row_iters = max(int(state["row_iters"]), 1)
        return {
            "state": state,
            "tokens": state["tokens"].cpu().numpy(),
            "new_tokens": new_tok,
            "iterations": max(int(state["iters"]), 1),
            "steps": steps,
            "acceptance_length": int(state["committed"]) / row_iters,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "otps": new_tok / max(t_decode, 1e-9),
        }


def _resume_fixup(src: dict, res_tok: Optional[Tensor]) -> dict:
    """Turn a batch-1 admission prefill into a step-boundary resume when
    ``res_tok`` is given: the token committed at ``last`` becomes
    ``res_tok`` (the prefix's final, already emitted token; the prefill's
    own draw is discarded) and the committed count starts at 0, so nothing
    is harvested twice and the next step verifies the true continuation.
    In place; returns ``src``."""
    if res_tok is not None:
        src["tokens"][0, src["last"][0]] = res_tok
        src["new_count"].zero_()
    return src


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def speculative_step(model, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                     ecfg: EngineConfig, tparams, dparams, state: dict,
                     active_mask: Optional[Tensor] = None,
                     max_new: Optional[Tensor] = None,
                     k_row: Optional[Tensor] = None,
                     # eager PyTorch: no trace to specialize
                     greedy_only: bool = False,  # repro-lint: disable=TRACE01
                     ) -> dict:
    """One iteration: draft K -> verify K+1 -> accept -> commit.

    ``active_mask`` (B,) bool masks out free or stalled slots and
    ``max_new`` (B,) gives per-slot budgets (default: every row, the
    engine's budget); a row out of budget or masked is frozen: it commits
    nothing and keeps last/taps/counters. ``k_row`` (B,) caps each row's
    accepted drafts (a greedy row's correction token is then the target
    argmax at the cap, so its stream is unchanged; a sampled row
    force-rejects past it, losslessly). With ``state["block_table"]`` the
    caches are page pools read and written through it. The caches of
    ``state`` are updated in place; the returned state holds them.

    Verification is per row (``state["sampling"]``): greedy rows take the
    argmax prefix match on the raw target logits; sampled rows run seeded
    rejection sampling against the row-warped target with the keys
    ``fold_in(seed, c + 1)``, c + 1 being the first position the step
    determines. With ``ecfg.draft_sampling`` sampled rows draw their drafts
    from the row-warped drafter distribution (``draft_keys``) and hand it
    to the verifier as q; otherwise q is the one-hot of the argmax drafts.
    ``greedy_only`` skips the sampled lane altogether (no warp, sort or
    threefry op); for greedy rows both lanes give the same tokens."""
    B = state["tokens"].shape[0]
    K = ecfg.K if ecfg.drafter_mode != "none" else 0
    c = state["last"]
    tok_next = state["tokens"].gather(1, c[:, None].long())[:, 0]
    dcache = state.get("dcache")
    table = state.get("block_table")
    samp = state["sampling"]

    policy = None
    if ecfg.draft_sampling and not greedy_only and K > 0:
        policy = (draft_keys(samp, c + 1, K), samp["temperature"],
                  samp["top_k"], samp["top_p"])
    dlogits = None
    if ecfg.drafter_mode == "parallel":
        drafts, dlogits, dcache = D.draft_parallel(
            dcfg, tcfg, dparams, dcache, tok_next, state["taps_last"], c - 1,
            K, block_table=table, policy=policy)
    elif ecfg.drafter_mode == "ar":
        drafts, dlogits, dcache = D.draft_ar(
            dcfg, tcfg, dparams, dcache, tok_next, state["taps_last"], c - 1,
            K, block_table=table, policy=policy)
    else:
        drafts = torch.zeros((B, 0), dtype=torch.int32, device=c.device)

    # target verify over [t_last, d_1..d_K] at positions c..c+K
    vt = torch.cat([tok_next[:, None], drafts], dim=1)
    positions = c[:, None] + torch.arange(K + 1, dtype=torch.int32,
                                          device=c.device)[None]
    tout = model.forward(tparams, vt, mode="decode", positions=positions,
                         cache=state["tcache"],
                         collect_taps=ecfg.drafter_mode != "none",
                         block_table=table)
    if K == 0:
        accept_len = torch.zeros((B,), dtype=torch.int32, device=c.device)
        if greedy_only:
            t_star = tout.logits.argmax(-1).to(torch.int32)
        else:
            t_star = SD.sample_token(step_keys(samp, c + 1),
                                     tout.logits[:, 0], samp["temperature"],
                                     samp["top_k"], samp["top_p"])[:, None]
    elif greedy_only:
        accept_len, t_star = SD.greedy_verify(drafts, tout.logits)
        if k_row is not None:
            accept_len = torch.minimum(accept_len, k_row)
    else:
        V = tout.logits.shape[-1]
        q = F.one_hot(drafts.long(), V).to(tout.logits.dtype)
        if policy is not None:
            q = torch.where((samp["temperature"] > 0)[:, None, None],
                            SD.warp_probs(dlogits, samp["temperature"],
                                          samp["top_k"], samp["top_p"]), q)
        accept_len, t_star = SD.mixed_verify(
            step_keys(samp, c + 1), drafts, q, tout.logits,
            samp["temperature"], samp["top_k"], samp["top_p"], k_row)

    budget = ecfg.max_new_tokens if max_new is None else max_new
    active = state["new_count"] < budget
    if active_mask is not None:
        active &= active_mask
    accept_len = torch.where(active, accept_len, 0)

    # invalidate the target cache past the last accepted token
    tcache = cache_ops.commit(tout.cache, c + accept_len, table)

    # append committed tokens t_star[0..accept_len]
    ar = torch.arange(K + 1, dtype=torch.int32, device=c.device)[None]
    idx = c[:, None] + 1 + ar
    keep = (ar <= accept_len[:, None]) & active[:, None]
    safe_idx = torch.where(keep, idx, state["tokens"].shape[1])
    tokens = _scatter_drop(state["tokens"], safe_idx, t_star)
    logprobs = _scatter_drop(state["logprobs"], safe_idx,
                             _token_logprob(tout.logits, t_star))

    new_last = torch.where(active, c + accept_len + 1, c)
    taps_last = state["taps_last"]
    new_state = {}
    if ecfg.drafter_mode != "none":
        taps_new = tout.taps[torch.arange(B, device=c.device),
                             accept_len.long()]
        taps_last = torch.where(active[:, None], taps_new, taps_last)
        # extend the drafter cache across the verified block; the stale
        # tail is invalidated by the next positional write
        new_state["dcache"] = D.extend(dcfg, tcfg, dparams, dcache, t_star,
                                       tout.taps, positions,
                                       block_table=table)

    ncommit = torch.where(active, accept_len + 1, 0)
    act = active.to(torch.int32)
    new_state.update(
        tokens=tokens,
        logprobs=logprobs,
        last=new_last,
        taps_last=taps_last,
        tcache=tcache,
        new_count=state["new_count"] + ncommit,
        slot_iters=state["slot_iters"] + act,
        iters=state["iters"] + act.max(),
        row_iters=state["row_iters"] + act.sum(dtype=torch.int32),
        committed=state["committed"] + ncommit.sum(dtype=torch.int32),
        sampling=samp,
    )
    if table is not None:
        new_state["block_table"] = table
    return new_state

"""Whole-batch speculative-decoding engine, greedy verification (PyTorch).

Counterpart of the JAX package's ``serving/engine.py`` for the contiguous
KV layout and whole-batch serving (``Engine.prefill`` / ``step`` / ``run``).
Three drafter modes:

  "parallel" — P-EAGLE: one drafter forward drafts K tokens
  "ar"       — AR EAGLE-3 baseline: K sequential drafter forwards
  "none"     — vanilla autoregressive decoding (one target forward a token)

Every mode emits the target's greedy output: drafts only decide how many
tokens one verify forward commits. The decode state has the JAX engine's
leaves except the per-slot sampling policy (sampled verification is not
ported yet); KV caches inside it are updated in place by each step. The
paged layout, the scheduler, sampling and sharding are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import DrafterConfig, ModelConfig
from repro_torch.core import drafter as D
from repro_torch.core import spec_decode as SD
from repro_torch.models.registry import get_model
from repro_torch.serving import cache_ops

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
      max_new_tokens: generation budget per row, the first token included.
      drafter_mode: "parallel", "ar" or "none".
      cache_dtype: KV cache and taps dtype ("bfloat16" on the card).
      max_len: cache positions per row; prompt + max_new_tokens + K must fit.
    """
    K: int = 5
    max_new_tokens: int = 64
    drafter_mode: str = "parallel"
    cache_dtype: str = "float32"
    max_len: int = 512

    def __post_init__(self):
        if self.drafter_mode not in DRAFTER_MODES:
            raise ValueError(f"unknown drafter_mode {self.drafter_mode!r}")


def make_decode_state(model, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                      ecfg: EngineConfig, batch: int, *, device) -> dict:
    """The decode-state skeleton: the JAX engine's leaves (minus the
    sampling policy), on ``device``. ``new_count`` starts at 1: prefill
    commits the first generated token."""
    cdt = getattr(torch, ecfg.cache_dtype)
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
        "tcache": model.make_cache(batch, ecfg.max_len, dtype=cdt,
                                   device=device),
        "new_count": torch.ones((batch,), **i32),
        "slot_iters": torch.zeros((batch,), **i32),
        "iters": torch.zeros((), **i32),
        "row_iters": torch.zeros((), **i32),
        "committed": torch.zeros((), **i32),
    }
    if ecfg.drafter_mode != "none":
        state["dcache"] = D.make_cache(dcfg, batch, ecfg.max_len, dtype=cdt,
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
    """Whole-batch greedy speculative-decoding engine over ``batch`` rows.

    Args:
      tcfg / dcfg: target and drafter configs (dcfg None for mode "none").
      tparams / dparams: parameter trees (``models.transformer`` /
        ``core.drafter`` layout), moved to ``device``.
      ecfg: static engine configuration.
      batch: rows per batch.
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

    def prefill(self, prompts) -> dict:
        """Whole-batch prefill of ``prompts`` (B, P): a fresh decode state
        committing the first generated token (the target argmax) per row."""
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
        with torch.no_grad():
            state = make_decode_state(self.model, self.tcfg, self.dcfg,
                                      self.ecfg, B, device=self.device)
            out = self.model.forward(self.tparams, prompts, mode="prefill",
                                     cache=state["tcache"], collect_taps=True,
                                     head_last_only=True)
            last_logits = out.logits[:, -1]
            first = last_logits.argmax(-1).to(torch.int32)
            state["tokens"][:, :P] = prompts
            state["tokens"][:, P] = first
            state["logprobs"][:, P] = _token_logprob(last_logits, first)
            state["last"].fill_(P)
            state["taps_last"] = out.taps[:, -1].contiguous()
            state["tcache"] = out.cache
            if self.ecfg.drafter_mode != "none" and P > 1:
                pos = torch.arange(P - 1, dtype=torch.int32,
                                   device=self.device)[None].repeat(B, 1)
                state["dcache"] = D.extend(self.dcfg, self.tcfg, self.dparams,
                                           state["dcache"], prompts[:, 1:],
                                           out.taps[:, -P:-1], pos)
        return state

    def step(self, state: dict) -> dict:
        """One speculative iteration over the whole batch."""
        with torch.no_grad():
            return speculative_step(self.model, self.tcfg, self.dcfg,
                                    self.ecfg, self.tparams, self.dparams,
                                    state)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, prompts, max_iters: int = 10_000) -> Dict[str, Any]:
        """Prefill, then step until every row has its ``max_new_tokens``
        (checked every 8 steps, as the JAX engine does). ``steps`` counts
        the step calls, ``iterations`` those in which some row was live."""
        t0 = time.perf_counter()
        state = self.prefill(prompts)
        self._sync()
        t_prefill = time.perf_counter() - t0

        steps = 0
        t0 = time.perf_counter()
        while steps < max_iters:
            state = self.step(state)
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


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def speculative_step(model, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                     ecfg: EngineConfig, tparams, dparams, state: dict) -> dict:
    """One iteration: draft K -> verify K+1 -> accept -> commit (greedy).

    Rows that have their ``max_new_tokens`` are frozen: they commit
    nothing and keep last/taps/counters. The caches of ``state`` are
    updated in place; the returned state holds them."""
    B = state["tokens"].shape[0]
    K = ecfg.K if ecfg.drafter_mode != "none" else 0
    c = state["last"]
    tok_next = state["tokens"].gather(1, c[:, None].long())[:, 0]
    dcache = state.get("dcache")

    if ecfg.drafter_mode == "parallel":
        drafts, _, dcache = D.draft_parallel(dcfg, tcfg, dparams, dcache,
                                             tok_next, state["taps_last"],
                                             c - 1, K)
    elif ecfg.drafter_mode == "ar":
        drafts, _, dcache = D.draft_ar(dcfg, tcfg, dparams, dcache, tok_next,
                                       state["taps_last"], c - 1, K)
    else:
        drafts = torch.zeros((B, 0), dtype=torch.int32, device=c.device)

    # target verify over [t_last, d_1..d_K] at positions c..c+K
    vt = torch.cat([tok_next[:, None], drafts], dim=1)
    positions = c[:, None] + torch.arange(K + 1, dtype=torch.int32,
                                          device=c.device)[None]
    tout = model.forward(tparams, vt, mode="decode", positions=positions,
                         cache=state["tcache"],
                         collect_taps=ecfg.drafter_mode != "none")
    if K == 0:
        accept_len = torch.zeros((B,), dtype=torch.int32, device=c.device)
        t_star = tout.logits.argmax(-1).to(torch.int32)
    else:
        accept_len, t_star = SD.greedy_verify(drafts, tout.logits)

    active = state["new_count"] < ecfg.max_new_tokens
    accept_len = torch.where(active, accept_len, 0)

    # invalidate the target cache past the last accepted token
    tcache = cache_ops.commit(tout.cache, c + accept_len)

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
                                       tout.taps, positions)

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
    )
    return new_state

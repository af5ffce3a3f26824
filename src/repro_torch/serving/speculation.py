"""Adaptive speculation controller: per-request dynamic draft length.

Counterpart of the JAX package's ``serving/speculation.py``; host-side,
its aggregate kept by the port's ``core/spec_decode.update_acceptance_stats``.

The engine speculates ``EngineConfig.K`` tokens per iteration for every
row. That is the right depth for "easy" streams (high drafter/target
agreement) and pure waste for "hard" ones — each unaccepted draft slot
costs a target verify position, and under the paged layout it also costs
page headroom (``_grow`` reserves ``sync_every * (k + 1)`` positions per
growth quantum), which on a tight pool turns into preemptions.

:class:`SpeculationController` closes that loop host-side. It is keyed by
REQUEST id, not slot: the per-request acceptance state survives
preemption/resume exactly like the request's token stream does, and every
update is derived only from the request's own committed-token deltas — so
the ``k_row`` sequence a request sees is a pure function of its own
stream, never of batch composition, slot index, layout, or mesh. That is
what keeps the streamed ≡ virtual-twin and composition-invariance pins
intact with the controller enabled.

The decision is applied as a max-K mask: ``k_row`` (B,) int32 is an
argument of the step (``Engine.step(..., k_row=...)``), a tensor, so
varying depth per row per iteration changes no shape. Slots at or beyond
``k_row`` are force-rejected inside verification with the proposal mass
zeroed there — lossless by construction (core/spec_decode.py).

Controller state machine, per request:

1. admission  → ``k_row = k_for(rid)``; a fresh rid starts OPTIMISTIC
   (``ema = K + 1`` ⇒ full-depth speculation) so easy streams never pay a
   ramp-up and the first harvest already measures true acceptance.
2. harvest    → ``observe(rid, d_tok, d_it)`` folds the delta
   (``d_tok`` committed tokens over ``d_it`` iterations) into the running
   aggregate (``core.spec_decode.update_acceptance_stats``,
   with the active mask and iteration weights — the controller is a
   caller of the shared machinery, not a fork of it) and into an
   n-step-decayed EMA; the slot's ``k_row`` is refreshed from the EMA.
   Zero-iteration deltas (idle/frozen slots) are skipped entirely.
3. preemption → state is simply kept (rid-keyed); the resume admission
   re-reads ``k_for(rid)`` and continues where the stream left off.
4. finish     → ``finish(rid)`` freezes the final stats for telemetry
   and releases the live entry.

The policy itself is deliberately boring: speculate one slot past the
EMA's accepted-draft estimate, clipped to ``[k_min, K]``. Boring is a
feature — a monotone function of a deterministic statistic is what the
reproducibility pins require.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import spec_decode as SD


@dataclass(frozen=True)
class SpeculationConfig:
    """Knobs of the adaptive-K controller.

    Attributes:
      k_min: floor of the per-row draft length — never speculate less
        than this (1 keeps every row speculative; 0 would degrade a row
        to vanilla AR decoding inside a drafter-mode engine).
      ema_decay: per-ITERATION decay of the acceptance-length EMA; a
        harvest delta spanning ``n`` iterations is folded with weight
        ``1 - ema_decay**n``, so the EMA's horizon is measured in engine
        iterations, not in harvest boundaries (which depend on
        ``sync_every`` and would otherwise leak pacing into the policy).
      headroom: extra draft slots granted past the EMA's accepted-draft
        estimate — the explore margin that lets a stream climb back to
        deep speculation when its acceptance recovers.
    """
    k_min: int = 1
    ema_decay: float = 0.8
    headroom: int = 1

    def __post_init__(self):
        if self.k_min < 0:
            raise ValueError(f"k_min must be >= 0, got {self.k_min!r}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in (0, 1), got {self.ema_decay!r}")
        if self.headroom < 0:
            raise ValueError(
                f"headroom must be >= 0, got {self.headroom!r}")


class SpeculationController:
    """Host-side per-request dynamic-K policy (see module docstring).

    Args:
      K: the engine's static speculation depth — the ceiling of every
        ``k_row`` decision.
      cfg: policy knobs; ``None`` uses the defaults.
    """

    def __init__(self, K: int, cfg: Optional[SpeculationConfig] = None):
        self.K = int(K)
        self.cfg = cfg if cfg is not None else SpeculationConfig()
        # rid -> {"stats": running aggregate, "ema": float, "k": int}
        self._live: Dict[int, dict] = {}
        self._done: Dict[int, dict] = {}

    # -- state machine -------------------------------------------------
    def _entry(self, rid: int) -> dict:
        e = self._live.get(rid)
        if e is None:
            # optimistic init: full-depth speculation until measured
            e = {"stats": {}, "ema": float(self.K + 1), "k": self.K}
            self._live[rid] = e
        return e

    def observe(self, rid: int, d_tok: int, d_it: int) -> None:
        """Fold a harvest delta — ``d_tok`` committed tokens over ``d_it``
        engine iterations — into the request's acceptance state.

        ``d_it == 0`` deltas are skipped: an idle/frozen slot carries no
        acceptance information, and crediting it iterations is exactly the
        deflation bug ``update_acceptance_stats(active=...)`` guards
        against."""
        if d_it <= 0:
            return
        e = self._entry(rid)
        # shared aggregate machinery: accept_len = accepted DRAFTS over
        # the window, weighted as d_it iterations, explicitly active
        e["stats"] = SD.update_acceptance_stats(
            e["stats"], torch.tensor([d_tok - d_it], dtype=torch.int64),
            active=torch.tensor([True]),
            iters=torch.tensor([d_it], dtype=torch.int64))
        al = d_tok / d_it                       # window acceptance length
        w = self.cfg.ema_decay ** d_it          # n-step decay
        e["ema"] = w * e["ema"] + (1.0 - w) * al
        e["k"] = self._decide(e["ema"])

    def _decide(self, ema: float) -> int:
        # accepted drafts per iteration = AL - 1; speculate `headroom`
        # past the (rounded) estimate, clipped into [k_min, K]
        est = int(round(ema - 1.0))
        return int(np.clip(est + self.cfg.headroom,
                           min(self.cfg.k_min, self.K), self.K))

    def k_for(self, rid: int) -> int:
        """The draft length to run ``rid`` at — admission and every
        harvest read this; a never-observed rid gets the optimistic K."""
        return self._entry(rid)["k"]

    def finish(self, rid: int) -> None:
        """Freeze ``rid``'s final state for telemetry and drop the live
        entry (abort/finish both land here; a forgotten rid is a no-op)."""
        e = self._live.pop(rid, None)
        if e is not None:
            self._done[rid] = e

    # -- telemetry -----------------------------------------------------
    def request_report(self, rid: int) -> dict:
        """Per-request telemetry: final k, EMA, and the running-aggregate
        acceptance length over every observed iteration."""
        e = self._done.get(rid) or self._live.get(rid)
        if e is None:
            return {"k_final": self.K, "ema": float(self.K + 1),
                    "observed_iters": 0, "acceptance_length": 0.0}
        stats = e["stats"]
        return {
            "k_final": e["k"],
            "ema": e["ema"],
            "observed_iters": int(stats.get("iters", 0)),
            "acceptance_length": (SD.acceptance_length(stats)
                                  if stats else 0.0),
        }

    def report(self) -> dict:
        """Controller-level telemetry for scheduler reports."""
        entries = list(self._done.values()) + list(self._live.values())
        ks = [e["k"] for e in entries]
        return {
            "requests": len(entries),
            "mean_k": float(np.mean(ks)) if ks else float(self.K),
            "min_k": int(min(ks)) if ks else self.K,
            "max_k": int(max(ks)) if ks else self.K,
        }

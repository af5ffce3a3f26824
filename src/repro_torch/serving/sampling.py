"""Per-request decoding policy: :class:`SamplingParams` and its batch form
in the decode state (PyTorch).

Counterpart of the JAX package's ``serving/sampling.py``. Every request
carries its own ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` /
``stop_token_ids`` / ``max_new_tokens``; ``temperature == 0`` is greedy.

Key streams: the key of the operation that determines the token(s)
starting at cache position ``pos`` is ``fold_in(PRNGKey(seed), pos)``,
re-derived from the base key every step (nothing is split and carried). A
sampled continuation is then a pure function of ``(seed, committed
prefix)``: the same across runs, batch compositions, slot indices, KV
layouts and recompute preemption. The threefry words are the JAX
package's, bit for bit (``repro_torch.prng``), so a seeded stream is the
reference's stream.

The batch form lives in the decode state as its ``"sampling"`` subtree of
per-slot tensors, batch first, so admission writes a request's policy into
its slot with ``cache_ops.write_slot`` like every other per-slot leaf, and
a freed slot's row is zero, :func:`blank_sampling_state`'s row.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import prng

Tensor = torch.Tensor


@dataclass(frozen=True)
class SamplingParams:
    """Decoding policy of one request (immutable, hashable).

    Attributes:
      temperature: softmax temperature; ``0.0`` is greedy (argmax, no
        randomness consumed); ``>= 0`` and finite.
      top_k: keep the ``top_k`` highest logits (``0`` disables); ties at
        the k-th value are all kept.
      top_p: nucleus mass in ``(0, 1]`` (``1.0`` disables).
      seed: base of the request's key stream.
      stop_token_ids: tokens that end the request (inclusive), beside the
        scheduler's ``eos_id``.
      max_new_tokens: the request's budget; None defers to
        ``Request.max_new_tokens``, then the engine's default.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    max_new_tokens: Optional[int] = None

    def __post_init__(self):
        if not (self.temperature >= 0.0 and math.isfinite(self.temperature)):
            raise ValueError(f"temperature must be >= 0 and finite, got "
                             f"{self.temperature!r}")
        if not isinstance(self.top_k, int) or self.top_k < 0:
            raise ValueError(f"top_k must be an int >= 0, got {self.top_k!r}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p!r}")
        if not isinstance(self.seed, int):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens!r}")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))

    @property
    def is_greedy(self) -> bool:
        """Greedy rows take the argmax verify path and consume no keys."""
        return self.temperature == 0.0

    @classmethod
    def greedy(cls, **kw) -> "SamplingParams":
        return cls(temperature=0.0, **kw)

    def base_key(self, device=None) -> Tensor:
        """(2,) int64 base key of this request's stream."""
        return prng.PRNGKey(self.seed, device=device)


def batch_sampling_state(sp: SamplingParams, batch: int, *,
                         device=None) -> dict:
    """The ``"sampling"`` subtree with every slot holding ``sp``."""
    return {
        "temperature": torch.full((batch,), sp.temperature,
                                  dtype=torch.float32, device=device),
        "top_k": torch.full((batch,), sp.top_k, dtype=torch.int32,
                            device=device),
        "top_p": torch.full((batch,), sp.top_p, dtype=torch.float32,
                            device=device),
        "key": sp.base_key(device)[None].repeat(batch, 1),
    }


def blank_sampling_state(batch: int, *, device=None) -> dict:
    """The all-zero policy rows of blank or freed slots: temperature 0 keeps
    a row greedy; top_p 0 is harmless (the warp always keeps the top-1
    token), and admission overwrites the row before the slot is live."""
    return {
        "temperature": torch.zeros((batch,), dtype=torch.float32,
                                   device=device),
        "top_k": torch.zeros((batch,), dtype=torch.int32, device=device),
        "top_p": torch.zeros((batch,), dtype=torch.float32, device=device),
        "key": torch.zeros((batch, 2), dtype=torch.int64, device=device),
    }


def step_keys(samp: dict, pos) -> Tensor:
    """(B, 2) keys of the operation that determines the token(s) at cache
    position ``pos`` (an int or (B,)): ``fold_in(base key, pos)``."""
    return prng.fold_in(samp["key"], pos)


# Separates the draft key stream from the verify stream at the same
# position: drafting folds this constant in first (the JAX package's value).
DRAFT_SALT = 0x5EED_D12A


def draft_keys(samp: dict, pos, K: int) -> Tensor:
    """(B, K, 2) keys for sampling K drafts at committed position ``pos``:
    ``split(fold_in(step_keys(samp, pos), DRAFT_SALT), K)``."""
    return prng.split(prng.fold_in(step_keys(samp, pos), DRAFT_SALT), K)

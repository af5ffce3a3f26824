"""The one traffic generator: a mix's parameters (a data file under
``bench/traffic``) and a seed in, the requests out.

Every seed gets the same multiset of sizes and gaps, the mid-quantiles
of the mix's laws, in an order the seed shuffles, and its own token ids
(uniform over the vocabulary but its last id, the drafter's mask token).
So two seeds do the same work in another order (see ``closed_plan`` and
``open_plan`` for what "order" is in each loop).

Keys of a mix:

- ``loop``: "closed" (``clients`` callers, each sending its next request
  when its stream ends) or "open" (arrivals at ``rate_per_s``, Poisson
  gaps, whatever the system does; the window holds rate x seconds of them
  in every run);
- ``prompt_len``, ``output_len``: inclusive [lo, hi] of log-uniform laws;
- ``residual_first`` (closed): each client's first request takes a budget
  drawn uniformly below its drawn one, as if the run had joined a steady
  stream of requests already in flight;
- ``pool`` (closed): requests drawn a client chain is cut from;
- ``lead_s`` (open): seconds of arrivals before the window opens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from bench.lib.common import exponential_quantiles, log_uniform_quantiles


@dataclass
class Spec:
    prompt: np.ndarray
    budget: int
    due: float = 0.0          # open loop: seconds after the schedule starts


def _shuffled(values, rng) -> list:
    values = list(values)
    rng.shuffle(values)
    return values


def _prompts(lens, vocab: int, rng) -> List[np.ndarray]:
    return [rng.integers(0, vocab - 1, int(n)).astype(np.int32) for n in lens]


def closed_plan(mix: dict, seed: int, vocab: int) -> List[List[Spec]]:
    """Each client's chain of requests, first request first. The chains'
    sizes are the same for every seed (one fixed shuffle of the
    quantiles): clients are alike, so the seed only deals the chains out
    to them, in another order, and draws the token ids. The window then
    holds the same work whatever the seed: which requests are in flight
    while it is open sets the cost of an iteration."""
    base = np.random.default_rng(0)
    rng = np.random.default_rng(int(seed))
    n, clients = int(mix["pool"]), int(mix["clients"])
    lens = _shuffled(log_uniform_quantiles(*mix["prompt_len"], n), base)
    outs = _shuffled(log_uniform_quantiles(*mix["output_len"], n), base)
    frac = _shuffled([(i + 0.5) / clients for i in range(clients)], base)
    deal = rng.permutation(clients)
    chains: List[List[Spec]] = [[] for _ in range(clients)]
    for c in range(clients):
        for i in range(c, n, clients):
            budget = outs[i]
            if i < clients and mix.get("residual_first"):
                budget = max(1, math.ceil(frac[c] * budget))
            prompt = rng.integers(0, vocab - 1, lens[i]).astype(np.int32)
            chains[deal[c]].append(Spec(prompt, int(budget)))
    return chains


def _segment(mix: dict, rng, vocab: int, start: float, span: float,
             n: int) -> List[Spec]:
    """``n`` arrivals in [start, start + span): Poisson gaps (their
    mid-quantiles, shuffled, scaled to fill the span) and sizes."""
    if n <= 0:
        return []
    gaps = _shuffled(exponential_quantiles(1.0, n), rng)
    scale = span / sum(gaps)
    lens = _shuffled(log_uniform_quantiles(*mix["prompt_len"], n), rng)
    outs = _shuffled(log_uniform_quantiles(*mix["output_len"], n), rng)
    prompts = _prompts(lens, vocab, rng)
    due = start + scale * np.cumsum([0.0] + gaps[:-1])
    return [Spec(p, int(b), due=float(t))
            for p, b, t in zip(prompts, outs, due)]


def open_plan(mix: dict, seed: int, vocab: int, seconds: float) -> List[Spec]:
    """Requests in arrival order, ``due`` from the schedule's start: the
    lead's arrivals, then the window's, ``rate_per_s`` times its seconds of
    them (every seed the same count and sizes in the window)."""
    rng = np.random.default_rng(int(seed))
    rate = float(mix["rate_per_s"])
    lead = float(mix.get("lead_s", 0.0))
    return (_segment(mix, rng, vocab, 0.0, lead, round(rate * lead))
            + _segment(mix, rng, vocab, lead, seconds, round(rate * seconds)))


def buckets(mix: dict) -> List[int]:
    """The admission prefill's power-of-two buckets the mix's prompts
    fall in (the shapes a run warms up)."""
    lo, hi = mix["prompt_len"]
    b = 1 << max(lo - 1, 0).bit_length()
    out = []
    while True:
        out.append(b)
        if b >= hi:
            return out
        b *= 2

"""The port's adaptive speculation on the CPU, against the JAX package's.

``SpeculationController``: the same ``observe`` calls give the same
``k_row`` sequence and reports as the JAX controller's, for several
configurations. In the engine a ``k_row`` of K is the identity, bitwise,
on both verification lanes. Served with ``adaptive_k``, on drafts the
target accepts for some requests and not for others (so the controller
keeps some rows deep and drives others to ``k_min``), under a pool that
preempts: tokens, events, ``k_final`` per request and the ``speculation``
report equal the JAX scheduler's, and the tokens equal a fixed-K serve.

The reduced qwen2-1.5b in float32 (``torch_serving_setup``), K 3."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import drafter as JD
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving.speculation import SpeculationConfig as JSpeculationConfig
from repro.serving.speculation import \
    SpeculationController as JSpeculationController
from repro_torch.core import drafter as D
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.speculation import (SpeculationConfig,
                                             SpeculationController)
from repro_torch.tree import leaves_with_paths
from torch_serving_setup import (MAX_LEN, assert_same_serve, jax_engine,
                                 models, port_engine)
import torch_threads  # noqa: F401  (torch threads per xdist worker)

K = 3
CONFIGS = [{}, dict(k_min=2, ema_decay=0.5, headroom=0),
           dict(k_min=0, ema_decay=0.9, headroom=2)]


@pytest.mark.parametrize("knobs", CONFIGS, ids=str)
def test_controller_matches_jax_controller(knobs):
    """Random harvest deltas over interleaved requests, idle windows and a
    finish included: every ``k_for``, ``request_report`` and ``report``
    equals the JAX controller's."""
    rng = np.random.default_rng(4)
    ours = SpeculationController(5, SpeculationConfig(**knobs))
    ref = JSpeculationController(5, JSpeculationConfig(**knobs))
    seen = []
    for step in range(60):
        rid = int(rng.integers(0, 4))
        d_it = int(rng.integers(0, 4))
        d_tok = d_it + int(rng.integers(0, 5 * d_it + 1))
        for c in (ours, ref):
            c.observe(rid, d_tok, d_it)
        seen.append((ours.k_for(rid), ref.k_for(rid)))
        if step == 40:
            ours.finish(1)
            ref.finish(1)
        assert ours.request_report(rid) == ref.request_report(rid)
    assert [a for a, _ in seen] == [b for _, b in seen]
    assert len({a for a, _ in seen}) > 1        # the policy moved
    assert ours.report() == ref.report()


def test_speculation_config_validation():
    SpeculationConfig(k_min=1, ema_decay=0.5, headroom=0)
    for bad in (dict(k_min=-1), dict(ema_decay=0.0), dict(ema_decay=1.0),
                dict(headroom=-1)):
        with pytest.raises(ValueError):
            SpeculationConfig(**bad)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_k_row_of_k_is_the_identity(sampled):
    """One step with ``k_row`` K equals one without, bitwise, on the
    greedy-only lane and on the sampled lane."""
    eng = port_engine(K=K)
    state = eng.blank_state()
    rng = np.random.default_rng(6)
    for slot in range(2):
        sp = (SamplingParams(temperature=0.8, seed=slot)
              if sampled and slot else None)
        state, _, _ = eng.prefill_into_slot(
            state, rng.integers(1, 200, 7 + slot).astype(np.int32), slot,
            max_new=8, sampling=sp)
    for slot in range(2):
        eng.ensure_capacity(state, slot, 7 + slot + 2 * (K + 1))
    twin = copy.deepcopy(state)
    a = eng.step(state, max_new=[8, 8],
                 k_row=torch.full((2,), K, dtype=torch.int32))
    b = eng.step(twin, max_new=[8, 8])
    for (path, x), (_, y) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path


def _workload(vocab):
    rng = np.random.default_rng(9)
    return [(rng.integers(1, 200, int(n)).astype(np.int32), int(b),
             float(t))
            for n, b, t in zip(rng.integers(6, 11, 4),
                               rng.integers(10, 17, 4),
                               np.cumsum(rng.exponential(1.0, 4)))]


def _oracle_table(streams, vocab, seed=5, spoil=0.2):
    """(vocab, MAX_LEN, K) drafts keyed by (next token, anchor): for the
    even requests' greedy streams, the K tokens that follow, a seeded
    fifth of them spoiled; every other key drafts token 0. The target
    accepts the even requests' drafts up to a spoiled one and almost
    never the rest."""
    rng = np.random.default_rng(seed)
    table = np.zeros((vocab, MAX_LEN, K), np.int32)
    for s in streams[::2]:
        for c in range(1, len(s) - 1):
            nxt = s[c + 1:c + 1 + K]
            nxt = np.pad(nxt, (0, K - len(nxt)))
            bad = rng.random(K) < spoil
            table[s[c], c - 1] = np.where(bad, (nxt + 1) % (vocab - 1), nxt)
    return table


def _jax_oracle(fn, table):
    table = jnp.asarray(table)

    def draft(*args, **kw):
        _, logits, cache = fn(*args, **kw)
        tok, anchor = args[4], args[6]
        return table[tok, jnp.clip(anchor, 0, MAX_LEN - 1)], logits, cache
    return draft


def _torch_oracle(fn, table):
    table = torch.from_numpy(table)

    def draft(*args, **kw):
        _, logits, cache = fn(*args, **kw)
        tok, anchor = args[4], args[6]
        return (table[tok.long(), anchor.clamp(0, MAX_LEN - 1).long()],
                logits, cache)
    return draft


def test_adaptive_serve_matches_jax_scheduler():
    """``adaptive_k=True`` under a pool that preempts, on oracle drafts:
    the even requests keep deep rows, the odd ones fall to ``k_min``, and
    tokens, events, ``k_final`` and the ``speculation`` report equal the
    JAX scheduler's; tokens equal the fixed-K serve's."""
    vocab = models()[1][0].vocab_size
    work = _workload(vocab)

    def reqs(cls):
        return [cls(p, max_new_tokens=b, arrival_time=t, rid=i)
                for i, (p, b, t) in enumerate(work)]

    kw = dict(K=K, pool_pages=5)
    fixed = Scheduler(port_engine(**kw)).serve(reqs(Request))
    streams = [np.concatenate([p, r["tokens"]])
               for (p, _, _), r in zip(work, fixed["results"])]
    table = _oracle_table(streams, vocab)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "draft_parallel", _jax_oracle(JD.draft_parallel,
                                                     table))
        mp.setattr(D, "draft_parallel", _torch_oracle(D.draft_parallel,
                                                      table))
        tr = Scheduler(port_engine(**kw), adaptive_k=True).serve(
            reqs(Request))
        jr = JScheduler(jax_engine(**kw), adaptive_k=True).serve(
            reqs(JRequest))
    assert_same_serve(tr, jr, ("speculation", "weighted_acceptance_length"))
    ks = [r["k_final"] for r in tr["results"]]
    assert ks == [r["k_final"] for r in jr["results"]]
    assert max(ks[::2]) > min(ks[1::2]) == 1, ks
    assert tr["preemptions"] >= 1
    assert tr["weighted_acceptance_length"] > 1.2     # drafts accepted
    for got, want in zip(tr["results"], fixed["results"]):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])

"""The port's offline front end and round-based baseline on the CPU,
against the JAX package's.

``LLMEngine.generate`` with a mixed list of ``SamplingParams`` (and with
one for every prompt) returns the JAX ``LLMEngine``'s outputs in prompt
order: tokens exact, logprobs within 3e-5. ``serve_round_based`` gives
the JAX function's ``total_new_tokens``, ``rounds`` and
``mean_acceptance_length`` on a workload whose last round is padded. The
virtual ``Scheduler.serve`` with a running and a queued request aborted
mid-serve equals the JAX scheduler doing the same: tokens, events,
counters, the ``aborted`` marks and count.

The reduced qwen2-1.5b in float32 (``torch_serving_setup``); each JAX run
is made once per module."""
from functools import lru_cache

import numpy as np
import pytest

from repro.serving import LLMEngine as JLLMEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import Scheduler as JScheduler
from repro.serving import serve_round_based as jserve_round_based
from repro_torch.serving import (LLMEngine, Request, SamplingParams,
                                 Scheduler, serve_round_based)
from torch_serving_setup import assert_same_serve, jax_engine, port_engine
import torch_threads  # noqa: F401  (torch threads per xdist worker)

PROMPT_SEED = 14


def prompts(n=4):
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(1, 200, size=int(rng.integers(3, 10))).astype(np.int32)
            for _ in range(n)]


def mixed(sp_cls):
    """Greedy (engine default), sampled, greedy with a stop token, sampled
    with top-k and a budget."""
    return [None, sp_cls(temperature=0.8, seed=3),
            sp_cls(stop_token_ids=(7,), seed=1),
            sp_cls(temperature=0.7, top_k=20, seed=9, max_new_tokens=6)]


@lru_cache(maxsize=None)
def jax_paged():
    """One JAX engine (one compile) for the module's paged runs."""
    return jax_engine()


@lru_cache(maxsize=None)
def jax_generate(kind):
    llm = JLLMEngine(jax_paged())
    sp = (mixed(JSamplingParams) if kind == "mixed"
          else JSamplingParams(temperature=0.9, top_p=0.9, seed=4))
    return [(np.asarray(o["tokens"]), np.asarray(o["logprobs"]), o["n_new"])
            for o in llm.generate(prompts(), sp)]


@pytest.mark.parametrize("kind", ["mixed", "one"])
def test_generate_matches_jax_llm_engine(kind):
    llm = LLMEngine(port_engine())
    sp = (mixed(SamplingParams) if kind == "mixed"
          else SamplingParams(temperature=0.9, top_p=0.9, seed=4))
    outs = llm.generate(prompts(), sp)
    want = jax_generate(kind)
    assert len(outs) == len(want)
    for got, (toks, lps, n_new) in zip(outs, want):
        np.testing.assert_array_equal(got["tokens"], toks)
        np.testing.assert_allclose(got["logprobs"], lps, rtol=3e-5,
                                   atol=3e-5)
        assert got["n_new"] == n_new
    assert [r["rid"] for r in outs] == sorted(r["rid"] for r in outs)
    assert llm.last_report["n_requests"] == len(outs)
    if kind == "mixed":
        assert outs[3]["n_new"] == 6          # the policy's own budget
        assert 7 not in outs[2]["tokens"][:-1].tolist()


def test_generate_rejects_a_policy_list_of_another_length():
    with pytest.raises(ValueError, match="sampling_params"):
        LLMEngine(port_engine()).generate(prompts(), [None, None])


# ---------------------------------------------------------------------------
# the round-based baseline
# ---------------------------------------------------------------------------

ROUND_BUDGETS = [4, 9, 3, 12, 6]


def round_prompts():
    rng = np.random.default_rng(15)
    return [rng.integers(1, 200, size=6).astype(np.int32)
            for _ in ROUND_BUDGETS]


@lru_cache(maxsize=None)
def jax_round_based():
    rep = jserve_round_based(jax_engine(kv_layout="contiguous"),
                             round_prompts(), ROUND_BUDGETS)
    return {k: rep[k] for k in ("total_new_tokens", "rounds",
                                "mean_acceptance_length")}


def test_round_based_matches_jax():
    """Five prompts on two slots: three rounds, the last padded with a
    budget-0 copy; tokens counted to each budget, not past it."""
    rep = serve_round_based(port_engine(kv_layout="contiguous"),
                            round_prompts(), ROUND_BUDGETS)
    assert {k: rep[k] for k in jax_round_based()} == jax_round_based()
    assert rep["rounds"] == 3 and rep["total_new_tokens"] == sum(ROUND_BUDGETS)
    assert rep["otps"] > 0 and rep["wall_s"] > 0


# ---------------------------------------------------------------------------
# aborts in the virtual-clock report
# ---------------------------------------------------------------------------

def _abort_at_harvest(sched, n, rids):
    """After the scheduler's ``n``-th harvest, abort the requests of
    ``rids`` (running or queued)."""
    harvest, calls = sched._harvest, [0]

    def hooked():
        harvest()
        calls[0] += 1
        if calls[0] == n:
            live = [r for r in sched._slot_req if r is not None]
            for r in live + list(sched._waiting):
                if r.rid in rids:
                    assert sched._abort(r)
    sched._harvest = hooked


@lru_cache(maxsize=None)
def jax_aborted_serve():
    eng = jax_paged()
    eng.reset_stats()                    # peak pages of this serve alone
    sched = JScheduler(eng)
    _abort_at_harvest(sched, 2, (1, 3))
    return sched.serve([JRequest(p, max_new_tokens=10, rid=i)
                        for i, p in enumerate(prompts())])


def test_serve_report_marks_aborted_requests():
    eng = port_engine()
    sched = Scheduler(eng)
    _abort_at_harvest(sched, 2, (1, 3))
    tr = sched.serve([Request(p, max_new_tokens=10, rid=i)
                      for i, p in enumerate(prompts())])
    jr = jax_aborted_serve()
    assert_same_serve(tr, jr, ("aborted", "mean_acceptance_length",
                               "weighted_acceptance_length"))
    assert tr["aborted"] == 2
    assert [r["aborted"] for r in tr["results"]] == [False, True, False, True]
    assert tr["results"][3]["n_new"] == 0            # aborted while queued
    assert 0 < tr["results"][1]["n_new"] < 10        # aborted mid-stream
    assert [k for _, k, _ in tr["events"]].count("abort") == 2
    assert eng.allocator.n_used == 0 and not any(eng._slot_pages)

"""The traffic generator: the same seed gives the same schedule, sizes in
range, the same work for every seed in another order, residual first
budgets, a fixed count in an open window.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
from pathlib import Path

import numpy as np
import pytest

from bench.lib import common, traffic as TR

BENCH = Path(__file__).resolve().parents[1]
ROLLOUTS = common.load_json(BENCH / "traffic" / "reasoning-rollouts.json")
RAG = common.load_json(BENCH / "traffic" / "rag-long-prompt.json")
V = 151936
SEEDS = [0, 2 ** 31 + 7, 2 ** 40 + 3]


def _sizes(chains):
    return [(int(s.prompt.size), s.budget) for c in chains for s in c]


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_same_seed_same_schedule(seed):
    a = TR.closed_plan(ROLLOUTS, seed, V)
    b = TR.closed_plan(ROLLOUTS, seed, V)
    assert _sizes(a) == _sizes(b)
    assert all(np.array_equal(x.prompt, y.prompt)
               for ca, cb in zip(a, b) for x, y in zip(ca, cb))


def test_closed_every_seed_the_same_chains_dealt_otherwise():
    plans = [TR.closed_plan(ROLLOUTS, s, V) for s in SEEDS]
    chains = [sorted(tuple((int(x.prompt.size), x.budget) for x in c)
                     for c in p) for p in plans]
    assert chains[0] == chains[1] == chains[2]
    # dealt to other clients, with other token ids
    assert _sizes(plans[0]) != _sizes(plans[1])
    assert not np.array_equal(plans[0][0][0].prompt[:8],
                              plans[1][0][0].prompt[:8])


def test_closed_sizes_in_range_and_residual_first():
    chains = TR.closed_plan(ROLLOUTS, 5, V)
    assert len(chains) == ROLLOUTS["clients"]
    lo, hi = ROLLOUTS["prompt_len"]
    olo, ohi = ROLLOUTS["output_len"]
    for c in chains:
        for i, s in enumerate(c):
            assert lo <= s.prompt.size <= hi
            assert s.prompt.dtype == np.int32
            assert 0 <= s.prompt.min() and s.prompt.max() < V - 1
            assert (1 if i == 0 else olo) <= s.budget <= ohi
    # first budgets lie uniformly below a drawn budget: smaller on average
    first = np.mean([c[0].budget for c in chains])
    later = np.mean([s.budget for c in chains for s in c[1:]])
    assert first < 0.7 * later


@pytest.mark.parametrize("seconds", [10.0, 45.0])
def test_open_window_holds_rate_times_seconds(seconds):
    lead = RAG["lead_s"]
    for seed in SEEDS:
        plan = TR.open_plan(RAG, seed, V, seconds)
        due = np.array([s.due for s in plan])
        assert np.all(np.diff(due) > 0)
        inside = (due >= lead) & (due < lead + seconds)
        assert inside.sum() == round(RAG["rate_per_s"] * seconds)
        assert (due < lead).sum() == round(RAG["rate_per_s"] * lead)
        assert due.max() < lead + seconds


def test_open_same_sizes_other_order():
    a = TR.open_plan(RAG, SEEDS[0], V, 45.0)
    b = TR.open_plan(RAG, SEEDS[1], V, 45.0)
    assert (sorted(s.prompt.size for s in a)
            == sorted(s.prompt.size for s in b))
    assert sorted(s.budget for s in a) == sorted(s.budget for s in b)
    assert (sorted(round(s.due, 9) for s in a)
            != sorted(round(s.due, 9) for s in b))
    assert [s.prompt.size for s in a] != [s.prompt.size for s in b]
    lo, hi = RAG["prompt_len"]
    assert all(lo <= s.prompt.size <= hi for s in a)
    # gaps: exponential quantiles, mean 1 / rate
    gaps = np.diff([s.due for s in a if s.due >= RAG["lead_s"]])
    assert np.mean(gaps) == pytest.approx(1 / RAG["rate_per_s"], rel=0.05)


def test_buckets():
    assert TR.buckets(ROLLOUTS) == [128, 256, 512, 1024]
    assert TR.buckets(RAG) == [2048, 4096, 8192]
    assert TR.buckets({"prompt_len": [100, 130]}) == [128, 256]


def test_quantiles():
    q = common.log_uniform_quantiles(128, 1024, 1000)
    assert min(q) >= 128 and max(q) <= 1024
    assert np.median(q) == pytest.approx(np.sqrt(128 * 1024), rel=0.02)
    e = common.exponential_quantiles(0.5, 1000)
    assert np.mean(e) == pytest.approx(0.5, rel=0.02)

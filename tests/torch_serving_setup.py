"""Shared set-up of the port's serving-policy parity tests
(``test_torch_prefix_cache.py``, ``test_torch_swap.py``,
``test_torch_speculation.py``): the reduced qwen2-1.5b (2 layers, d 256)
in float32 with a 1-layer drafter, weights converted from the JAX
package's, and paged engines of both packages on the same geometry (K 2,
max_len 64, page 8, batch 2; the JAX package's own prefix-cache and swap
suites use it)."""
from functools import lru_cache

import jax
import numpy as np

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.serving.engine import Engine, EngineConfig

K, MAX_LEN, PS, BATCH = 2, 64, 8, 2


@lru_cache(maxsize=None)
def models():
    """((jcfg, jdcfg, jparams, jdparams), (tcfg, dcfg, tparams, dparams))."""
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(23))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(24))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    return (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp)


def ecfg(**kw) -> dict:
    base = dict(K=K, max_new_tokens=16, drafter_mode="parallel",
                max_len=MAX_LEN, kv_layout="paged", page_size=PS)
    base.update(kw)
    return base


def port_engine(batch=BATCH, **kw) -> Engine:
    tcfg, dcfg, tp, dp = models()[1]
    return Engine(tcfg, dcfg, tp, dp, EngineConfig(**ecfg(**kw)), batch,
                  device="cpu")


def jax_engine(batch=BATCH, **kw) -> JEngine:
    jcfg, jdcfg, jp, jdp = models()[0]
    return JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(**ecfg(**kw)), batch)


def shared_preamble(pre_len, tails, seed=0):
    """Prompts sharing a ``pre_len``-token preamble, each with its own
    random tail (a system prompt and a user turn)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 200, pre_len).astype(np.int32)
    return [np.concatenate([pre, rng.integers(1, 200, t).astype(np.int32)])
            for t in tails]


def preempt_workload(seed=3):
    """Three 6-token prompts, budgets 14, 14, 8: a pool of 5 pages holds
    both first claims but not both grown requests, so one is evicted."""
    rng = np.random.default_rng(seed)
    return ([rng.integers(1, 200, size=6).astype(np.int32)
             for _ in range(3)], [14, 14, 8])


def assert_same_serve(tr, jr, keys=()):
    """Per request tokens, n_new, iters, n_preempt, n_swap and
    cached_tokens equal, logprobs within 3e-5; the event trace and the
    report's ``keys`` equal; and the report has the reference's keys."""
    assert set(tr) == set(jr)
    assert len(tr["results"]) == len(jr["results"])
    for t, j in zip(tr["results"], jr["results"]):
        assert set(t) == set(j)
        assert t["rid"] == j["rid"]
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
        for key in ("n_new", "iters", "n_preempt", "n_swap",
                    "cached_tokens"):
            assert t[key] == j[key], (t["rid"], key)
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], atol=3e-5,
                                   rtol=3e-5)
    assert tr["events"] == [tuple(e) for e in jr["events"]]
    for key in ("iterations", "makespan_vt", "preemptions", "peak_pages",
                "total_new_tokens") + tuple(keys):
        assert tr[key] == jr[key], key

"""The port's serving stack over several ranks on the CPU (spawned ``gloo``
ranks joined over a file rendezvous, one torch thread each, killed at a
deadline of their own: ``tests/torch_sharding_child.py``).

- The leaf-by-leaf build: ``build_engine(shard_model=True)`` draws each
  leaf once and keeps this rank's slice (``sharding.rules.draw_sharded``).
  At worlds 2 and 4, for qwen2-1.5b, llama4-maverick (4 layers: its first
  global NoPE layer is the fourth) and mamba2-780m reduced, every slice is
  bitwise ``shard_tree`` of the unsharded build's tree for the seed, and
  no full leaf outlives its cut. llama4's sharded engine serves the JAX
  engine's tokens on the same weights (the port's draw, carried into the
  JAX package's layout).
- ``AsyncEngine`` over the storage-sharded engine at worlds 2 and 4
  (qwen2-1.5b reduced, the JAX package's weights): rank 0 streams greedy
  and seeded-sampled requests at wall-clock gaps and aborts one mid-stream;
  the other ranks follow rank 0's records. Every rank's session holds the
  same tokens, and rank 0's streams are the JAX twin's (the aborted one a
  prefix of it).
- A failure of rank 0's front end mid-session ends every rank: the next
  record carries it, and each follower raises within the deadline.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import virtual_twin_report as jvirtual_twin_report
from repro_torch import convert
from repro_torch.launch.serve import build_engine
from repro_torch.serving import SamplingParams
from test_torch_moe import LLAMA4, _cfg
from torch_serving_setup import ecfg, jax_engine, models
import torch_threads  # noqa: F401  (torch threads per xdist worker)
import torch_sharding_child as child

# build_engine's geometry for the leaf-by-leaf cases
BUILD = dict(K=2, max_new=8, max_len=64, batch=2, seed=3)
LEAFWISE = {"qwen2-1.5b": None, LLAMA4: 4, "mamba2-780m": None}


# ---------------------------------------------------------------------------
# the leaf-by-leaf build
# ---------------------------------------------------------------------------

def _jax_layout(port, template, stacked):
    """The port's tree ``port`` in the JAX package's layout, dtypes and
    shapes of ``template``: ``stacked(path)`` names, for a leaf of the
    JAX tree, the port layers it stacks ([(None, port path)] for one
    unstacked leaf)."""
    def get(tree, path):
        for k in path:
            tree = tree[int(k) if isinstance(tree, list) else k]
        return tree.float().numpy()

    def fill(t, path):
        if isinstance(t, dict):
            return {k: fill(v, path + (k,)) for k, v in t.items()}
        src = stacked(path)
        arr = (get(port, src[0][1]) if src[0][0] is None
               else np.stack([get(port, p) for _, p in src]))
        assert arr.shape == t.shape, (path, arr.shape, t.shape)
        return jnp.asarray(arr, dtype=t.dtype)
    return fill(template, ())


@lru_cache(maxsize=None)
def llama4_reference():
    """The prompts and the JAX engine's tokens for them on llama4 reduced
    at 4 layers, on the weights ``build_engine`` draws unsharded for the
    seed (carried into the JAX layout: its super-block of 4 stacked along
    a leading axis of 1, the drafter's layers along axis 0)."""
    jcfg = _cfg(jget_config, LLAMA4, 4, "reduced")
    jdcfg = JDrafterConfig().resolve(jcfg)
    eng = build_engine(arch=LLAMA4, reduced=True, n_layers=4, device="cpu",
                       **BUILD)
    period = convert._period(eng.tcfg)
    n_sb = eng.tcfg.n_layers // period

    def target(path):
        if path[0] == "blocks":
            i = int(path[1][len("slot"):])
            return [(sb, ("blocks", sb * period + i) + path[2:])
                    for sb in range(n_sb)]
        if path[0] == "tail":
            i = int(path[1][len("slot"):])
            return [(None, ("blocks", n_sb * period + i) + path[2:])]
        return [(None, path)]

    def drafter(path):
        if path[0] == "blocks":
            return [(li, ("blocks", li) + path[1:])
                    for li in range(len(eng.dparams["blocks"]))]
        return [(None, path)]
    jp = _jax_layout(eng.tparams, jget_model(jcfg).init(
        jax.random.PRNGKey(0)), target)
    jdp = _jax_layout(eng.dparams, JD.init_params(
        jdcfg, jcfg, jax.random.PRNGKey(1)), drafter)
    prompts = np.random.default_rng(5).integers(1, 1000, (2, 20)) \
        .astype(np.int32)
    jeng = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(
        K=BUILD["K"], max_new_tokens=BUILD["max_new"],
        max_len=BUILD["max_len"], cache_dtype="float32"), BUILD["batch"])
    return prompts, np.asarray(jeng.run(jnp.asarray(prompts))["tokens"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", list(LEAFWISE),
                         ids=[a.split("-")[0] for a in LEAFWISE])
def test_leafwise_build_equals_whole_draw(arch, world, tmp_path):
    """``build_engine(shard_model=True)`` over ``world`` gloo ranks: each
    rank's slices bitwise ``shard_tree`` of the unsharded build's trees,
    each drawn leaf freed once cut; llama4's tokens the JAX engine's."""
    kw = dict(BUILD, arch=arch, reduced=True, n_layers=LEAFWISE[arch])
    prompts, expected = (llama4_reference() if arch == LLAMA4
                         else (None, None))
    child.spawn(child.leafwise_child, world, tmp_path, kw, prompts, expected,
                timeout=120)


# ---------------------------------------------------------------------------
# AsyncEngine over several ranks
# ---------------------------------------------------------------------------

# a 5-page pool on 2 slots preempts; request ABORT_AT is aborted after its
# second token
POOL, ABORT_AT = 5, 2


def _workload(sp_cls):
    """Six requests of 3-8 tokens, budgets 6-12, odd ones sampled."""
    rng = np.random.default_rng(11)
    return [(rng.integers(1, 200, int(rng.integers(3, 9))).astype(np.int32),
             None if i % 2 == 0 else sp_cls(temperature=0.8, seed=60 + i),
             int(rng.integers(6, 13))) for i in range(6)]


@lru_cache(maxsize=None)
def async_case():
    """The ranks' setup (the reduced qwen2's converted weights, a paged
    engine that preempts), the workload, its wall-clock gaps and the JAX
    twin's tokens."""
    tcfg, dcfg, tp, dp = models()[1]
    setup = (tcfg, dcfg, tp, dp, ecfg(pool_pages=POOL), 2)
    twin = jvirtual_twin_report(jax_engine(pool_pages=POOL),
                                _workload(JSamplingParams))
    gaps = np.random.default_rng(12).exponential(0.02, 6)
    return (setup, _workload(SamplingParams), gaps,
            [np.asarray(r["tokens"]).tolist() for r in twin["results"]])


@pytest.mark.parametrize("world", [2, 4])
def test_async_engine_over_ranks(world, tmp_path):
    """Rank 0 streams greedy and sampled requests at wall-clock gaps over
    the sharded engine and aborts one mid-stream; the others follow its
    records: every rank's session holds the same tokens, rank 0's streams
    are the JAX twin's, one record a pass plus the close."""
    setup, work, gaps, expected = async_case()
    child.spawn(child.async_child, world, tmp_path, setup, work, gaps,
                ABORT_AT, expected, timeout=90)


def test_follower_raises_when_rank0_fails(tmp_path):
    """Rank 0's front end raises mid-session: its streams and close raise,
    and both followers raise on the record that carries the failure."""
    setup, work, _, _ = async_case()
    child.spawn(child.failing_child, 3, tmp_path, setup, work, timeout=60)

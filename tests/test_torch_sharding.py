"""The port's sharding (``repro_torch.sharding``) against the JAX package's
and against the unsharded port, on the CPU.

- Spec parity: ``param_specs`` / ``cache_specs`` under the production and
  multi-pod meshes of both packages ((16, 16), (2, 16, 16), (32, 8),
  (2, 32, 8)) and the serving profile under ("model",) of 2, 4 and 8, for
  every architecture at full width, leaf by leaf through the layer map of
  ``convert.py`` (the JAX package's stacked leading dim dropped): equal
  entries. The JAX specs resolve under ``jax.sharding.use_abstract_mesh``,
  which needs no devices; its ``serve_param_specs`` enters a concrete mesh,
  so its serving weights' specs are ``param_specs`` under the abstract
  ("model",) mesh, which is what ``serve_param_specs`` computes.
- Storage-sharded serving on ``gloo`` at worlds 2 and 4 (spawned ranks):
  qwen2 (2 KV heads of 32: world 2 shards the KV axis, world 4 head_dim),
  mamba2 and recurrentgemma reduced; ``Engine.run`` in the three drafter
  modes and a paged ``Scheduler.serve`` that preempts by recompute and one
  that swaps to the host. Tokens and the gathered state after every step
  are bitwise the unsharded port's, and the tokens equal the JAX engine's
  and scheduler's. Each rank holds 1/N of the K/V bytes, no gather moves
  more than one layer's weights, and a swap parks less on each rank.
- The ops boundary: K/V reach the kernels through ``kv_full`` alone,
  which takes only this rank's slice; a head_dim slice is refused by the
  kernels' wrappers; a gathered one gives the unsharded result; a
  one-rank mesh still gathers; no mesh past the world, no sharded engine
  without a process group.
- The sharded drafter train step at data 2 (and data 2 x model 2) against
  the one-process step over the whole batch: grads atol 2e-5 rtol 2e-4,
  AdamW moments and weights too.
"""
import re
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.sharding import rules as jrules
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, DrafterConfig, get_config
from repro_torch.core import cod
from repro_torch.core import drafter as D
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Engine, EngineConfig, make_decode_state
from repro_torch.sharding import rules
from repro_torch.sharding.utils import Mesh
import torch_threads  # noqa: F401  (torch threads per xdist worker)
import torch_sharding_child as child

TRAIN_MESHES = [(("data", "model"), (16, 16)),
                (("pod", "data", "model"), (2, 16, 16)),
                (("data", "model"), (32, 8)),
                (("pod", "data", "model"), (2, 32, 8))]
SERVE_SIZES = (2, 4, 8)
# a batch every batch axis divides, and a length below every window (no
# ring in either package)
CACHE_B, CACHE_S = 64, 128


# ---------------------------------------------------------------------------
# spec parity
# ---------------------------------------------------------------------------

def _jpath(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _norm(path: str) -> str:
    """The layer map as a path rule: the JAX package's super-block slots
    and tail, and the port's layer indices, dropped."""
    parts = [p for p in path.strip("/").split("/")
             if not re.fullmatch(r"slot\d+|\d+", p)]
    return "/".join("blocks" if p == "tail" else p for p in parts)


def _table(pairs):
    """{normalized path: {(ndim, spec)}}."""
    out = {}
    for path, nd, spec in pairs:
        spec = tuple(spec) + (None,) * (nd - len(tuple(spec)))
        out.setdefault(_norm(path), set()).add((nd, spec))
    return out


def _jax_side(tree, specs):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return _table((_jpath(p), np.ndim(l) if not hasattr(l, "ndim")
                   else l.ndim, s) for (p, l), (_, s) in zip(flat, sflat))


def _port_side(tree, specs):
    from repro_torch.tree import leaves_with_paths
    sp = dict(_spec_leaves(specs))
    return _table((p, len(tuple(getattr(l, "shape", ()))), sp[p])
                  for p, l in leaves_with_paths(tree))


def _spec_leaves(specs, prefix=""):
    """(path, spec) of a port spec tree (specs are tuples: leaves here)."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(specs, list) or (isinstance(specs, tuple)
                                     and hasattr(specs, "_fields")):
        for i, v in enumerate(specs):
            yield from _spec_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, specs


def _same(jt, pt, what):
    """Each normalized path: the JAX specs, their stacked dim dropped,
    equal the port's."""
    assert set(jt) == set(pt), (what, set(jt) ^ set(pt))
    for path in jt:
        (pnd, pspec), = pt[path]
        want = {spec[nd - pnd:] for nd, spec in jt[path]}
        assert want == {pspec}, (what, path, want, pspec)


@lru_cache(maxsize=None)
def shapes(arch):
    """Abstract JAX trees and the port's meta trees of ``arch`` at full
    width: target and drafter parameters, target and drafter caches."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jdcfg, dcfg = JDrafterConfig().resolve(jcfg), DrafterConfig().resolve(tcfg)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    key = jax.random.PRNGKey(0)
    j = (jax.eval_shape(jm.init, key),
         jax.eval_shape(lambda k: JD.init_params(jdcfg, jcfg, k), key),
         jax.eval_shape(lambda: jm.make_cache(CACHE_B, CACHE_S)),
         jax.eval_shape(lambda: JD.make_cache(jdcfg, CACHE_B, CACHE_S)))
    meta = torch.device("meta")
    t = (tm.init(None, device=meta), D.init_params(dcfg, tcfg, None,
                                                   device=meta),
         tm.make_cache(CACHE_B, CACHE_S, device=meta),
         D.make_cache(dcfg, CACHE_B, CACHE_S, device=meta))
    return j, t


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_training_profile_specs_match_jax(arch):
    """param_specs (target and drafter) and cache_specs under the four
    production meshes, leaf by leaf."""
    (jp, jd, jc, jdc), (tp, td, tc, tdc) = shapes(arch)
    for names, sizes in TRAIN_MESHES:
        mesh = Mesh.describe(names, sizes)
        with jax.sharding.use_abstract_mesh(AbstractMesh(sizes, names)):
            js = (jrules.param_specs(jp), jrules.param_specs(
                jd, jrules.DRAFTER_RULES), jrules.cache_specs(jc),
                jrules.cache_specs(jdc))
        ts = (rules.param_specs(tp, mesh=mesh),
              rules.param_specs(td, rules.DRAFTER_RULES, mesh=mesh),
              rules.cache_specs(tc, mesh=mesh),
              rules.cache_specs(tdc, mesh=mesh))
        for what, jt, js_, tt, ts_ in zip(
                ("target", "drafter", "target cache", "drafter cache"),
                (jp, jd, jc, jdc), js, (tp, td, tc, tdc), ts):
            _same(_jax_side(jt, js_), _port_side(tt, ts_),
                  f"{arch} {sizes} {what}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_profile_specs_match_jax(arch):
    """serve_param_specs and serve_state_specs under ("model",) of 2, 4
    and 8, leaf by leaf; in the port's decode state every leaf that is not
    a rank >= 4 k / v replicates."""
    (jp, jd, jc, jdc), (tp, td, tc, tdc) = shapes(arch)
    for n in SERVE_SIZES:
        mesh = Mesh.describe(("model",), (n,))
        amesh = AbstractMesh((n,), ("model",))
        with jax.sharding.use_abstract_mesh(amesh):
            jps = jrules.param_specs(jp)
            jds = jrules.param_specs(jd, jrules.DRAFTER_RULES)
        _same(_jax_side(jp, jps),
              _port_side(tp, rules.serve_param_specs(tp, mesh)), (arch, n))
        _same(_jax_side(jd, jds),
              _port_side(td, rules.serve_param_specs(td, mesh)), (arch, n))
        for jt, tt in ((jc, tc), (jdc, tdc)):
            _same(_jax_side(jt, jrules.serve_state_specs(jt, amesh)),
                  _port_side(tt, rules.serve_state_specs(tt, mesh)),
                  (arch, n, "state"))
    tcfg = get_config(arch)
    state = make_decode_state(get_model(tcfg), tcfg,
                              DrafterConfig().resolve(tcfg),
                              EngineConfig(max_len=CACHE_S), 8,
                              device="meta")
    specs = dict(_spec_leaves(rules.serve_state_specs(
        state, Mesh.describe(("model",), (4,)))))
    for path, spec in specs.items():
        kv = path.rsplit("/", 1)[-1] in ("k", "v") and len(spec) >= 4
        assert any(e is not None for e in spec) == kv, (path, spec)


def test_spec_helpers_filter_as_the_jax_package():
    """spec_for / axis_size / batch_axes under a described mesh, against
    the JAX package's under the abstract mesh: names the mesh lacks and
    axes that do not divide their dim drop out."""
    from repro.sharding import utils as jutils
    from repro_torch.sharding import utils as SH
    cases = [((64, 48), ("data", "model")), ((6, 48), (("pod", "data"),
                                                      "model")),
             ((64, 10), ("model", "model")), ((3,), ("expert",))]
    for names, sizes in TRAIN_MESHES:
        mesh = Mesh.describe(names, sizes)
        with jax.sharding.use_abstract_mesh(AbstractMesh(sizes, names)), \
                SH.mesh_scope(mesh):
            assert SH.batch_axes() == jutils.batch_axes()
            for a in ("pod", "data", "model", "expert"):
                assert SH.axis_size(a) == jutils.axis_size(a)
            for shape, ent in cases:
                want = jutils.spec_for(shape, *ent)
                want = tuple(want) + (None,) * (len(shape) - len(want))
                assert SH.spec_for(shape, *ent) == want, (sizes, shape, ent)
    assert SH.spec_for((4, 4), "model") == (None, None)   # no mesh
    assert SH.axis_size("model") == 1 and SH.batch_axes() is None


def test_port_rules_are_the_jax_tables():
    """The rule tables are copied verbatim."""
    assert rules.PARAM_RULES == jrules.PARAM_RULES
    assert rules.DRAFTER_RULES == jrules.DRAFTER_RULES


# ---------------------------------------------------------------------------
# storage-sharded serving on gloo, against the unsharded port and JAX
# ---------------------------------------------------------------------------

K, MAX_LEN, PAGE, NEW = 2, 64, 8, 12
SERVE_ARCHS = ("qwen2-1.5b", "mamba2-780m", "recurrentgemma-2b")


def _cfg(get, arch):
    cfg = get(arch).reduced()
    # recurrentgemma's reduced() keeps no attention layer: one super-block
    # and its 2-layer tail
    return cfg.replace(n_layers=5) if arch == "recurrentgemma-2b" else cfg


def _workload(n=5, seed=7):
    """(prompt, budget, arrival): prompts of 5-21 tokens, budgets 10-16,
    Exp(1) gaps: on 3 slots and a 7-page pool, someone is preempted."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 1000, int(m)).astype(np.int32), int(b), float(t))
            for m, b, t in zip(rng.integers(5, 22, n), rng.integers(10, 17, n),
                               np.cumsum(rng.exponential(1.0, n)))]


@lru_cache(maxsize=None)
def serving_case(arch):
    """The child's setup and the JAX references: Engine.run's tokens
    (parallel; the three modes emit the same greedy stream) and the paged
    scheduler's streams (lossless under preemption)."""
    jcfg, tcfg = _cfg(jget_config, arch), _cfg(get_config, arch)
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(23))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(24))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    kw = dict(K=K, max_new_tokens=NEW, max_len=MAX_LEN, page_size=PAGE)
    prompts = np.random.default_rng(5).integers(1, 1000, (2, 13)) \
        .astype(np.int32)
    jrun = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(**kw), 2).run(
        jnp.asarray(prompts))
    work = _workload()
    jeng = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(
        **dict(kw, max_new_tokens=16, kv_layout="paged", pool_pages=7)), 3)
    jserve = JScheduler(jeng).serve([JRequest(p, max_new_tokens=b,
                                              arrival_time=t, rid=i)
                                     for i, (p, b, t) in enumerate(work)])
    setup = (tcfg, dcfg, tp, dp, kw, prompts, work)
    expected = (np.asarray(jrun["tokens"]),
                [np.asarray(r["tokens"]) for r in jserve["results"]])
    return setup, expected


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_is_bitwise_unsharded(arch, world, tmp_path):
    """Engine.run (parallel / ar / none, contiguous) and Scheduler.serve
    (paged; a 7-page pool preempting by recompute, then by swap) with
    ``shard_model=True`` over ``world`` gloo ranks: tokens and the gathered
    state after every step bitwise the unsharded engine's, tokens equal to
    the JAX engine's and scheduler's; K/V bytes 1/world a rank; no gather
    of more than one layer's weights."""
    setup, expected = serving_case(arch)
    child.spawn(child.serving_child, world, tmp_path, setup, expected,
                timeout=120)


def test_ops_boundary_and_one_rank_mesh(tmp_path):
    """On two gloo ranks: gathered K/V are contiguous and bitwise the
    sharded tensors; ``kv_full`` refuses a tensor that is not this rank's
    slice; a head_dim slice is refused by the decode kernel's wrapper; a
    page pool keeps a slice's trailing axes; on a one-rank mesh the paged
    kernel's wrapper takes the gathered pool and returns the unsharded
    result, the gathers still run; a mesh past the world raises."""
    child.spawn(child.boundary_child, 2, tmp_path, timeout=60)


def test_shard_model_needs_a_process_group():
    tcfg = get_config("qwen2-1.5b").reduced()
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    g = torch.Generator().manual_seed(0)
    tp = get_model(tcfg).init(g, device="cpu")
    dp = D.init_params(dcfg, tcfg, g, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        Engine(tcfg, dcfg, tp, dp, EngineConfig(shard_model=True), 2,
               device="cpu")


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def train_case():
    """qwen2 reduced and a 1-layer drafter, 4 rows of 24 tokens, one COD
    layout shared by the rows (K 8, r 0.8) and EAGLE labels."""
    tcfg = get_config("qwen2-1.5b").reduced()
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    g = torch.Generator().manual_seed(3)
    tp = get_model(tcfg).init(g, device="cpu")
    dp = D.init_params(dcfg, tcfg, g, device="cpu")
    n, rng = 24, np.random.default_rng(0)
    tokens = rng.integers(1, 1000, (4, n)).astype(np.int32)
    M = cod.expanded_length(n, dcfg.k_train, dcfg.cod_rate)
    pos, depth = cod.pad_to(*cod.sample_cod(rng, n, dcfg.k_train,
                                            dcfg.cod_rate), M)
    tgt = pos + 2
    ok = (pos >= 0) & (tgt < n)
    labels = np.where(ok[None], tokens[:, np.clip(tgt, 0, n - 1)], -1)
    as_t = torch.as_tensor
    return (tcfg, dcfg, tp, dp, as_t(tokens), as_t(pos.astype(np.int32)),
            as_t(depth.astype(np.int32)), as_t(labels.astype(np.int32)), 1)


@lru_cache(maxsize=None)
def jax_train_case():
    """qwen2 reduced and a 1-layer drafter drawn by the JAX package and
    converted, 4 rows of 24 tokens with one COD layout and EAGLE labels."""
    jcfg = jget_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(5))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(6))
    tcfg = get_config("qwen2-1.5b").reduced()
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    n, rng = 24, np.random.default_rng(1)
    tokens = rng.integers(1, 1000, (4, n)).astype(np.int32)
    M = cod.expanded_length(n, dcfg.k_train, dcfg.cod_rate)
    pos, depth = cod.pad_to(*cod.sample_cod(rng, n, dcfg.k_train,
                                            dcfg.cod_rate), M)
    tgt = pos + 2
    ok = (pos >= 0) & (tgt < n)
    labels = np.where(ok[None], tokens[:, np.clip(tgt, 0, n - 1)], -1)
    arrays = tuple(a.astype(np.int32) for a in (tokens, pos, depth, labels))
    return jcfg, jdcfg, jp, jdp, tcfg, dcfg, arrays


@pytest.mark.parametrize("n_micro,max_norm", [(1, 1.0), (2, 1.0),
                                              (2, 1e6)])
def test_train_step_matches_jax(n_micro, max_norm, monkeypatch):
    """The port's ``build_train_step`` on one process against the JAX
    package's on the same converted weights, tokens, COD layout and labels
    (4 rows in ``n_micro`` micro-batches; a max grad norm of 1e6 clips
    nothing, so the gradients' scale shows): the loss within 3e-5, and the
    gradients (through the first moment), the second moment and the
    updated drafter weights within atol 2e-5 rtol 2e-4, the trainer
    tests' tolerances."""
    import repro.launch.steps as JS
    from repro.configs.base import InputShape as JInputShape
    from repro.optim import adamw_init as jadamw_init
    from repro_torch.configs import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves_with_paths

    jcfg, jdcfg, jp, jdp, tcfg, dcfg, arrays = jax_train_case()
    n = arrays[0].shape[1]
    monkeypatch.setitem(JS.INPUT_SHAPES, "train_tiny",
                        JInputShape("train_tiny", n, 4, "train"))
    from repro.training import TrainConfig as JTrainConfig
    from repro_torch.training import TrainConfig
    jfn, _ = JS.build_train_step(jcfg, jdcfg, "train_tiny", n_micro=n_micro,
                                 tc=JTrainConfig(total_steps=10_000,
                                                 max_grad_norm=max_norm))
    jd, jopt, jloss = jfn(jp, jdp, jadamw_init(jdp),
                          *(jnp.asarray(a) for a in arrays),
                          jax.random.PRNGKey(0), {})

    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    fn, _ = build_train_step(tcfg, dcfg, InputShape("train_tiny", n, 4,
                                                    "train"), n_micro=n_micro,
                             tc=TrainConfig(total_steps=10_000,
                                            max_grad_norm=max_norm))
    d, opt, met = fn(tp, dp, adamw_init(dp),
                     *(torch.as_tensor(a) for a in arrays),
                     torch.zeros(2, dtype=torch.int64), {})

    np.testing.assert_allclose(float(met["loss"]), float(jloss), atol=3e-5,
                               rtol=3e-5)

    def same(port, jtree, scale=1.0):
        want = dict(leaves_with_paths(convert.drafter_params(
            jax.tree.map(np.asarray, jtree))))
        got = dict(leaves_with_paths(port))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k].detach().numpy() * scale,
                                       want[k].numpy() * scale, err_msg=k,
                                       atol=2e-5, rtol=2e-4)
    b1 = 0.9
    same(opt.m, jopt.m, 1 / (1 - b1))   # one step from zero: m = (1 - b1) g
    same(opt.v, jopt.v)
    same(d, jd)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (2, 2)])
def test_sharded_train_step_matches_one_process(n_data, n_model, tmp_path):
    """``build_train_step`` on a (data, model) gloo mesh, each data rank
    one micro-batch of 2 rows, the drafter and its moments sharded by
    ``param_specs``: the loss, the gradients (through the first moment),
    the second moment and the updated weights within atol 2e-5 rtol 2e-4
    of the one-process step over the 4 rows in 2 micro-batches."""
    child.spawn(child.train_child, n_data * n_model, tmp_path, train_case(),
                n_data, n_model, timeout=120)

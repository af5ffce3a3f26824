"""The port's serving engine against the JAX engine on the reduced
qwen2-1.5b in float32, with converted weights and the same numpy prompts:
``Engine.run`` tokens, ``new_count`` and ``committed`` must be equal for the
parallel, AR and plain modes, and inside the port parallel == ar == none
(greedy speculative decoding is lossless, even with an untrained drafter).
Logprobs are held to 3e-5 (float32, reductions in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.core import spec_decode as JSD
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import cache_ops as jcache_ops
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.core import spec_decode as SD
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import Engine, EngineConfig
import torch_threads  # noqa: F401  (torch threads per xdist worker)

MODES = ("parallel", "ar", "none")
B, P, K, MAX_NEW, MAX_LEN = 3, 10, 3, 14, 48


@pytest.fixture(scope="module")
def runs():
    """One JAX engine run and one port run per drafter mode, shared by the
    module's tests."""
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=2).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=2).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(11))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(12))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size - 1, (B, P)).astype(np.int32)
    out = {}
    for mode in MODES:
        use_d = mode != "none"
        je = JEngine(jcfg, jdcfg if use_d else None, jp, jdp if use_d else None,
                     JEngineConfig(K=K, max_new_tokens=MAX_NEW,
                                   drafter_mode=mode, max_len=MAX_LEN), B)
        te = Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                    EngineConfig(K=K, max_new_tokens=MAX_NEW, drafter_mode=mode,
                                 max_len=MAX_LEN), B, device="cpu")
        out[mode] = (je.run(jnp.asarray(prompts)), te.run(prompts))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_run_matches_jax_engine(runs, mode):
    jr, tr = runs[mode]
    np.testing.assert_array_equal(tr["tokens"], jr["tokens"])
    np.testing.assert_array_equal(tr["state"]["new_count"].numpy(),
                                  np.asarray(jr["state"]["new_count"]))
    for leaf in ("committed", "iters", "row_iters", "last", "slot_iters"):
        np.testing.assert_array_equal(tr["state"][leaf].numpy(),
                                      np.asarray(jr["state"][leaf]), leaf)
    np.testing.assert_allclose(tr["state"]["logprobs"].numpy(),
                               np.asarray(jr["state"]["logprobs"]),
                               atol=3e-5, rtol=3e-5)
    assert tr["new_tokens"] == jr["new_tokens"] == B * MAX_NEW
    assert tr["acceptance_length"] == pytest.approx(jr["acceptance_length"])
    assert tr["iterations"] == jr["iterations"]


@pytest.mark.parametrize("mode", ["parallel", "ar"])
def test_speculative_modes_equal_plain_decoding(runs, mode):
    np.testing.assert_array_equal(runs[mode][1]["tokens"],
                                  runs["none"][1]["tokens"])


def _oracle_table(none_tokens, vocab, seed=3, spoil=0.2):
    """The plain run's greedy tokens, (B, MAX_LEN), with a seeded fifth of
    them replaced by another token: drafts read from it are accepted up to
    the first spoiled one, so accept lengths vary from 0 to K."""
    rng = np.random.default_rng(seed)
    bad = rng.random(none_tokens.shape) < spoil
    return np.where(bad, (none_tokens + 1) % (vocab - 1),
                    none_tokens).astype(np.int32)


def _jax_oracle(fn, table):
    """Wrap a JAX draft function: the drafter runs (its cache is updated as
    usual) but its K drafts at anchor c-1 become table[:, c+1 .. c+K]."""
    table = jnp.asarray(table)

    def draft(*args, **kw):
        _, logits, cache = fn(*args, **kw)
        anchor, k = args[6], args[7]
        idx = jnp.minimum(anchor[:, None] + 2 + jnp.arange(k, dtype=jnp.int32),
                          table.shape[1] - 1)
        return jnp.take_along_axis(table, idx, axis=1), logits, cache
    return draft


def _torch_oracle(fn, table):
    """The port's twin of ``_jax_oracle``."""
    table = torch.from_numpy(table)

    def draft(*args, **kw):
        _, logits, cache = fn(*args, **kw)
        anchor, k = args[6], args[7]
        idx = (anchor[:, None] + 2 + torch.arange(k)).clamp(
            max=table.shape[1] - 1)
        return table.gather(1, idx.long()), logits, cache
    return draft


@pytest.fixture(scope="module")
def oracle_runs(runs):
    """JAX and port runs whose drafters propose the plain run's own greedy
    continuation, partly spoiled, so the accept path (accept_len > 0, the
    multi-token commit and scatter, the taps gather at accept_len, the
    drafter extend after accepts) runs in both."""
    from repro_torch.core import drafter as D
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=2).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=2).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(11))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(12))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size - 1, (B, P)).astype(np.int32)
    table = _oracle_table(np.asarray(runs["none"][0]["tokens"]),
                          jcfg.vocab_size)
    out = {}
    for mode in ("parallel", "ar"):
        fn = {"parallel": "draft_parallel", "ar": "draft_ar"}[mode]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JD, fn, _jax_oracle(getattr(JD, fn), table))
            mp.setattr(D, fn, _torch_oracle(getattr(D, fn), table))
            ecfg = dict(K=K, max_new_tokens=MAX_NEW, drafter_mode=mode,
                        max_len=MAX_LEN)
            je = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(**ecfg), B)
            te = Engine(tcfg, dcfg, tp, dp, EngineConfig(**ecfg), B,
                        device="cpu")
            out[mode] = (je.run(jnp.asarray(prompts)), te.run(prompts))
    return out, tcfg


@pytest.mark.parametrize("mode", ["parallel", "ar"])
def test_accepting_drafts_match_jax_engine(oracle_runs, mode):
    """Tokens, counters, last, logprobs (3e-5) and both caches (positions
    exact, K/V 3e-5) equal the JAX engine's when drafts are accepted."""
    out, tcfg = oracle_runs
    jr, tr = out[mode]
    assert tr["acceptance_length"] > 2.0
    assert tr["acceptance_length"] == pytest.approx(jr["acceptance_length"])
    np.testing.assert_array_equal(tr["tokens"], jr["tokens"])
    for leaf in ("new_count", "committed", "iters", "row_iters", "last",
                 "slot_iters"):
        np.testing.assert_array_equal(tr["state"][leaf].numpy(),
                                      np.asarray(jr["state"][leaf]), leaf)
    np.testing.assert_allclose(tr["state"]["logprobs"].numpy(),
                               np.asarray(jr["state"]["logprobs"]),
                               atol=3e-5, rtol=3e-5)
    jstate = jax.tree.map(np.asarray, jr["state"])
    caches = (("tcache", convert.target_cache(jstate["tcache"], tcfg)),
              ("dcache", convert.drafter_cache(jstate["dcache"])))
    for name, want in caches:
        got = tr["state"][name]["blocks"]
        assert len(got) == len(want["blocks"]), name
        for i, (g, w) in enumerate(zip(got, want["blocks"])):
            np.testing.assert_array_equal(g["positions"].numpy(),
                                          w["positions"].numpy(),
                                          f"{name} layer {i} positions")
            for kv in ("k", "v"):
                np.testing.assert_allclose(g[kv].numpy(), w[kv].numpy(),
                                           atol=3e-5, rtol=3e-5,
                                           err_msg=f"{name} layer {i} {kv}")


@pytest.mark.parametrize("mode", ["parallel", "ar"])
def test_accepting_drafts_equal_plain_decoding(runs, oracle_runs, mode):
    """Greedy speculative decoding stays lossless on the accept path, over
    each row's budget (a last step may commit up to K tokens past it)."""
    np.testing.assert_array_equal(
        oracle_runs[0][mode][1]["tokens"][:, :P + MAX_NEW],
        runs["none"][1]["tokens"][:, :P + MAX_NEW])


def test_decode_state_leaves(runs):
    """The port's state has the JAX engine's leaves, the sampling policy
    included, with the same shapes."""
    jr, tr = runs["parallel"]
    jstate, tstate = jr["state"], tr["state"]
    assert set(tstate) == set(jstate)
    assert set(tstate["sampling"]) == set(jstate["sampling"])
    for leaf in tstate:
        if leaf == "sampling":
            for k, v in tstate[leaf].items():
                assert tuple(v.shape) == tuple(jstate[leaf][k].shape), k
        elif leaf not in ("tcache", "dcache"):
            assert tuple(tstate[leaf].shape) == tuple(jstate[leaf].shape), leaf


def test_greedy_verify_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 5, 11)).astype(np.float32)
    drafts = logits[:, :4].argmax(-1).astype(np.int32)
    drafts[1, 0] += 1
    drafts[2, 2] = (drafts[2, 2] + 3) % 11
    ja, jt = JSD.greedy_verify(jnp.asarray(drafts), jnp.asarray(logits))
    ta, tt = SD.greedy_verify(torch.from_numpy(drafts), torch.from_numpy(logits))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ta.tolist() == [4, 0, 2, 4]


@pytest.mark.parametrize("masked", [False, True])
def test_acceptance_stats_match_jax(masked):
    acc = np.array([2, 0, 5, 1], np.int32)
    active = np.array([True, False, True, False]) if masked else None
    iters = np.array([1, 2, 3, 1], np.int32)
    js = JSD.update_acceptance_stats({}, jnp.asarray(acc),
                                     None if active is None else jnp.asarray(active),
                                     jnp.asarray(iters))
    ts = SD.update_acceptance_stats({}, torch.from_numpy(acc),
                                    None if active is None
                                    else torch.from_numpy(active),
                                    torch.from_numpy(iters))
    for k in ("iters", "tokens", "mean"):
        assert float(ts[k]) == pytest.approx(float(js[k])), k
    idle = SD.update_acceptance_stats({}, torch.from_numpy(acc),
                                      torch.zeros(4, dtype=torch.bool))
    assert float(idle["mean"]) == 0.0


def test_commit_matches_jax():
    pos = np.array([[[0, 1, 2, 3, -1], [0, 1, 2, 3, 4]]], np.int32)  # (1,B,W)
    jout = jcache_ops.commit({"blocks": {"positions": jnp.asarray(pos),
                                         "ring": jnp.array([False])}},
                             None, jnp.array([1, 3]), jnp.array([0, 0]))
    mine = {"blocks": [{"positions": torch.from_numpy(pos[0].copy()),
                        "ring": False}]}
    cache_ops.commit(mine, torch.tensor([1, 3], dtype=torch.int32))
    np.testing.assert_array_equal(mine["blocks"][0]["positions"].numpy(),
                                  np.asarray(jout["blocks"]["positions"])[0])


def test_length_budget_is_checked():
    tcfg = get_config("qwen2-1.5b").reduced()
    from repro_torch.models.registry import get_model
    tp = get_model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(tcfg, None, tp, None,
                 EngineConfig(K=0, max_new_tokens=8, drafter_mode="none",
                              max_len=16), 1, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.prefill(np.zeros((1, 9), np.int32))

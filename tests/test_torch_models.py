"""The port's target model and drafter against the JAX package on the
reduced qwen2-1.5b in float32: JAX parameters are converted with
``repro_torch.convert``, inputs are made with numpy from a seed, and
logits, taps and every cache leaf are compared.

Tolerance 3e-5 (float32 on both sides, reductions in another order);
drafted tokens must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.core import drafter as D
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
import torch_threads  # noqa: F401  (torch threads per xdist worker)

TOL = 3e-5
B, P, MAX_LEN, K = 2, 12, 40, 4


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=2).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=2).resolve(tcfg)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(1))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(jcfg=jcfg, tcfg=tcfg, jdcfg=jdcfg, dcfg=dcfg, jm=jm, jp=jp,
                jdp=jdp, tp=convert.target_params(np_tree(jp), tcfg),
                dp=convert.drafter_params(np_tree(jdp)),
                rng=np.random.default_rng(0))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


def _same_cache(tcache, jcache_port):
    assert len(tcache["blocks"]) == len(jcache_port["blocks"])
    for mine, theirs in zip(tcache["blocks"], jcache_port["blocks"]):
        np.testing.assert_array_equal(mine["positions"].numpy(),
                                      theirs["positions"].numpy())
        assert mine["ring"] == theirs["ring"]
        for name in ("k", "v"):
            _close(mine[name], theirs[name].numpy())


# each config's drafter at full width: (d, heads, kv heads, head dim, d_ff)
FULL_DRAFTERS = {"qwen2-1.5b": (1536, 12, 12, 128, 5376),
                 "dbrx-132b": (6144, 48, 48, 128, 21504),
                 "llama4-maverick-400b-a17b": (5120, 40, 40, 128, 17920)}


@pytest.mark.parametrize("arch", list(FULL_DRAFTERS))
def test_config_copy_matches_reference(arch):
    """The port's copied configs resolve to the JAX package's, field by
    field (the MoE routing, attention pattern, window and NoPE among
    them), at full width and reduced; so do their drafters."""
    for reduced in (False, True):
        j, t = jget_config(arch), get_config(arch)
        if reduced:
            j, t = j.reduced(), t.reduced()
        jd, td = JDrafterConfig().resolve(j), DrafterConfig().resolve(t)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta", "qkv_bias",
                  "dtype", "norm_eps", "tie_embeddings", "mlp_variant",
                  "attn_pattern", "window_size", "nope_on_global"):
            assert getattr(j, f) == getattr(t, f), f
        assert dataclasses.asdict(j.moe) == dataclasses.asdict(t.moe)
        assert [j.is_moe_layer(li) for li in range(j.n_layers)] == \
            [t.is_moe_layer(li) for li in range(t.n_layers)]
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "rope_theta"):
            assert getattr(jd, f) == getattr(td, f), f
    full = DrafterConfig().resolve(get_config(arch))
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff) == FULL_DRAFTERS[arch]


def test_target_prefill_then_decode(setup):
    s = setup
    jcfg, tcfg, jm = s["jcfg"], s["tcfg"], s["jm"]
    toks = s["rng"].integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    jc = jm.make_cache(B, MAX_LEN, dtype=jnp.float32)
    jo = jm.forward(s["jp"], jnp.asarray(toks), mode="prefill", cache=jc)
    model = get_model(tcfg)
    tc = model.make_cache(B, MAX_LEN, dtype=torch.float32, device="cpu")
    to = model.forward(s["tp"], torch.from_numpy(toks), mode="prefill",
                       cache=tc)
    _close(to.logits, jo.logits)
    _close(to.taps, jo.taps)
    assert to.taps.shape == (B, P, 3 * tcfg.d_model)
    _same_cache(to.cache, convert.target_cache(
        jax.tree.map(np.asarray, jo.cache), tcfg))

    # a verify-shaped decode over K+1 tokens at positions P..P+K, then a
    # rolled-back decode that rewrites from P+1 (stale history masked)
    for start in (P, P + 1):
        dt = s["rng"].integers(0, jcfg.vocab_size, (B, K + 1)).astype(np.int32)
        pos = (start + np.broadcast_to(np.arange(K + 1)[None], (B, K + 1))
               ).astype(np.int32)
        jo = jm.forward(s["jp"], jnp.asarray(dt), mode="decode",
                        positions=jnp.asarray(pos), cache=jo.cache)
        to = model.forward(s["tp"], torch.from_numpy(dt), mode="decode",
                           positions=torch.from_numpy(pos), cache=to.cache)
        _close(to.logits, jo.logits)
        _close(to.taps, jo.taps)
        _same_cache(to.cache, convert.target_cache(
            jax.tree.map(np.asarray, jo.cache), tcfg))


@pytest.mark.parametrize("head", ["last", "positions"])
def test_target_head_selection(setup, head):
    s = setup
    toks = s["rng"].integers(0, s["jcfg"].vocab_size, (B, P)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if head == "last":
        kw_j = kw_t = {"head_last_only": True}
    else:
        hp = np.array([3, P - 2], np.int32)
        kw_j = {"head_positions": jnp.asarray(hp)}
        kw_t = {"head_positions": torch.from_numpy(hp)}
    jo = s["jm"].forward(s["jp"], jnp.asarray(toks), mode="train",
                         collect_taps=False, **kw_j)
    to = T.forward(s["tcfg"], s["tp"], torch.from_numpy(toks), mode="train",
                   collect_taps=False, **kw_t)
    assert to.taps is None and to.logits.shape == (B, 1, s["tcfg"].vocab_size)
    _close(to.logits, jo.logits)


def test_unsupported_configs_raise():
    """What the port does not carry raises: a family it does not know and
    a positional scheme it does not know. Every family of the JAX package
    builds: the dense family's variants (softcaps, local attention,
    post-norms, embedding scale, other MLPs, an untied head), MoE layers
    and NoPE, sinusoidal positions, the vlm family (through the
    transformer) and the encdec family, none recurrent; the SSM and the
    hybrid families, both recurrent."""
    cfg = get_config("qwen2-1.5b").reduced()
    moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=2)
    for bad in (dict(family="audio"), dict(positional="alibi")):
        with pytest.raises(NotImplementedError):
            get_model(cfg.replace(**bad))
    for ok in (dict(logit_softcap=50.0, final_softcap=30.0),
               dict(attn_pattern=("local", "global")),
               dict(post_norms=True, embed_scale=True),
               dict(mlp_variant="relu2", tie_embeddings=False),
               dict(moe=moe), dict(family="moe", moe=moe),
               dict(attn_pattern=("local", "global"), nope_on_global=True),
               dict(positional="sinusoidal")):
        assert not get_model(cfg.replace(**ok)).recurrent
    for arch, module in (("internvl2-1b", ".transformer"),
                         ("whisper-base", ".encdec")):
        m = get_model(get_config(arch).reduced())
        assert not m.recurrent and m.module.__name__.endswith(module)
    ssm = get_model(get_config("mamba2-780m").reduced())
    assert ssm.recurrent and ssm.module.__name__.endswith(".ssm")
    hyb = get_model(cfg.replace(family="hybrid"))
    assert hyb.recurrent and hyb.module.__name__.endswith(".hybrid")


def _prefilled_drafter(s):
    """A drafter cache extended over a prompt, on both sides."""
    jcfg = s["jcfg"]
    toks = s["rng"].integers(0, jcfg.vocab_size - 1, (B, P)).astype(np.int32)
    taps = s["rng"].standard_normal((B, P - 1, 3 * jcfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(P - 1)[None], (B, P - 1)).astype(np.int32)
    jc = JD.make_cache(s["jdcfg"], B, MAX_LEN, dtype=jnp.float32)
    jc = JD.extend(s["jdcfg"], jcfg, s["jdp"], jc, jnp.asarray(toks[:, 1:]),
                   jnp.asarray(taps), jnp.asarray(pos))
    tc = D.make_cache(s["dcfg"], B, MAX_LEN, dtype=torch.float32, device="cpu")
    tc = D.extend(s["dcfg"], s["tcfg"], s["dp"], tc,
                  torch.from_numpy(toks[:, 1:]), torch.from_numpy(taps),
                  torch.from_numpy(pos.copy()))
    return jc, tc


def test_drafter_extend(setup):
    jc, tc = _prefilled_drafter(setup)
    _same_cache(tc, convert.drafter_cache(jax.tree.map(np.asarray, jc)))


@pytest.mark.parametrize("mode", ["parallel", "ar"])
def test_drafter_draft(setup, mode):
    s = setup
    jc, tc = _prefilled_drafter(s)
    tok = s["rng"].integers(0, s["jcfg"].vocab_size - 1, (B,)).astype(np.int32)
    taps = s["rng"].standard_normal((B, 3 * s["jcfg"].d_model)).astype(
        np.float32)
    anchor = np.full((B,), P - 1, np.int32)
    jfn = JD.draft_parallel if mode == "parallel" else JD.draft_ar
    tfn = D.draft_parallel if mode == "parallel" else D.draft_ar
    jt, jl, jc = jfn(s["jdcfg"], s["jcfg"], s["jdp"], jc, jnp.asarray(tok),
                     jnp.asarray(taps), jnp.asarray(anchor), K)
    tt, tl, tc = tfn(s["dcfg"], s["tcfg"], s["dp"], tc, torch.from_numpy(tok),
                     torch.from_numpy(taps), torch.from_numpy(anchor), K)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(tl, jl)
    _same_cache(tc, convert.drafter_cache(jax.tree.map(np.asarray, jc)))


@pytest.mark.parametrize("variant", ["shared", "depth_encoding", "ntp_hidden",
                                     "ntp_hidden_depth", "regularized"])
def test_draft_block_inputs_variants(setup, variant):
    s = setup
    jdcfg = JDrafterConfig(n_layers=1, hidden_state_variant=variant).resolve(
        s["jcfg"])
    dcfg = DrafterConfig(n_layers=1, hidden_state_variant=variant).resolve(
        s["tcfg"])
    jdp = JD.init_params(jdcfg, s["jcfg"], jax.random.PRNGKey(2))
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    tok = np.array([5, 9], np.int32)
    taps = s["rng"].standard_normal((B, 3 * s["jcfg"].d_model)).astype(
        np.float32)
    anchor = np.array([3, 7], np.int32)
    jx, jpos = JD.draft_block_inputs(jdcfg, s["jcfg"], jdp, jnp.asarray(tok),
                                     jnp.asarray(taps), jnp.asarray(anchor), K)
    tx, tpos = D.draft_block_inputs(dcfg, s["tcfg"], dp, torch.from_numpy(tok),
                                    torch.from_numpy(taps),
                                    torch.from_numpy(anchor), K)
    _close(tx, jx, 1e-4)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_init_params_structure_matches_converted(setup):
    """Seeded torch init builds the same tree (names, shapes, dtypes) that
    converting the JAX init gives."""
    s = setup
    g = torch.Generator().manual_seed(0)
    mine = T.init_params(s["tcfg"], g, device="cpu")
    dmine = D.init_params(s["dcfg"], s["tcfg"], g, device="cpu")

    def sig(t):
        if isinstance(t, dict):
            return {k: sig(v) for k, v in t.items()}
        if isinstance(t, list):
            return [sig(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert sig(mine) == sig(s["tp"])
    assert sig(dmine) == sig(s["dp"])
    w = mine["blocks"][0]["attn"]["wq"]
    ref_std = float(s["tp"]["blocks"][0]["attn"]["wq"].std())
    assert abs(float(w.std()) / ref_std - 1.0) < 0.05
    assert float(w.abs().max()) <= 3.0 / s["tcfg"].d_model ** 0.5 + 1e-6

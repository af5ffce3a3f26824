"""The port's sampled lane against the JAX package on the CPU: the
decoding policy, its key streams, warping, seeded rejection verification,
losslessness as a distribution, and seeded ``Engine.run`` streams on the
reduced qwen2-1.5b in float32 with converted weights.

Tolerances: keys bitwise; ``warp_probs`` within 1e-6 with the same kept
support except at a top-p boundary (``csum - p`` within 1e-6 of top_p);
``accept_len`` and ``committed`` of the verifiers equal on fixed p and q;
the first committed token's histogram over 2^14 seeded rows passes a
chi-square test against the warped target at the 0.999 quantile. Engine
streams are equal token for token, except after a decision whose margin
(``serving.margins``; the port's, within float32 noise of the
reference's) is below 1e-4, after which a row is not compared."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.core import spec_decode as JSD
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import sampling as JS
from repro_torch import convert, prng
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.core import drafter as D
from repro_torch.core import spec_decode as SD
from repro_torch.serving import cache_ops
from repro_torch.serving import sampling as S
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.margins import MarginLog

NEAR_TIE = 1e-4
B, P, K, MAX_NEW, MAX_LEN = 3, 10, 3, 14, 48
POLICY = dict(temperature=0.9, top_k=40, top_p=0.9, seed=3)


def words(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def jstate(sp, batch):
    return JS.batch_sampling_state(JS.SamplingParams(**sp), batch)


# ---------------------------------------------------------------------------
# the policy and its key streams
# ---------------------------------------------------------------------------

def test_sampling_params_validation():
    S.SamplingParams(temperature=0.7, top_k=5, top_p=0.9, seed=3,
                     stop_token_ids=(7,), max_new_tokens=4)
    assert S.SamplingParams.greedy().is_greedy
    assert not S.SamplingParams(temperature=0.1).is_greedy
    for bad in [dict(temperature=-0.1), dict(temperature=float("inf")),
                dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5),
                dict(seed=1.5), dict(max_new_tokens=0)]:
        with pytest.raises(ValueError):
            S.SamplingParams(**bad)
        with pytest.raises(ValueError):
            JS.SamplingParams(**bad)


def test_engine_config_greedy_deprecated_exactly_once():
    for flag, want_greedy in [(True, True), (False, False)]:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            cfg = EngineConfig(greedy=flag)
        dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == 1, f"greedy={flag}: {len(dep)} warnings"
        assert cfg.sampling.is_greedy == want_greedy
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = EngineConfig(sampling=S.SamplingParams(temperature=0.5, seed=9))
        EngineConfig()
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert cfg.sampling.temperature == 0.5


def test_known_key_streams():
    samp = S.batch_sampling_state(S.SamplingParams(seed=1234), 2)
    assert S.step_keys(samp, torch.tensor([517, 518])).tolist() == [
        [4162650630, 3893356881], [3651137254, 884596093]]
    assert S.draft_keys(samp, 517, 3)[0].tolist() == [
        [1546567615, 1943629236], [3829688118, 1817850175],
        [1043616496, 743150992]]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -1, 2 ** 40 + 3])
@pytest.mark.parametrize("K", [1, 5])
def test_step_and_draft_keys_match_jax(seed, K):
    sp = dict(temperature=0.7, seed=seed)
    pos = np.array([0, 9, 517, 4095], np.int32)
    mine = S.batch_sampling_state(S.SamplingParams(**sp), 4)
    ref = jstate(sp, 4)
    np.testing.assert_array_equal(mine["key"].numpy(),
                                  np.asarray(ref["key"]).astype(np.int64))
    np.testing.assert_array_equal(
        S.step_keys(mine, torch.from_numpy(pos)).numpy(),
        np.asarray(JS.step_keys(ref, jnp.asarray(pos))).astype(np.int64))
    np.testing.assert_array_equal(
        S.draft_keys(mine, torch.from_numpy(pos), K).numpy(),
        np.asarray(JS.draft_keys(ref, jnp.asarray(pos), K)).astype(np.int64))


def test_policy_state_matches_jax():
    sp = dict(temperature=0.6, top_k=7, top_p=0.8, seed=5)
    for mine, ref in ((S.batch_sampling_state(S.SamplingParams(**sp), 3),
                       jstate(sp, 3)),
                      (S.blank_sampling_state(3),
                       JS.blank_sampling_state(3))):
        assert mine.keys() == ref.keys()
        for k in mine:
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(ref[k]), k)


# ---------------------------------------------------------------------------
# warping and verification
# ---------------------------------------------------------------------------

def _logits(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    lg = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    if ties:      # a four-way tie above every other logit
        lg[..., :4] = lg.max(-1, keepdims=True) + 0.5
    return lg


WARPS = {
    "temperature": ([0.5, 1.0, 1.7], [0, 0, 0], [1.0, 1.0, 1.0]),
    "top-k": ([1.0, 1.0, 0.8], [1, 5, 3], [1.0, 1.0, 1.0]),
    "top-k ties": ([1.0, 1.0, 1.0], [3, 4, 2], [1.0, 1.0, 1.0]),
    "top-p": ([1.0, 0.7, 1.0], [0, 0, 0], [0.9, 0.5, 0.0]),
    "combined": ([0.8, 1.3, 0.0], [50, 8, 0], [0.95, 0.6, 1.0]),
    "blank rows": ([0.0, 0.0, 0.0], [0, 0, 0], [0.0, 0.0, 0.0]),
}


@pytest.mark.parametrize("case", WARPS)
def test_warp_probs_matches_jax(case):
    t, k, p = (np.asarray(a, dt) for a, dt in zip(
        WARPS[case], (np.float32, np.int32, np.float32)))
    lg = _logits(1, (3, 4, 300), ties="ties" in case)
    want = np.asarray(JSD.warp_probs(*map(jnp.asarray, (lg, t, k, p))))
    got = SD.warp_probs(*map(torch.from_numpy, (lg, t, k, p))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the kept support is the same, except at a top-p boundary
    ps = np.sort(np.asarray(jax.nn.softmax(lg / np.where(t > 0, t, 1.0)[
        :, None, None], -1)), -1)[..., ::-1]
    boundary = (np.abs(np.cumsum(ps, -1) - ps - p[:, None, None])
                < 1e-6).any(-1)
    same = ((got > 0) == (want > 0)).all(-1)
    assert (same | boundary).all()
    if "ties" in case:     # k <= 4 keeps the whole tie and nothing else
        assert (got[..., :4] > 0).all() and (got[..., 4:] == 0).all()


def test_sample_token_matches_jax():
    lg = _logits(2, (6, 200))
    t = np.array([0, 0.7, 1.0, 1.4, 0.5, 2.0], np.float32)
    k = np.array([0, 5, 0, 3, 1, 10], np.int32)
    p = np.array([1, 0.9, 0.5, 1, 0.3, 0.3], np.float32)
    jk = jax.random.split(jax.random.PRNGKey(4), 6)
    want = JSD.sample_token(jk, *map(jnp.asarray, (lg, t, k, p)))
    got = SD.sample_token(words(jk), *map(torch.from_numpy, (lg, t, k, p)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _verify_case(name):
    """(drafts, q, target logits, temperature, k_row) of a named case."""
    rng = np.random.default_rng(3)
    Bv, Kv, V = 6, 4, 40
    lg = _logits(5, (Bv, Kv + 1, V))
    temp = np.array([0.8, 1.0, 1.2, 0.0, 0.9, 1.0], np.float32)
    k_row = None
    qlog = _logits(6, (Bv, Kv, V))
    q = np.asarray(jax.nn.softmax(qlog, -1))
    q64 = q.astype(np.float64)
    q64 /= q64.sum(-1, keepdims=True)
    drafts = np.stack([[rng.choice(V, p=q64[b, i]) for i in range(Kv)]
                       for b in range(Bv)]).astype(np.int32)
    if name == "one-hot q":
        drafts = lg[:, :Kv].argmax(-1).astype(np.int32)
        drafts[:, 2] = (drafts[:, 2] + 1) % V
        q = np.asarray(jax.nn.one_hot(drafts, V))
    elif name == "k_row < K":
        k_row = np.array([0, 1, 2, 3, 4, 2], np.int32)
    elif name == "p == q":
        # q is the warped target itself: acceptance is certain and a
        # rejection's residual is zero, so it falls back to p
        q = np.asarray(JSD.warp_probs(jnp.asarray(lg), jnp.asarray(temp),
                                      jnp.zeros(Bv, jnp.int32),
                                      jnp.ones(Bv, jnp.float32)))[:, :Kv]
        k_row = np.array([4, 4, 1, 4, 0, 3], np.int32)
    return drafts, q.astype(np.float32), lg, temp, k_row


@pytest.mark.parametrize("name", ["sampled q", "one-hot q", "k_row < K",
                                  "p == q"])
def test_mixed_and_rejection_verify_match_jax(name):
    drafts, q, lg, temp, k_row = _verify_case(name)
    Bv = drafts.shape[0]
    tk, tp = np.zeros(Bv, np.int32), np.ones(Bv, np.float32)
    jk = jax.random.split(jax.random.PRNGKey(9), Bv)
    jargs = [jnp.asarray(a) for a in (drafts, q, lg, temp, tk, tp)]
    targs = [torch.from_numpy(a) for a in (drafts, q, lg, temp, tk, tp)]
    jkr = None if k_row is None else jnp.asarray(k_row)
    tkr = None if k_row is None else torch.from_numpy(k_row)
    ja, jc = JSD.mixed_verify(jk, *jargs, jkr)
    ta, tc = SD.mixed_verify(words(jk), *targs, tkr)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the rows verifier on the raw probabilities of the warped target
    p = np.array(JSD.warp_probs(*jargs[2:]))
    ja, jc = JSD.rejection_verify_rows(jk, jargs[0], jargs[1],
                                       jnp.asarray(p), jkr)
    ta, tc = SD.rejection_verify_rows(words(jk), targs[0], targs[1],
                                      torch.from_numpy(p), tkr)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if name == "p == q":
        assert (ta.numpy() == np.minimum(k_row, drafts.shape[1])).all()


def test_rejection_verify_whole_batch_matches_jax():
    drafts, q, lg, temp, _ = _verify_case("sampled q")
    p = np.asarray(jax.nn.softmax(lg, -1))
    ja, jc = JSD.rejection_verify(jax.random.PRNGKey(2), jnp.asarray(drafts),
                                  jnp.asarray(q), jnp.asarray(p))
    ta, tc = SD.rejection_verify(prng.PRNGKey(2), torch.from_numpy(drafts),
                                 torch.from_numpy(q), torch.from_numpy(p.copy()))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def first_token_chi2(sampled_drafts: bool, device="cpu", N=2 ** 14):
    """(statistic, threshold, empty-bin draws) of the first committed
    token over N seeded rows against the warped target: K 3 drafts from a
    drafter distribution q unlike p, drawn from q (sampled) or its argmax
    (one-hot q)."""
    V, Kc = 8, 3
    g = np.random.default_rng(0)
    logits = torch.from_numpy((1.5 * g.standard_normal((1, Kc + 1, V)))
                              .astype(np.float32)).to(device)
    t = torch.tensor([0.8], device=device)
    p = SD.warp_probs(logits, t, torch.tensor([6], device=device),
                      torch.tensor([1.0], device=device))[0]
    q = torch.softmax(torch.from_numpy(g.standard_normal((Kc, V)).astype(
        np.float32)).to(device), -1)
    keys = prng.split(prng.PRNGKey(0, device=device), N)
    kd, kv = prng.split(keys, 2).unbind(1)
    if sampled_drafts:
        drafts = prng.categorical(prng.split(kd, Kc), torch.log(q)[None])
        dprobs = q.expand(N, Kc, V)
    else:
        drafts = q.argmax(-1).expand(N, Kc)
        dprobs = torch.nn.functional.one_hot(drafts, V).float()
    _, committed = SD.rejection_verify_rows(
        kv, drafts.to(torch.int32), dprobs, p.expand(N, Kc + 1, V))
    obs = torch.bincount(committed[:, 0].long(), minlength=V).cpu().numpy()
    exp = p[0].cpu().numpy().astype(np.float64) * N
    live = exp > 0
    stat = float((((obs - exp) ** 2)[live] / exp[live]).sum())
    return stat, chi2.ppf(0.999, live.sum() - 1), int(obs[~live].sum())


@pytest.mark.parametrize("sampled_drafts", [False, True],
                         ids=["one-hot drafts", "sampled drafts"])
def test_rejection_verify_lossless_distribution(sampled_drafts):
    stat, threshold, outside = first_token_chi2(sampled_drafts)
    assert outside == 0
    assert stat < threshold, (stat, threshold)


# ---------------------------------------------------------------------------
# per-slot surgery, conversion
# ---------------------------------------------------------------------------

def test_freed_slot_policy_row_is_blank():
    state = {"sampling": S.batch_sampling_state(
        S.SamplingParams(temperature=0.5, top_k=3, top_p=0.7, seed=4), 3)}
    src = {"sampling": S.batch_sampling_state(
        S.SamplingParams(temperature=1.1, seed=8), 1)}
    cache_ops.write_slot(state, src, 1)
    assert state["sampling"]["key"][1].tolist() == [0, 8]
    cache_ops.reset_slot(state, 1)
    blank = S.blank_sampling_state(1)
    for k, v in blank.items():
        torch.testing.assert_close(state["sampling"][k][1], v[0])
    assert state["sampling"]["key"][0].tolist() == [0, 4]


# ---------------------------------------------------------------------------
# seeded Engine.run against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(11))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(12))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size - 1, (B, P)).astype(np.int32)
    return (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp), prompts


def _engines(models, mode, policy=POLICY, **kw):
    (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp), _ = models
    use_d = mode != "none"
    ek = dict(K=K if use_d else 0, max_new_tokens=MAX_NEW, drafter_mode=mode,
              max_len=MAX_LEN, **kw)
    je = JEngine(jcfg, jdcfg if use_d else None, jp, jdp if use_d else None,
                 JEngineConfig(sampling=JS.SamplingParams(**policy), **ek), B)
    te = Engine(tcfg, dcfg if use_d else None, tp, dp if use_d else None,
                EngineConfig(sampling=S.SamplingParams(**policy), **ek), B,
                device="cpu")
    return je, te


def assert_rows_match(got, want, log: MarginLog, seed: int, start: int):
    """Token streams (B, W) equal from ``start`` on; a row may part only
    after a decision of margin < NEAR_TIE, and is not compared after it."""
    for b in range(got.shape[0]):
        diff = np.flatnonzero(got[b, start:] != want[b, start:])
        if len(diff):
            pos = start + int(diff[0])
            m = log.min_margin(seed, start, pos)
            assert m < NEAR_TIE, (b, pos, m)


@pytest.fixture(scope="module")
def sampled_runs(models):
    """JAX and port runs of one sampled policy per drafter mode, with
    draft sampling off and on."""
    prompts = models[2]
    out = {}
    for mode in ("parallel", "ar", "none"):
        for ds in (False, True):
            if mode == "none" and ds:
                continue
            je, te = _engines(models, mode, draft_sampling=ds)
            with MarginLog() as log:
                tr = te.run(prompts)
            out[mode, ds] = (je.run(jnp.asarray(prompts)), tr, log)
    return out


RUNS = [("parallel", False), ("parallel", True), ("ar", False), ("ar", True),
        ("none", False)]


@pytest.mark.parametrize("mode,ds", RUNS,
                         ids=[f"{m}-draft_sampling={d}" for m, d in RUNS])
def test_sampled_run_matches_jax_engine(sampled_runs, mode, ds):
    jr, tr, log = sampled_runs[mode, ds]
    assert_rows_match(tr["tokens"], np.asarray(jr["tokens"]), log,
                      POLICY["seed"], P)
    np.testing.assert_array_equal(tr["state"]["new_count"].numpy(),
                                  np.asarray(jr["state"]["new_count"]))
    assert tr["acceptance_length"] == pytest.approx(jr["acceptance_length"])
    sp = tr["state"]["sampling"]
    np.testing.assert_array_equal(
        sp["key"].numpy(),
        np.asarray(jr["state"]["sampling"]["key"]).astype(np.int64))
    assert log.margins, "the run recorded no sampled decision"


def test_sampled_runs_are_seeded(models, sampled_runs):
    """Equal seeds give equal streams; another seed another stream."""
    prompts = models[2]
    _, te = _engines(models, "parallel")
    again = te.run(prompts)["tokens"]
    np.testing.assert_array_equal(again,
                                  sampled_runs["parallel", False][1]["tokens"])
    other = te.run(prompts, sampling=S.SamplingParams(
        **dict(POLICY, seed=4)))["tokens"]
    assert (other[:, P:P + MAX_NEW] != again[:, P:P + MAX_NEW]).any()


def test_greedy_policy_run_is_the_greedy_lane(models):
    """A temperature-0 policy takes the greedy-only lane: the same tokens
    as the mixed lane on the same greedy rows."""
    prompts = models[2]
    _, te = _engines(models, "parallel", policy=dict(temperature=0.0))
    lane = te.run(prompts)["tokens"]
    state = te.prefill(prompts)
    for _ in range(MAX_NEW):
        state = te.step(state, greedy_only=False)
    np.testing.assert_array_equal(state["tokens"][:, :P + MAX_NEW].numpy(),
                                  lane[:, :P + MAX_NEW])


def _oracle(fn, table, take, arange):
    """Wrap a draft function: the drafter runs, its K drafts at anchor
    c - 1 become table[:, c+1 .. c+K]."""
    def draft(*args, **kw):
        _, logits, cache = fn(*args, **kw)
        anchor, k = args[6], args[7]
        idx = anchor[:, None] + 2 + arange(k)
        return take(table, idx), logits, cache
    return draft


def test_sampled_accept_path_matches_jax(models):
    """Under top-k 1 the warped target is the argmax's one-hot, so drafts
    read from the greedy stream (a fifth of them spoiled; one-hot q) are
    accepted up to the first spoiled one, which is rejected and resampled:
    the sampled lane's keys, uniforms, multi-token commit and resample run
    in both packages and agree."""
    prompts = models[2]
    _, greedy = _engines(models, "none", policy=dict(temperature=0.0))
    base = greedy.run(prompts)["tokens"]
    rng = np.random.default_rng(3)
    vocab = models[1][0].vocab_size
    base = np.where(rng.random(base.shape) < 0.2, (base + 1) % (vocab - 1),
                    base).astype(np.int32)
    table = np.concatenate([base, base[:, -1:].repeat(K + 2, 1)], 1)
    policy = dict(temperature=0.7, top_k=1, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        jt = jnp.asarray(table)
        mp.setattr(JD, "draft_parallel", _oracle(
            JD.draft_parallel, jt, lambda t, i: jnp.take_along_axis(t, i, 1),
            lambda k: jnp.arange(k, dtype=jnp.int32)))
        tt = torch.from_numpy(table)
        mp.setattr(D, "draft_parallel", _oracle(
            D.draft_parallel, tt, lambda t, i: t.gather(1, i.long()),
            torch.arange))
        je, te = _engines(models, "parallel", policy=policy)
        with MarginLog() as log:
            tr = te.run(prompts)
        jr = je.run(jnp.asarray(prompts))
    assert jr["acceptance_length"] > 2.0
    assert_rows_match(tr["tokens"], np.asarray(jr["tokens"]), log,
                      policy["seed"], P)
    np.testing.assert_array_equal(tr["tokens"][:, :P + MAX_NEW],
                                  greedy.run(prompts)["tokens"][:, :P + MAX_NEW])
    assert tr["acceptance_length"] == pytest.approx(jr["acceptance_length"])


def test_decode_state_converts_the_policy(models, sampled_runs):
    """The JAX engine's state converts with its policy subtree (uint32
    keys as int64 words), equal to the port's own."""
    jr, tr, _ = sampled_runs["parallel", False]
    got = convert.decode_state(jax.tree.map(np.asarray, jr["state"]),
                               models[1][0])["sampling"]
    want = tr["state"]["sampling"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["parallel", "ar"])
def test_sampled_drafts_match_jax(models, mode):
    """Drafts drawn under a policy (one sampled row, a greedy row, a
    top-k 1 row) after the same prefill: the same tokens as the JAX
    drafter's, logits within 3e-5."""
    (jcfg, jdcfg, jp, jdp), (tcfg, dcfg, tp, dp), prompts = models
    je, te = _engines(models, mode)
    js, ts = je.prefill(jnp.asarray(prompts)), te.prefill(prompts)
    temp = np.array([0.9, 0.0, 1.3], np.float32)
    top_k = np.array([40, 0, 1], np.int32)
    top_p = np.array([0.9, 1.0, 1.0], np.float32)
    c = np.full((B,), P, np.int32)
    jkeys = JS.draft_keys(js["sampling"], jnp.asarray(c) + 1, K)
    tkeys = S.draft_keys(ts["sampling"], torch.from_numpy(c) + 1, K)
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.asarray(jkeys).astype(np.int64))
    fn = "draft_parallel" if mode == "parallel" else "draft_ar"
    jd, jl, _ = getattr(JD, fn)(
        jdcfg, jcfg, jdp, js["dcache"], js["tokens"][:, P], js["taps_last"],
        jnp.asarray(c) - 1, K,
        policy=(jkeys, *map(jnp.asarray, (temp, top_k, top_p))))
    with torch.no_grad():
        td, tl, _ = getattr(D, fn)(
            dcfg, tcfg, dp, ts["dcache"], ts["tokens"][:, P],
            ts["taps_last"], torch.from_numpy(c) - 1, K,
            policy=(tkeys, *map(torch.from_numpy, (temp, top_k, top_p))))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the greedy row keeps the argmax; the top-k 1 row draws it
    np.testing.assert_array_equal(td[1:].numpy(),
                                  tl[1:].argmax(-1).numpy())


def test_margins_are_the_decisions_gaps():
    """``serving.margins``: a draw's margin is the top-2 gap of the JAX
    package's perturbed log-probabilities (within float32 noise), and a
    greedy row has none."""
    from repro_torch.serving.margins import sample_margins
    lg = _logits(4, (3, 60))
    t = np.array([0.8, 0.0, 1.2], np.float32)
    k = np.array([0, 0, 7], np.int32)
    p = np.array([0.9, 1.0, 1.0], np.float32)
    jk = jax.random.split(jax.random.PRNGKey(6), 3)
    probs = np.asarray(JSD.warp_probs(*map(jnp.asarray, (lg[:, None], t, k,
                                                          p))))[:, 0]
    with np.errstate(divide="ignore"):             # log 0 = -inf, kept
        z = np.log(probs) + np.asarray(jax.vmap(
            lambda key: jax.random.gumbel(key, (60,)))(jk))
    z = np.sort(z, -1)
    want = z[:, -1] - z[:, -2]
    got = sample_margins(words(jk), *map(torch.from_numpy,
                                         (lg, t, k, p))).numpy()
    assert np.isinf(got[1])
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=1e-5)

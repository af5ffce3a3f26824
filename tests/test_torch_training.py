"""The port's drafter-training path against the JAX package on the reduced
qwen2-1.5b in float32: the data pipeline, the drafter's training forward
(five hidden-state variants, both attention branches), the losses, AdamW
and gradient accumulation, and whole and segmented ``Trainer`` steps, all
from converted JAX parameters and the same numpy inputs. Then invariants
inside the port (segmented grads equal whole grads; remat changes nothing),
checkpoints and the launcher.

Tolerances: forward values 3e-5 (float32 on both sides, reductions in
another order); gradients, optimizer moments and updated parameters atol
2e-5, rtol 2e-4 (tests/test_partition.py's); pipeline batches, corpora and
greedy rollouts exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.core import losses as JLS
from repro.data import pipeline as JP
from repro.models import get_model as jget_model
from repro.optim import GradAccumulator as JGradAccumulator
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import linear_warmup_schedule as jschedule
from repro.training import TrainConfig as JTrainConfig
from repro.training import Trainer as JTrainer
from repro_torch import convert, prng
from repro_torch.checkpoint import latest_step, load_pytree, save_pytree
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.core import drafter as D
from repro_torch.core import losses as LS
from repro_torch.data import pipeline as P
from repro_torch.launch import train as train_launch
from repro_torch.models.registry import get_model
from repro_torch.optim import (GradAccumulator, adamw_init, adamw_update,
                               apply_updates, linear_warmup_schedule)
from repro_torch.training import TrainConfig, Trainer
from repro_torch.tree import leaves_with_paths, tree_map

TOL = 3e-5
GTOL = dict(atol=2e-5, rtol=2e-4)
VARIANTS = ("shared", "depth_encoding", "ntp_hidden", "ntp_hidden_depth",
            "regularized")


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def _flat(tree):
    return {k: v.detach().numpy() for k, v in leaves_with_paths(tree)}


def _same_tree(port, jax_tree, **tol):
    """A port drafter-layout tree against a JAX drafter-layout tree."""
    want = _flat(convert.drafter_params(np_tree(jax_tree)))
    got = _flat(port)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=convert.target_params(np_tree(jp), tcfg))


def _drafters(s, **kw):
    jd = JDrafterConfig(**kw).resolve(s["jcfg"])
    d = DrafterConfig(**kw).resolve(s["tcfg"])
    jdp = JD.init_params(jd, s["jcfg"], jax.random.PRNGKey(3))
    return jd, d, jdp, convert.drafter_params(np_tree(jdp))


def _mtp_inputs(s, B, n, K, r, seed=0, per_row=True):
    rng = np.random.default_rng(seed)
    vocab, dt = s["tcfg"].vocab_size, s["tcfg"].d_model
    tokens = rng.integers(0, vocab - 1, (B, n)).astype(np.int32)
    taps = (0.3 * rng.standard_normal((B, n, 3 * dt))).astype(np.float32)
    M = int(np.ceil(P.cod.expanded_length(n, K, r) / 64) * 64)
    rows = [P.cod.pad_to(*P.cod.sample_cod(rng, n, K, r), M)
            for _ in range(B if per_row else 1)]
    pos = np.stack([p for p, _ in rows])
    dep = np.stack([d for _, d in rows])
    if not per_row:
        pos, dep = pos[0], dep[0]
    return tokens, taps, pos, dep


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("segments", [1, 2, 3])
def test_pipeline_batches_equal(segments):
    corpus = P.markov_corpus(0, 8, 24, 1024, branch=2)
    np.testing.assert_array_equal(corpus,
                                  JP.markov_corpus(0, 8, 24, 1024, branch=2))
    kw = dict(k_train=3, cod_rate=0.7, batch=2, seed=1, segments=segments)
    got, want = list(P.MTPPipeline(corpus, **kw)), list(JP.MTPPipeline(corpus,
                                                                      **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        gl, wl = (g, w) if segments > 1 else ([g], [w])
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            for f in ("tokens", "pos", "depth", "labels"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.weight == b.weight


def test_self_generated_corpus_equals_jax(setup):
    s = setup
    kw = dict(seed=1, n_seqs=3, seq_len=16, batch=2)
    got = P.self_generated_corpus(get_model(s["tcfg"]), s["tp"], device="cpu",
                                  **kw)
    want = JP.self_generated_corpus(jget_model(s["jcfg"]), s["jp"], **kw)
    assert got.shape == (3, 16) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# drafter training forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_mtp_forward_matches_jax(setup, variant):
    """Per-row metadata, M < 512: the plain blocked attention on both
    sides. The regularized variant runs without dropout (rng None): the
    two packages' random streams differ."""
    s = setup
    jd, d, jdp, dp = _drafters(s, n_layers=2, k_train=4,
                               hidden_state_variant=variant)
    tokens, taps, pos, dep = _mtp_inputs(s, 2, 32, 4, 0.7)
    jl, jh = JD.mtp_forward(jd, s["jcfg"], jdp, jnp.asarray(tokens),
                            jnp.asarray(taps), jnp.asarray(pos),
                            jnp.asarray(dep))
    tl, th = D.mtp_forward(d, s["tcfg"], dp, torch.from_numpy(tokens),
                           torch.from_numpy(taps), torch.from_numpy(pos),
                           torch.from_numpy(dep))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_regularized_dropout_draws_from_the_generator(setup):
    """With a key the regularized variant drops 10% of its injection, the
    mask drawn by threefry as the JAX package draws it: the forward equals
    the JAX forward under the same key; equal keys give equal outputs,
    other keys and no key differ."""
    s = setup
    jd, d, jdp, dp = _drafters(s, n_layers=1, k_train=4,
                               hidden_state_variant="regularized")
    arrays = _mtp_inputs(s, 2, 32, 4, 0.7)
    tokens, taps, pos, dep = (torch.from_numpy(a) for a in arrays)

    def run(seed):
        rng = None if seed is None else prng.fold_in(prng.PRNGKey(seed), 7)
        return D.mtp_forward(d, s["tcfg"], dp, tokens, taps, pos, dep,
                             rng=rng)[0]
    plain, a, b = run(None), run(1), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, plain)
    assert not torch.allclose(run(2), a)
    jl, _ = JD.mtp_forward(jd, s["jcfg"], jdp,
                           *(jnp.asarray(x) for x in arrays),
                           rng=jax.random.fold_in(jax.random.PRNGKey(1), 7))
    np.testing.assert_allclose(a.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("branch", ["blocked", "flash"])
def test_mtp_forward_grads_match_jax(setup, branch):
    """Gradients of the mean MTP loss with respect to every drafter leaf,
    on both of the JAX switch's branches (M >= 512 with flash_train: the
    flash training attention; else the plain blocked attention)."""
    s = setup
    n, shared = (200, True) if branch == "flash" else (32, False)
    jd, d, jdp, dp = _drafters(s, n_layers=1, k_train=4)
    tokens, taps, pos, dep = _mtp_inputs(s, 1, n, 4, 0.8, per_row=not shared)
    assert (pos.shape[-1] >= 512) == (branch == "flash")
    labels = np.where(dep >= 0, np.roll(tokens[0], -2)[np.clip(pos, 0, n - 1)],
                      -1).astype(np.int32).reshape(1, -1)

    def jloss(p):
        lg, _ = JD.mtp_forward(jd, s["jcfg"], p, jnp.asarray(tokens),
                               jnp.asarray(taps), jnp.asarray(pos),
                               jnp.asarray(dep))
        return JLS.mtp_loss(lg, jnp.asarray(labels), jnp.asarray(dep))[0]

    jval, jg = jax.value_and_grad(jloss)(jdp)
    params = tree_map(lambda t: t.clone().requires_grad_(True), dp)
    tl, _ = D.mtp_forward(d, s["tcfg"], params, torch.from_numpy(tokens),
                          torch.from_numpy(taps), torch.from_numpy(pos),
                          torch.from_numpy(dep))
    val = LS.mtp_loss(tl, torch.from_numpy(labels), torch.from_numpy(dep))[0]
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=TOL)
    _same_tree(tree_map(lambda t: t.grad, params), jg, **GTOL)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_mtp_loss_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    B, M, V = 2, 40, 64
    logits = (2 * rng.standard_normal((B, M, V))).astype(np.float32)
    labels = rng.integers(-1, V, (B, M)).astype(np.int32)
    depth = rng.integers(-1, 4, (B, M)).astype(np.int32)
    labels[0, :8] = logits[0, :8].argmax(-1)       # some hits
    for dd in (depth, depth[0]):
        for decay in (1.0, 0.8):
            jl, jm = JLS.mtp_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(dd), depth_weight_decay=decay)
            tl, tm = LS.mtp_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(dd),
                                 depth_weight_decay=decay)
            assert tm.keys() == jm.keys()
            np.testing.assert_allclose(tl.item(), float(jl), rtol=TOL)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=TOL, err_msg=k)


def test_hca_loss_matches_jax():
    rng = np.random.default_rng(1)
    h, t = (rng.standard_normal((2, 12, 16)).astype(np.float32) * 1.5
            for _ in range(2))
    valid = (rng.random((2, 12)) < 0.7).astype(np.float32)
    np.testing.assert_allclose(
        LS.hca_loss(*(torch.from_numpy(a) for a in (h, t, valid))).item(),
        float(JLS.hca_loss(*(jnp.asarray(a) for a in (h, t, valid)))),
        rtol=TOL)


def test_ttt_forward_loss_matches_jax(setup):
    s = setup
    jd, d, jdp, dp = _drafters(s, n_layers=1, parallel=False, ttt_steps=2,
                               hca=True)
    tokens, taps, _, _ = _mtp_inputs(s, 2, 20, 2, 0.5)

    def jloss(p):
        return JLS.ttt_forward_loss(jd, s["jcfg"], p, jnp.asarray(tokens),
                                    jnp.asarray(taps))
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jdp)
    params = tree_map(lambda t: t.clone().requires_grad_(True), dp)
    tl, tm = LS.ttt_forward_loss(d, s["tcfg"], params,
                                 torch.from_numpy(tokens),
                                 torch.from_numpy(taps))
    tl.backward()
    assert params["h_shared"].grad is None      # the AR drafter never reads it
    params["h_shared"].grad = torch.zeros_like(params["h_shared"])
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    _same_tree(tree_map(lambda t: t.grad, params), jg, **GTOL)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_and_accumulator_match_jax_over_three_steps():
    rng = np.random.default_rng(2)
    shapes = {"w": (4, 3), "b": (3,), "blocks": {"ln": (5,), "s": ()}}

    def draw(scale):
        return jax.tree.map(
            lambda shp: np.asarray(scale * rng.standard_normal(shp),
                                   np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params = draw(1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jst, tst = jadamw_init(jp), adamw_init(tp)
    jsched, tsched = jschedule(1e-2, 10, 0.2), linear_warmup_schedule(1e-2, 10,
                                                                      0.2)
    jacc, tacc = JGradAccumulator(jp).init(), GradAccumulator(tp).init()
    for step in range(3):
        g = draw(0.5 if step else 3.0)             # step 0 clips
        jacc = JGradAccumulator.add(jacc, jax.tree.map(jnp.asarray, g),
                                    step + 1.0)
        tacc = GradAccumulator.add(tacc, jax.tree.map(torch.from_numpy, g),
                                   step + 1.0)
        ju, jst, jm = jadamw_update(jax.tree.map(jnp.asarray, g), jst, jp,
                                    lr=jsched, weight_decay=0.1)
        tu, tst, tm = adamw_update(jax.tree.map(torch.from_numpy, g), tst,
                                   tp, lr=tsched, weight_decay=0.1)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = apply_updates(tp, tu)
        assert int(tst.step) == int(jst.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for name, t, j in (("updates", tu, ju), ("m", tst.m, jst.m),
                           ("v", tst.v, jst.v), ("params", tp, jp)):
            for (path, a), b in zip(leaves_with_paths(t),
                                    jax.tree.leaves(j)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           err_msg=f"{name} {path}", **GTOL)
    for (path, a), b in zip(leaves_with_paths(GradAccumulator.mean(tacc)),
                            jax.tree.leaves(JGradAccumulator.mean(jacc))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=path,
                                   **GTOL)


# ---------------------------------------------------------------------------
# whole training steps against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(setup):
    """Two whole-sequence and two segmented (segments 2) steps of both
    trainers from the same converted drafter, on the same batches; and two
    segmented steps of the regularized variant, whose dropout keys both
    trainers split from the same stream."""
    s = setup
    corpus = P.markov_corpus(0, 8, 24, s["tcfg"].vocab_size, branch=2)
    out = {}
    for segments, variant in ((1, "shared"), (2, "shared"),
                              (2, "regularized")):
        kw = dict(n_layers=1, k_train=3, hidden_state_variant=variant)
        jd, d = (JDrafterConfig(**kw).resolve(s["jcfg"]),
                 DrafterConfig(**kw).resolve(s["tcfg"]))
        tc = dict(lr=2e-3, total_steps=20, warmup_ratio=0.1)
        jtr = JTrainer(s["jcfg"], jd, s["jp"], JTrainConfig(**tc), seed=0)
        init = np_tree(jtr.dparams)
        tr = Trainer(s["tcfg"], d, s["tp"], TrainConfig(**tc),
                     dparams=convert.drafter_params(init), device="cpu")
        # each trainer takes its own package's batches (equal, as
        # test_pipeline_batches_equal pins)
        pkw = dict(k_train=3, cod_rate=0.7, batch=2, seed=0,
                   segments=segments)
        batches = zip(list(P.MTPPipeline(corpus, **pkw))[:2],
                      list(JP.MTPPipeline(corpus, **pkw))[:2])
        logs = [(tr.train_batch(b), jtr.train_batch(jb)) for b, jb in batches]
        key = segments if variant == "shared" else variant
        out[key] = dict(tr=tr, jtr=jtr, logs=logs, init=init)
    return out


@pytest.mark.parametrize("segments", [1, 2, "regularized"])
def test_trainer_steps_match_jax(trained, segments):
    r = trained[segments]
    for tm, jm in r["logs"]:
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
    tr, jtr = r["tr"], r["jtr"]
    assert int(tr.opt_state.step) == int(jtr.opt_state.step) == 2
    # the moments are linear in the grads: held elementwise
    _same_tree(tr.opt_state.m, jtr.opt_state.m, **GTOL)
    _same_tree(tr.opt_state.v, jtr.opt_state.v, atol=1e-9, rtol=4e-4)
    # the parameters: Adam divides by sqrt(v), so an element whose gradient
    # is float noise on both sides (~1e-10) takes a full lr-sized step of
    # either sign. Per leaf: the update (p - p0) agrees in norm to 1e-3, at
    # most 1e-4 of the elements leave the gradient tolerance, and none
    # differs by more than two lr-sized steps of opposite sign.
    lr_sum = sum(jm["lr"] for _, jm in r["logs"])
    got, want = _flat(tr.dparams), _flat(convert.drafter_params(
        np_tree(jtr.dparams)))
    init = _flat(convert.drafter_params(r["init"]))
    assert got.keys() == want.keys()
    for k in got:
        du, dw = got[k] - init[k], want[k] - init[k]
        assert np.linalg.norm(dw) > 0, k                     # it moved
        assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw), k
        diff = np.abs(got[k] - want[k])
        out = diff > GTOL["atol"] + GTOL["rtol"] * np.abs(want[k])
        assert out.sum() <= 1e-4 * out.size, (k, int(out.sum()))
        assert diff.max() <= 2 * 2 * lr_sum, (k, diff.max())


# ---------------------------------------------------------------------------
# invariants inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_trainer(setup):
    s = setup
    d = DrafterConfig(n_layers=1, k_train=3).resolve(s["tcfg"])
    return Trainer(s["tcfg"], d, s["tp"], TrainConfig(), seed=4, device="cpu")


@pytest.mark.parametrize("S", [2, 3])
def test_segmented_grads_equal_whole_grads(setup, port_trainer, S):
    """The valid-token-weighted mean of the segment grads is the gradient of
    the whole-sequence mean loss (each query in one segment, with its whole
    context)."""
    corpus = P.markov_corpus(1, 2, 24, setup["tcfg"].vocab_size)
    kw = dict(k_train=3, cod_rate=0.7, batch=2, seed=5)
    whole = next(iter(P.MTPPipeline(corpus, **kw)))
    segs = next(iter(P.MTPPipeline(corpus, segments=S, **kw)))
    assert len(segs) == S
    gw, mw = port_trainer.batch_grads(whole)
    gs, _ = port_trainer.batch_grads(segs)
    assert sum(float((sg.labels >= 0).sum()) for sg in segs) == float(
        mw["valid_tokens"])
    fw, fs = _flat(gw), _flat(gs)
    for k in fw:
        np.testing.assert_allclose(fs[k], fw[k], err_msg=k, **GTOL)


def test_remat_gives_equal_grads(setup, port_trainer):
    corpus = P.markov_corpus(2, 2, 24, setup["tcfg"].vocab_size)
    batch = next(iter(P.MTPPipeline(corpus, k_train=3, cod_rate=0.7, batch=2,
                                    seed=6)))
    base, _ = port_trainer.batch_grads(batch)
    d = port_trainer.dcfg
    try:
        port_trainer.dcfg = dataclasses.replace(d, remat=True)
        remat, _ = port_trainer.batch_grads(batch)
    finally:
        port_trainer.dcfg = d
    fb, fr = _flat(base), _flat(remat)
    for k in fb:
        np.testing.assert_array_equal(fr[k], fb[k], err_msg=k)


def test_frozen_embeddings_get_zero_grads(setup, port_trainer):
    corpus = P.markov_corpus(3, 2, 24, setup["tcfg"].vocab_size)
    batch = next(iter(P.MTPPipeline(corpus, k_train=3, cod_rate=0.7, batch=2,
                                    seed=7)))
    d = port_trainer.dcfg
    try:
        port_trainer.dcfg = dataclasses.replace(d, freeze_embeddings=True)
        g, _ = port_trainer.batch_grads(batch)
    finally:
        port_trainer.dcfg = d
    assert g["embed"].abs().max().item() == 0.0
    assert g["fuse"].abs().max().item() > 0.0


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(port_trainer, tmp_path):
    tree = {"params": port_trainer.dparams, "opt": port_trainer.opt_state,
            "bf16": torch.linspace(-3, 3, 7).to(torch.bfloat16)}
    save_pytree(tree, str(tmp_path), "state", step=3, metadata={"k": 1})
    save_pytree(tree, str(tmp_path), "state", step=12)
    assert latest_step(str(tmp_path)) == 12
    blank = tree_map(torch.zeros_like, tree)
    back = load_pytree(blank, str(tmp_path), "state")
    assert type(back["opt"]).__name__ == "AdamWState"
    for (k, a), (_, b) in zip(leaves_with_paths(tree),
                              leaves_with_paths(back)):
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="shape"):
        load_pytree({"bf16": torch.zeros(3)}, str(tmp_path), "state", step=3)


def test_train_launcher_rehearses_on_cpu(tmp_path, capsys):
    r = train_launch.main(["--reduced", "--device", "cpu", "--epochs", "1",
                           "--n-seqs", "4", "--batch", "2", "--seq-len", "24",
                           "--layers", "1", "--segments", "2",
                           "--ckpt", str(tmp_path)])
    assert r["steps"] == 2 and r["device"] == "cpu"
    assert np.isfinite(r["loss"]) and r["label_tokens_per_s"] > 0
    assert r["peak_memory_gb"] is None
    assert latest_step(str(tmp_path)) == 2
    assert '"label_tokens_per_s"' in capsys.readouterr().out


def test_train_launcher_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--reduced", "--epochs", "1", "--n-seqs", "2",
                           "--batch", "2", "--seq-len", "16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config("qwen2-1.5b").reduced(),
                DrafterConfig(n_layers=1).resolve(
                    get_config("qwen2-1.5b").reduced()), {}, TrainConfig())

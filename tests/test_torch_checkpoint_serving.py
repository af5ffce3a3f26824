"""A trained drafter from its checkpoint to serving, on the CPU.

Against the JAX package: it trains reduced-qwen2 drafters (1 layer, the
P-EAGLE one and the AR EAGLE-3 one, 20 steps on 16 of the target's own
rollouts), writes each with ``repro.checkpoint.save_pytree`` and serves it
through ``load_pytree``. The port reads the same files through
``convert.jax_checkpoint`` and ``convert.drafter_params`` (its target from
``convert.target_params``) and serves them in float32: ``Engine.run``
(contiguous) and ``Scheduler.serve`` (paged) give the same tokens, AL and
scheduler events, with AL above 1.3 on the corpus's own prompts.

The port's own round trip: ``launch.train.main --reduced --device cpu``
writes a drafter that ``launch.serve.main --reduced --device cpu --ckpt``
serves with its leaves bitwise the trained ones, an AL above the random
drafter's on the same requests (the corpus's first prompts,
``data.corpus_prompts``) and streams equal to ``--mode none``. The
train launcher's target and ``build_engine``'s are bitwise the same draw.
A checkpoint that does not fit the template raises, naming the leaf (the
JAX launcher instead serves a random drafter); with none, the report
says the drafter is random."""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.data import MTPPipeline as JMTPPipeline
from repro.data import self_generated_corpus as jself_generated_corpus
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.training import TrainConfig as JTrainConfig
from repro.training import Trainer as JTrainer
from repro_torch import convert
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.core import drafter as D
from repro_torch.data import corpus_prompts
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.sharding.rules import serve_param_specs
from repro_torch.sharding.utils import Mesh, Shard, shard_tree
from repro_torch.tree import leaves_with_paths
import torch_serving_setup as setup
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ROOT = Path(__file__).resolve().parents[1]
NAME = "drafter_qwen2-1.5b"
K, B, P, NEW, STEPS = 4, 4, 4, 24, 20
PAGED = dict(kv_layout="paged", page_size=8, pool_pages=6)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX package's target, corpus, and per kind (``parallel``,
    ``ar``) its drafter config, the checkpoint directory it wrote and the
    drafter it loads back from there."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = jget_config("qwen2-1.5b").reduced()
    model = jget_model(jcfg)
    jp = model.init(jax.random.PRNGKey(0))
    corpus = jself_generated_corpus(model, jp, seed=1, n_seqs=16, seq_len=40,
                                    prompt_len=P, batch=16)
    out = {}
    for kind in ("parallel", "ar"):
        jdcfg = JDrafterConfig(n_layers=1, k_train=6, k_infer=K,
                               parallel=kind == "parallel").resolve(jcfg)
        pipe = JMTPPipeline(corpus, k_train=6, cod_rate=0.8, batch=16,
                            seed=0)
        tr = JTrainer(jcfg, jdcfg, jp, JTrainConfig(lr=3e-3,
                                                    total_steps=STEPS))
        tr.train(pipe, epochs=STEPS)
        ckpt = str(root / kind)
        jsave_pytree(tr.dparams, ckpt, NAME, step=STEPS)
        tmpl = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(0))
        out[kind] = (jdcfg, ckpt, jload_pytree(tmpl, ckpt, NAME))
    return jcfg, jp, np.asarray(corpus), out


@pytest.fixture(scope="module")
def port_side(trained):
    """The port's target (converted) and, per kind, the drafter read from
    the JAX checkpoint."""
    jcfg, jp, _, drafters = trained
    tcfg = get_config("qwen2-1.5b").reduced()
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    out = {}
    for kind, (jdcfg, ckpt, _) in drafters.items():
        dcfg = DrafterConfig(n_layers=1, k_train=6, k_infer=K,
                             parallel=kind == "parallel").resolve(tcfg)
        out[kind] = (dcfg, convert.drafter_params(
            convert.jax_checkpoint(ckpt, NAME)))
    return tcfg, tp, out


def test_corpus_prompts_open_the_jax_corpus(trained):
    """``data.corpus_prompts`` gives the prompts the JAX package's (and the
    port's) ``self_generated_corpus`` rolls out, row for row."""
    jcfg, corpus = trained[0], trained[2]
    np.testing.assert_array_equal(
        corpus_prompts(jcfg.vocab_size, seed=1, n_seqs=16, prompt_len=P,
                       batch=16), corpus[:, :P])


@pytest.mark.parametrize("kind", ["parallel", "ar"])
def test_jax_checkpoint_reads_into_the_port_tree(trained, port_side, kind):
    """Every leaf the port reads equals the JAX package's ``load_pytree``
    of the same file, bitwise, in its layer order."""
    want = convert.drafter_params(jax.tree.map(np.asarray,
                                               trained[3][kind][2]))
    got = port_side[2][kind][1]
    assert [p for p, _ in leaves_with_paths(got)] == \
        [p for p, _ in leaves_with_paths(want)]
    for (p, a), (_, b) in zip(leaves_with_paths(got),
                              leaves_with_paths(want)):
        assert a.dtype == b.dtype == torch.float32, p
        assert torch.equal(a, b), p


def _engines(trained, port_side, kind, **kw):
    jcfg, jp, _, drafters = trained
    tcfg, tp, port = port_side
    jdcfg, _, jdp = drafters[kind]
    dcfg, dp = port[kind]
    cfg = dict(K=K, max_new_tokens=NEW, drafter_mode=kind, max_len=64, **kw)
    return (JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(**cfg), B),
            Engine(tcfg, dcfg, tp, dp, EngineConfig(**cfg), B, device="cpu"))


@pytest.mark.parametrize("kind", ["parallel", "ar"])
def test_engine_run_matches_jax_engine(trained, port_side, kind):
    """``Engine.run`` (contiguous) on the corpus's prompts: tokens equal,
    AL equal and above 1.3 (the drafter accepts)."""
    prompts = trained[2][:B, :P]
    je, te = _engines(trained, port_side, kind)
    jr, tr = je.run(prompts), te.run(prompts)
    np.testing.assert_array_equal(tr["tokens"], np.asarray(jr["tokens"]))
    assert tr["acceptance_length"] == pytest.approx(jr["acceptance_length"])
    assert jr["acceptance_length"] > 1.3


@pytest.mark.parametrize("kind", ["parallel", "ar"])
def test_paged_serve_matches_jax_scheduler(trained, port_side, kind):
    """``Scheduler.serve`` over paged KV: 6 of the corpus's prompts with
    budgets of 8 to 16 and Exp(1) arrival gaps, on a pool that preempts:
    per request tokens, AL and counters, and the event trace, equal."""
    corpus = trained[2]
    rng = np.random.default_rng(5)
    work = [(corpus[i, :P], int(b), float(t)) for i, b, t in zip(
        range(6), rng.integers(8, 17, 6),
        np.cumsum(rng.exponential(1.0, 6)))]
    je, te = _engines(trained, port_side, kind, **PAGED)
    jr = JScheduler(je).serve([JRequest(p, max_new_tokens=b, arrival_time=t,
                                        rid=i)
                               for i, (p, b, t) in enumerate(work)])
    tr = Scheduler(te).serve([Request(p, max_new_tokens=b, arrival_time=t,
                                      rid=i)
                              for i, (p, b, t) in enumerate(work)])
    setup.assert_same_serve(tr, jr)
    for t, j in zip(tr["results"], jr["results"]):
        assert t["acceptance_length"] == pytest.approx(
            j["acceptance_length"])
    assert tr["weighted_acceptance_length"] == pytest.approx(
        jr["weighted_acceptance_length"])
    assert jr["weighted_acceptance_length"] > 1.3
    assert jr["preemptions"] > 0


# ---------------------------------------------------------------------------
# the port's own round trip: the training launcher, then the serving one
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--reduced", "--device", "cpu", "--epochs", "10", "--n-seqs",
              "32", "--batch", "16", "--seq-len", "40", "--layers", "1",
              "--k-train", "6", "--lr", "3e-3"]
SERVE_ARGS = ["--reduced", "--device", "cpu", "--layers", "1", "--k", "4",
              "--max-new", "36", "--max-len", "48", "--requests", "6",
              "--batch", "3", "--mean-gap", "1", "--runs", "1"]


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """The tree the training launcher saved, its checkpoint directory, and
    per serve (``none``, ``parallel`` from the checkpoint, ``random``: a
    directory with no checkpoint) the launcher's report and the engine and
    scheduler report behind it."""
    root = tmp_path_factory.mktemp("port_ckpt")
    saved, served = [], []
    save, serve = train_launch.save_pytree, Scheduler.serve

    def keep_saved(tree, *a, **kw):
        saved.append(tree)
        return save(tree, *a, **kw)

    def keep_served(self, *a, **kw):
        rep = serve(self, *a, **kw)
        served.append((self.engine, rep))
        return rep
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_launch, "save_pytree", keep_saved)
        mp.setattr(Scheduler, "serve", keep_served)
        train = train_launch.main(TRAIN_ARGS + ["--ckpt", str(root / "ck")])
        # the corpus's first prompts: on unseen ones a drafter trained on a
        # random target's rollouts accepts next to nothing
        np.save(root / "prompts.npy", corpus_prompts(
            get_config("qwen2-1.5b").reduced().vocab_size, seed=1,
            n_seqs=6, batch=16))
        out = {}
        for way, mode, ckpt in (("none", "none", root / "ck"),
                                ("parallel", "parallel", root / "ck"),
                                ("random", "parallel", root / "empty")):
            rep = serve_launch.main(SERVE_ARGS + [
                "--mode", mode, "--ckpt", str(ckpt),
                "--prompts", str(root / "prompts.npy")])
            out[way] = (rep,) + served[-1]
    return saved[0], train, str(root / "ck"), out


def _streams(rep):
    return [r["tokens"] for r in sorted(rep["results"],
                                        key=lambda r: r["rid"])]


def test_round_trip_serves_the_trained_leaves(round_trip):
    """The served drafter's leaves are bitwise the trained ones (float32
    reduced: no cast), and the report names the checkpoint."""
    trained_tree, train, ckpt, out = round_trip
    rep, eng, _ = out["parallel"]
    assert rep["drafter"] == {"source": "checkpoint",
                              "path": train["checkpoint"],
                              "step": train["steps"]}
    got, want = leaves_with_paths(eng.dparams), leaves_with_paths(
        trained_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert out["random"][0]["drafter"] == {"source": "random", "path": None,
                                           "step": None}
    assert out["none"][0]["drafter"] is None


def test_round_trip_accepts_more_than_a_random_drafter(round_trip):
    """On the same requests the trained drafter's AL is above the random
    one's, and both greedy streams equal ``--mode none``'s."""
    out = round_trip[3]
    al = {w: out[w][0]["acceptance_length"] for w in out}
    assert al["none"] == 1.0
    assert al["parallel"] > al["random"], al
    ref = _streams(out["none"][2])
    for way in ("parallel", "random"):
        for a, b in zip(_streams(out[way][2]), ref):
            np.testing.assert_array_equal(a, b)


def test_train_and_serve_launchers_draw_the_same_target():
    """The training launcher's target (seed 0 at the config's dtype) and
    ``build_engine``'s (``seed`` 0 after its dtype and depth cut) are
    bitwise the same draw: a drafter is served against what it learned."""
    tcfg = serve_launch.target_config("qwen2-1.5b", reduced=True)
    model = get_model(tcfg, torch.device("cpu"))
    gen = torch.Generator().manual_seed(train_launch.TARGET_SEED)
    want = model.init(gen, device="cpu")
    eng = serve_launch.build_engine(reduced=True, device="cpu", mode="none",
                                    max_new=4, max_len=16, batch=1)
    got = leaves_with_paths(eng.tparams)
    assert [p for p, _ in got] == [p for p, _ in leaves_with_paths(want)]
    for (p, a), (_, b) in zip(got, leaves_with_paths(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def _random_drafter(tmp, n_layers, variant="shared"):
    """A reduced-qwen2 drafter of ``n_layers`` with random weights, written
    where the serving launcher looks for it; its config."""
    tcfg = serve_launch.target_config("qwen2-1.5b", reduced=True)
    dcfg = DrafterConfig(n_layers=n_layers,
                         hidden_state_variant=variant).resolve(tcfg)
    dp = D.init_params(dcfg, tcfg, torch.Generator().manual_seed(3),
                       device="cpu")
    save_pytree(dp, str(tmp), NAME, step=7)
    return tcfg, dcfg, dp


@pytest.mark.parametrize("written, served, variant, leaf", [
    (2, 4, "shared", "blocks/2/ln1"),          # missing: another --layers
    (4, 2, "shared", "blocks/2"),              # extra: another --layers
    (2, 2, "ntp_hidden", "ntp_proj"),          # another hidden-state variant
])
def test_checkpoint_that_does_not_fit_raises_naming_the_leaf(
        tmp_path, written, served, variant, leaf):
    """A drafter written with one depth (or hidden-state variant) and served
    with another raises, naming a leaf that does not fit; the JAX launcher
    instead catches every exception of its load (``src/repro/launch/
    serve.py:157-162``), prints ``no checkpoint (...); using random
    drafter`` and serves a random drafter at AL about 1: its ``load_pytree``
    raises on such a file, and the launcher swallows it."""
    _random_drafter(tmp_path, written, variant)
    with pytest.raises(ValueError, match=leaf):
        serve_launch.main(SERVE_ARGS + ["--ckpt", str(tmp_path), "--layers",
                                        str(served), "--prompt-len", "4"])
    if variant != "shared":
        return
    jcfg = jget_config("qwen2-1.5b").reduced()
    key = jax.random.PRNGKey(0)
    jsave_pytree(JD.init_params(JDrafterConfig(n_layers=written).resolve(
        jcfg), jcfg, key), str(tmp_path / "jax"), NAME, step=7)
    tmpl = JD.init_params(JDrafterConfig(n_layers=served).resolve(jcfg),
                          jcfg, key)
    with pytest.raises(ValueError, match="shape"):
        jload_pytree(tmpl, str(tmp_path / "jax"), NAME)
    src = (ROOT / "src" / "repro" / "launch" / "serve.py").read_text()
    assert re.search(r"try:\n\s+dparams = load_pytree\(tmpl, args\.ckpt, "
                     r"f\"drafter_\{args\.arch\}\"\)\n.*\n\s+except "
                     r"Exception as e:\n\s+print\(f\"no checkpoint \(\{e\}\); "
                     r"using random drafter\"\)\n\s+dparams = tmpl", src)


def test_sharded_load_keeps_each_ranks_slice(tmp_path):
    """Under a mesh the checkpoint is read leaf by leaf through
    ``sharding.rules.slice_keeper``: each sharded leaf is cut to this
    rank's slice as it is read, and the tree equals the whole read tree cut
    afterwards, slice for slice (rank 0 of a described 2-rank mesh)."""
    tcfg, dcfg, dp = _random_drafter(tmp_path, 1)
    mesh = Mesh.describe(("model",), (2,))
    got, found = serve_launch.load_drafter(dcfg, tcfg, str(tmp_path),
                                           device="cpu", mesh=mesh)
    assert found[0] == 7
    want = shard_tree(dp, serve_param_specs(dp, mesh), mesh)
    flat = leaves_with_paths(got)
    assert [p for p, _ in flat] == [p for p, _ in leaves_with_paths(want)]
    cut = 0
    for (p, a), (_, b) in zip(flat, leaves_with_paths(want)):
        assert type(a) is type(b), p
        if isinstance(a, Shard):
            cut += 1
            assert a.spec == b.spec and torch.equal(a.local, b.local), p
        else:
            assert torch.equal(a, b), p
    assert cut > 0


def test_serve_stream_serves_the_checkpoint(round_trip):
    """The NDJSON server with ``--ckpt`` (``--layers`` of the checkpoint)
    names the checkpoint it serves, and the demo client streams a request
    through it to its budget."""
    import signal
    import subprocess
    import sys
    ckpt = round_trip[2]
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_stream", "--reduced",
         "--device", "cpu", "--port", "0", "--batch", "2", "--max-len", "64",
         "--max-new", "8", "--page-size", "8", "--layers", "1", "--k", "4",
         "--ckpt", ckpt],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
    try:
        line = server.stdout.readline()
        port = re.search(r"server on [\d.]+:(\d+) ", line)
        assert port, line
        assert f"drafter {ckpt}/step_" in line, line
        code = ("from repro_torch.launch import serve_stream; "
                "serve_stream.main(['--client', '--port', '"
                + port.group(1) + "', '--requests', '1', '--max-new', '6'])")
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "r0: 6 tokens" in out.stdout
    finally:
        server.send_signal(signal.SIGINT)
        assert server.wait(timeout=60) == 0

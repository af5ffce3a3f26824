"""The plain reference against the port on tiny configurations, on the CPU
(float32: both sides compute the same mathematics, so they agree to
rounding), and what the reference and the harness may import.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.lib import common, weights as W
from bench.reference import model as R

BENCH = Path(__file__).resolve().parents[1]


def tiny_config(layers=3):
    cfg = common.load_json(BENCH / "configs" / "qwen2-1.5b.json")
    cfg["target"].update(n_layers=layers, d_model=128, n_heads=4,
                         n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
                         dtype="float32")
    cfg["drafter"].update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256)
    return cfg


def draw(cfg, seed=3):
    trees = W.draw({"target": W.target_layout(cfg["target"]),
                    "drafter": W.drafter_layout(cfg["drafter"],
                                                cfg["target"])},
                   seed, "cpu", torch.float32)
    return trees["target"], trees["drafter"]


@pytest.mark.parametrize("layers", [2, 3, 5])
def test_target_matches_port(layers):
    from bench.lib.serve import model_configs
    from repro_torch.models import transformer as T
    cfg = tiny_config(layers)
    tp, _ = draw(cfg)
    tcfg, _ = model_configs(cfg)
    tokens = torch.randint(0, 511, (40,), generator=torch.Generator()
                           .manual_seed(1))
    out = T.forward(tcfg, tp, tokens[None], mode="train", collect_taps=True)
    at = torch.arange(10, 39)
    logits, taps = R.target_forward(cfg["target"], tp, tokens, at)
    torch.testing.assert_close(logits, out.logits[0, at], atol=2e-5,
                               rtol=2e-5)
    torch.testing.assert_close(taps, out.taps[0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("anchors", [[20], [7, 20, 33]])
def test_draft_matches_port(anchors):
    """The port's extend over the context, then its parallel draft at each
    anchor, against the reference's one causal pass."""
    from bench.lib.serve import model_configs
    from repro_torch.core import drafter as D
    from repro_torch.models import transformer as T
    cfg = tiny_config()
    tp, dp = draw(cfg)
    tcfg, dcfg = model_configs(cfg)
    K = cfg["drafter"]["k_infer"]
    tokens = torch.randint(0, 511, (40,), generator=torch.Generator()
                           .manual_seed(2))
    taps = T.forward(tcfg, tp, tokens[None], mode="train").taps
    ref = R.draft_logits(cfg["drafter"], cfg["target"], dp, tokens, taps[0],
                         anchors, K)
    for s, a in enumerate(anchors):
        cache = D.make_cache(dcfg, 1, 64, dtype=torch.float32, device="cpu")
        pos = torch.arange(a, dtype=torch.int32)[None]
        D.extend(dcfg, tcfg, dp, cache, tokens[None, 1:a + 1], taps[:, :a],
                 pos)
        toks, logits, _ = D.draft_parallel(
            dcfg, tcfg, dp, cache, tokens[a + 1:a + 2].int(),
            taps[:, a], torch.tensor([a], dtype=torch.int32), K)
        torch.testing.assert_close(ref[s], logits[0], atol=3e-5, rtol=3e-5)


def test_fp8_control_moves_logits():
    cfg = tiny_config()
    tp, _ = draw(cfg)
    tokens = torch.randint(0, 511, (30,), generator=torch.Generator()
                           .manual_seed(4))
    at = torch.arange(29)
    exact, _ = R.target_forward(cfg["target"], tp, tokens, at)
    low, _ = R.target_forward(cfg["target"], tp, tokens, at, prec="fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.5


def test_fp8_rounds_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -448.0, 17.0]])
    q = R.fp8(x, -1)
    assert q[0, 2] == -448.0 and q[0, 0] == 1.0
    assert (q - x).abs().max() <= 448.0 * 2 ** -4


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_torch_alone():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "typing", "torch"}, (path, tops)


def test_harness_imports_no_jax_stack():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not common.forbidden_modules(tops), (path, tops)


def test_forbidden_compares_whole_names():
    assert common.forbidden_modules(["repro_torch.serving", "numpy"]) == []
    assert common.forbidden_modules(["repro.core", "jaxlib.xla"]) == [
        "jaxlib", "repro"]
    assert common.forbidden_modules(["flax"]) == ["flax"]


def test_weights_are_the_seeds():
    cfg = tiny_config()
    a, _ = draw(cfg, seed=2 ** 31 + 11)
    b, _ = draw(cfg, seed=2 ** 31 + 11)
    c, _ = draw(cfg, seed=2 ** 31 + 12)
    assert torch.equal(a["blocks"][1]["mlp"]["w_up"],
                       b["blocks"][1]["mlp"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
    # gains about 1, biases small, projections at 1 / sqrt(fan-in)
    assert 0.5 < float(a["blocks"][0]["ln1"].mean()) < 1.5
    assert float(a["blocks"][0]["attn"]["bq"].abs().max()) <= 0.06 + 1e-6
    w = a["blocks"][0]["attn"]["wq"]
    assert float(w.std()) == pytest.approx(1 / np.sqrt(128), rel=0.1)

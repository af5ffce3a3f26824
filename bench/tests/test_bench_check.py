"""What decides ``correct``, driven through the rest of a run on the CPU
at a tiny size (the harness's look for a card skipped): a sound run is
correct, a run with its timed path broken is not, and the control reads
above the program on the same sample.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench.lib import common, serve

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def tiny(loop="closed"):
    cfg = common.load_json(BENCH / "configs" / "qwen2-1.5b.json")
    cfg["target"].update(n_layers=3, d_model=128, n_heads=4, n_kv_heads=2,
                         head_dim=32, d_ff=256, vocab_size=512,
                         dtype="float32")
    cfg["drafter"].update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256)
    mix = {"driver": "serve", "loop": loop, "clients": 4, "pool": 16,
           "prompt_len": [8, 40], "output_len": [6, 30],
           "residual_first": True, "rate_per_s": 4.0, "lead_s": 0.5,
           "engine": {"slots": 4, "K": 3, "page_size": 8, "max_len": 80,
                      "pool_pages": 40},
           "check": {"requests": 3, "draft_steps": 2}}
    return cfg, mix


def run_tiny(loop="closed", seed=2 ** 31 + 5, **kw):
    cfg, mix = tiny(loop)
    torch.set_num_threads(2)
    return serve.run({"name": "tiny"}, cfg, mix, seed=seed, seconds=2.0,
                     trace=False, device="cpu", t_start=time.perf_counter(),
                     **kw)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_sound_run_is_correct(loop):
    out = run_tiny(loop)
    assert out["correct"], out["checks"]
    assert out["readings"]["served_tokens"] > 0 and out["failed"] == 0
    assert all(out["checks"][k]["limit"] is not None
               for k in ("target_gap", "draft_gap"))


def test_token_altered_where_produced_is_not_correct(monkeypatch):
    from repro_torch.core import spec_decode as SD
    orig = SD.greedy_verify

    def altered(drafts, logits):
        accept, t_star = orig(drafts, logits)
        return accept, (t_star + 1) % logits.shape[-1]
    monkeypatch.setattr(SD, "greedy_verify", altered)
    out = run_tiny()
    assert not out["correct"]
    c = out["checks"]["target_gap"]
    assert c["value"] > c["limit"]


def test_draft_altered_where_produced_is_not_correct(monkeypatch):
    from repro_torch.core import drafter as D
    orig = D.draft_parallel

    def altered(*a, **kw):
        toks, logits, cache = orig(*a, **kw)
        return (toks + 1) % logits.shape[-1], logits, cache
    monkeypatch.setattr(D, "draft_parallel", altered)
    out = run_tiny()
    assert not out["correct"]
    c = out["checks"]["draft_gap"]
    assert c["value"] > c["limit"]


def test_control_reads_above_the_program():
    """The reference in float8 in the program's place: at this size it
    stays under the full-width limits, but on the same sample it reads
    above the float32 program, which matches the reference's argmax."""
    out = run_tiny(controls=("fp8",))
    prog, ctl = out["readings"], out["controls"]["fp8"]
    assert ctl["served_tokens"] == prog["served_tokens"] > 0
    assert ctl["target_gap"] > prog["target_gap"]
    assert ctl["draft_gap"] > prog["draft_gap"]


def test_run_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would measure")
    cmd = [sys.executable, "bench/run.py", "--workload",
           "qwen2-1.5b.reasoning-rollouts", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA" in done.stderr


def test_run_fails_with_the_benchmark_alone(tmp_path):
    """A checkout of BENCHMARK.json and bench/ alone, without the
    program, gives no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "bench/run.py", "--workload",
           "qwen2-1.5b.rag-long-prompt", "--seed", "1", "--seconds", "1",
           "--trace", "1"]
    done = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0 and done.stdout == ""

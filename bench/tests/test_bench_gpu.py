"""One short run of each cell on the card: the result line's keys, the
device, a correct check, and the traced line's per-layer metrics. Needs a
CUDA card; skips without one.

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \
        bench/tests/test_bench_gpu.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench.lib import common

ROOT = Path(__file__).resolve().parents[2]
BENCH = common.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run(cell, trace, seed=2 ** 31 + 101):
    cmd = [sys.executable, "bench/run.py", "--workload", cell, "--seed",
           str(seed), "--seconds", "8", "--trace", str(trace)]
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, cell, trace):
    line = run(cell, trace)
    assert line["correct"] and line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in common.cell_metrics(BENCH, cell, kind)}
    assert set(line["metrics"]) == want
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        for name, m in line["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100, name
        assert line["breakdown"]["device_ops"]
    assert list(line)[-1] == "checks"

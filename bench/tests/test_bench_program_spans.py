"""The program's own spans (``repro_torch.tracing``) against the harness's
trace of the same stretch, one short traced run of each cell on the card:
as many ``engine.step`` spans as the stretch's iterations, each inside the
harness's ``bench.engine.step`` range around the same call; as many
``engine.admit`` spans as ``bench.engine.admit`` ranges; no span dropped;
and no program span name among the device operations (the program opens
no profiler range, which kineto would mirror onto the card). Needs a CUDA
card; skips without one.

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \
        bench/tests/test_bench_program_spans.py

Each run is a process of its own, this file run as a script, which prints
the counts, the gaps (µs) between each step span and its range, and by
span name the calls, host ms and device busy ms an iteration as its last
line:

    python3 bench/tests/test_bench_program_spans.py <cell> <seed> <seconds>
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [p for p in (str(ROOT), str(ROOT / "src"))
                if p not in sys.path]

from bench.lib import common  # noqa: E402

BENCH = common.load_json(ROOT / "BENCHMARK.json")


def _inside(steps, ranges):
    """(start gap, end gap) in µs of each step span (t0, t1 ns) inside the
    range (name, start s, end s) that holds its midpoint; None for a span
    that no range holds."""
    out, j = [], 0
    ranges = sorted(ranges, key=lambda r: r[1])
    for s in steps:
        mid = (s.t0 + s.t1) * 0.5e-9
        while j < len(ranges) and ranges[j][2] < mid:
            j += 1
        if j < len(ranges) and ranges[j][1] <= mid:
            out.append(((s.t0 * 1e-9 - ranges[j][1]) * 1e6,
                        (ranges[j][2] - s.t1 * 1e-9) * 1e6))
        else:
            out.append(None)
    return out


def probe(cell: str, seed: int, seconds: str) -> dict:
    """One traced run of ``cell`` through ``bench/run.py``'s ``main``,
    then the program's log held against the run's ``TraceData``."""
    from bench import run as R
    from bench.lib import serve
    from bench.lib import spans as S
    from repro_torch import tracing
    kept = []
    orig = serve.run

    def run(*a, **kw):
        out = orig(*a, **kw)
        kept.append(out["record"].trace)
        return out
    serve.run = run
    rc = R.main(["--workload", cell, "--seed", str(seed), "--seconds",
                 seconds, "--trace", "1"])
    tr = kept[-1]
    spans = tracing.spans()
    steps = [s for s in spans if s.name == "engine.step"]
    gaps = _inside(steps, [r for r in tr.spans
                           if r[0] == "bench.engine.step"])
    held = [g for g in gaps if g is not None]
    by_span = {}
    for s in S.program_spans() or ():
        by_span.setdefault(s.name, []).append(s)
    n = max(len(steps), 1)
    return {
        "rc": rc, "iterations": tr.iterations, "dropped": tracing.dropped(),
        "step_spans": len(steps),
        "steps_inside_ranges": sum(1 for a, b in held if a >= 0 and b >= 0),
        "admit_spans": sum(1 for s in spans if s.name == "engine.admit"),
        "admit_ranges": sum(1 for r in tr.spans
                            if r[0] == "bench.engine.admit"),
        "names_among_device_ops": sorted(
            {s.name for s in spans} & {k[0] for k in tr.kernels}),
        "start_gap_us": [min((a for a, _ in held), default=None),
                         max((a for a, _ in held), default=None)],
        "end_gap_us": [min((b for _, b in held), default=None),
                       max((b for _, b in held), default=None)],
        "by_span": {name: [len(sp),
                           1e3 * sum(x.end - x.start for x in sp) / n,
                           1e3 * S.device_seconds(tr.kernels, sp) / n]
                    for name, sp in by_span.items()}}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_program_spans_match_the_harness_trace(card, cell):
    done = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), cell,
         str(2 ** 31 + 103), "8"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    print(cell, json.dumps(got))
    assert got["rc"] == 0 and got["dropped"] == 0
    assert got["step_spans"] == got["iterations"] > 0
    assert got["steps_inside_ranges"] == got["step_spans"]
    assert got["admit_spans"] == got["admit_ranges"]
    assert got["names_among_device_ops"] == []


if __name__ == "__main__":
    print(json.dumps(probe(sys.argv[1], int(sys.argv[2]), sys.argv[3])))

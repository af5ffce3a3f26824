"""The metric readers on synthetic records (a stall inside the window
that every end-to-end metric shows, requests censored at the window's end),
and the benchmark file against its contract.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import re
from pathlib import Path

import pytest

from bench.lib import common
from bench.lib.counts import Work
from bench.lib.record import Record, ReqRecord, TraceData

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def read(name, rec):
    return common.metric_reader(name)(rec)


def steady(stall=0.0, n_req=20, w=(100.0, 110.0)):
    """Requests due every 0.5 s from 100 s, each answered 0.2 s after its
    due time, then a token every 0.1 s, four in all; a step every 0.1 s.
    With ``stall``, the system stops at 104 s for that long: everything
    it would have done from then on happens that much later."""
    def at(t):
        return t + stall if t >= 104.0 else t
    reqs = []
    for i in range(n_req):
        due = 100.0 + 0.5 * i
        times = [at(due + 0.2 + 0.1 * k) for k in range(4)]
        reqs.append(ReqRecord(due=due, prompt_len=8, budget=4,
                              t_first=times[0], times=times,
                              t_admit=times[0], finished=True))
    steps = [at(100.0 + 0.1 * k) for k in range(100)]
    return Record(setup_s=3.0, window=w, requests=reqs, step_times=steps,
                  flops=[(t, 1e12) for t in steps])


def test_e2e_on_a_steady_window():
    rec = steady()
    assert read("output_tokens_per_s", rec) == pytest.approx(80 / 10)
    assert read("ttft_p50_ms", rec) == pytest.approx(200.0)
    assert read("tpot_p95_ms.host", rec) == pytest.approx(100.0)
    assert read("setup_s", rec) == 3.0
    assert read("iteration_ms", rec) == pytest.approx(100.0)
    assert read("admission_wait_p50_ms", rec) == pytest.approx(200.0)
    assert read("step_mfu.serve", rec) == pytest.approx(
        100 * 100e12 / 989e12 / 10)


def test_a_stall_shows_in_every_end_to_end_metric():
    base, stalled = steady(), steady(stall=3.0)
    for name in ("output_tokens_per_s", "step_mfu.serve"):
        assert read(name, stalled) < read(name, base)
    for name in ("ttft_p50_ms", "ttft_p95_ms.host", "tpot_p95_ms.host",
                 "iteration_ms"):
        assert read(name, stalled) > read(name, base)


def test_censored_requests_count_at_their_age():
    rec = steady()
    # two requests due in the window never got a first token; one failed
    rec.requests.append(ReqRecord(due=109.0, prompt_len=8, budget=4))
    rec.requests.append(ReqRecord(due=108.0, prompt_len=8, budget=4,
                                  error="RuntimeError()"))
    ttft = sorted([200.0] * 20 + [1000.0, 2000.0])
    assert read("ttft_p95_ms.host", rec) == pytest.approx(
        common.percentile(ttft, 95))
    # due before the window: not in the window's tail
    rec.requests.append(ReqRecord(due=90.0, prompt_len=8, budget=4))
    assert read("ttft_p95_ms.host", rec) == pytest.approx(
        common.percentile(ttft, 95))


def test_trace_readers_silent_without_trace():
    rec = steady()
    for name in ("kernel_launches_per_iteration", "gemm_ms_per_iteration",
                 "paged_decode_attention_roofline",
                 "flash_attention_roofline", "device_idle_share.serve"):
        assert read(name, rec) is None
    rec.trace = TraceData(window_s=2.0, iterations=10, kernels=[],
                          spans=[], calls=[])
    assert read("device_idle_share.serve", rec) is None
    assert read("kernel_launches_per_iteration", rec) is None


def test_trace_readers():
    flash = "void flash_tc_attention_kernel<128>(Params)"
    w = Work(flops=989e12 * 0.01, bytes=1.0)        # 10 ms at the peak
    rec = steady()
    rec.trace = TraceData(
        window_s=1.0, iterations=4,
        kernels=[(flash, 0.0, 0.04), ("nvjet_tst_x", 0.05, 0.02),
                 ("elementwise", 0.5, 0.14)],
        spans=[], calls=[("flash_attention", w)])
    assert read("flash_attention_roofline", rec) == pytest.approx(25.0)
    assert read("device_idle_share.serve", rec) == pytest.approx(80.0)
    assert read("kernel_launches_per_iteration", rec) == pytest.approx(0.75)
    assert read("gemm_ms_per_iteration", rec) == pytest.approx(5.0)


def test_percentile_and_spread():
    assert common.percentile([], 50) is None
    assert common.percentile([1, 2, 3, 4], 50) == 2.5
    assert common.percentile([5.0], 95) == 5.0
    assert common.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_benchmark_file_keeps_the_contract():
    bench = common.load_json(ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in bench["workloads"]}
    names = list(cells) + [c["name"] for c in bench["configs"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (common.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    assert len(set(names)) == len(names) and all(map(NAME.match, names))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {
            "name", "unit", "better", "source", "layer", "moves",
            "workloads"}
        for cell in m.get("workloads", cells):
            # the metric it moves is one that cell reports
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (common.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert sum(1 for m in bench["per_layer"]
                   if w["name"] in m.get("workloads", cells)) >= 1
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(
        cells)

"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration's file and its
traffic mix's file by name, and hands them to the driver the mix names
(``bench/lib/<driver>.py``). With ``--trace 0`` the last line of standard
output carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (one reader a metric, ``bench/metrics/<name>.py``) and
the trace's breakdown. The numbers ``correct`` was decided on follow,
each beside its limit, as the last lines on standard error and under
``checks``, the line's last key.

Exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), when a module of the JAX stack or of the JAX package
is loaded, or when the run fails.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import common  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(bench: dict, cell: str, out: dict, trace: bool) -> dict:
    """The cell's metrics of this kind, each read from the run by its own
    reader; a reader that finds nothing leaves its metric out."""
    kind = "per_layer" if trace else "end_to_end"
    got = {}
    for m in common.cell_metrics(bench, cell, kind):
        value = common.metric_reader(m["name"])(out["record"])
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def breakdown(rec) -> dict:
    from bench.lib import trace as TRC
    tr = rec.trace
    return {"device_ops": TRC.top_ops(tr.kernels),
            "idle_gaps": TRC.idle_gaps(tr.kernels, tr.spans)}


def main(argv=None) -> int:
    args = parse(argv)
    cell, bench, config, mix = common.load_cell(args.workload)
    common.set_cache_env()
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"bench: cell {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    # one process with few threads: the host work is one Python thread
    # that launches kernels; an intra-op pool would only contend with it
    torch.set_num_threads(2)
    driver = importlib.import_module(f"bench.lib.{mix['driver']}")
    out = driver.run(cell, config, mix, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda",
                     t_start=T_START)
    found = common.forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    rec = out["record"]
    device = common.device_facts(torch)
    device["memory_peak_bytes"] = int(out["peak"])
    extra = None
    if args.trace:
        from bench.lib import trace as TRC
        device["busy_s"] = TRC.busy_seconds(rec.trace.kernels)
        device["window_s"] = rec.trace.window_s
        extra = breakdown(rec)
    line = common.result_line(
        correct=out["correct"], attempted=out["attempted"],
        failed=out["failed"],
        metrics=metrics_of(bench, cell["name"], out, bool(args.trace)),
        device=device, checks=out["checks"], breakdown=extra)
    print(json.dumps({"notes": out["notes"]}), file=sys.stderr)
    print(json.dumps({"readings": out["readings"]}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

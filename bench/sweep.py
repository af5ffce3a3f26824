"""Sweep the arrival rate of an open-loop serving cell, to find its knee.

    python3 bench/sweep.py --workload <cell> --seconds <s> --seed <n> \
        --rates <r> [<r> ...]

One run of the cell a rate (its mix's ``rate_per_s`` replaced), printing
one JSON line each: the tokens per second completed, the tails of time to
first token and between tokens, the requests due and finished in the
window and how late the generator ran. The knee is the highest rate whose
completed work keeps up with its arrivals without a growing backlog; a
cell then runs at a fixed rate in its mix's file. The benchmark's own runs
never run this.
"""
import time

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell, _, config, mix = common.load_cell(args.workload)
    common.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"bench.lib.{mix['driver']}")
    for rate in args.rates:
        out = driver.run(cell, config, dict(mix, rate_per_s=rate),
                         seed=args.seed, seconds=args.seconds, trace=False,
                         device="cuda", t_start=time.perf_counter())
        rec = out["record"]
        w0, w1 = rec.window
        row = {"rate_per_s": rate,
               "due": sum(1 for r in rec.requests if w0 <= r.due < w1),
               "finished_in_window": sum(
                   1 for r in rec.requests
                   if r.finished and r.times and w0 <= r.times[-1] <= w1)}
        # a growing backlog: requests due late in the window wait longer
        # for admission than those due early
        third = (w1 - w0) / 3
        for part, lo in (("first", w0), ("last", w1 - third)):
            waits = [r.t_admit - r.due for r in rec.requests
                     if lo <= r.due < lo + third and r.t_admit]
            row[f"admission_wait_mean_s.{part}_third"] = (
                sum(waits) / len(waits) if waits else None)
        for name in ("output_tokens_per_s", "ttft_p50_ms", "ttft_p95_ms.host",
                     "tpot_p95_ms.host",
                     "admission_wait_p50_ms", "iteration_ms"):
            row[name] = common.metric_reader(name)(rec)
        row["notes"] = out["notes"]
        row["readings"] = out["readings"]
        print(json.dumps(row), flush=True)
        del out, rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

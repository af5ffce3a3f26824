"""The lower and upper readings of a serving cell's limits, on the card.

    python3 bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, one run of the cell at its own size and load (a short
window), then the check's readings of the program (``target_gap``,
``draft_gap``) and of the control on the same sample: the plain reference
with its matrix products in float8 e4m3, the precision below the served
bfloat16, put in the program's place. One JSON line a seed, then the
largest program reading and the smallest control reading of each gap. The
benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell, _, config, mix = common.load_cell(args.workload)
    common.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"bench.lib.{mix['driver']}")
    rows = []
    for seed in args.seeds:
        out = driver.run(cell, config, mix, seed=seed, seconds=args.seconds,
                         trace=False, device="cuda",
                         t_start=time.perf_counter(), controls=("fp8",))
        row = {"seed": seed, "program": out["readings"],
               "fp8": out["controls"]["fp8"], "failed": out["failed"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    for key in ("target_gap", "draft_gap"):
        print(json.dumps({key: {
            "program_max": max(r["program"][key] for r in rows),
            "fp8_min": min(r["fp8"][key] for r in rows)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

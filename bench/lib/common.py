"""Shared pieces of the benchmark harness: the cell lookup, the run's
environment, device facts, the import guard, statistics and the result
line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (``configs/<config>.json``), the traffic mix's file
(``traffic/<traffic>.json``, whose ``driver`` names the module of
``bench/lib`` that runs it) and one reader a metric
(``metrics/<metric>.py``). A new cell, mix or metric is a new file.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
# top-level module names that no process of the benchmark may load: the
# JAX stack and the JAX package beside the port (compared whole, so the
# port's ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT):
    """(cell, benchmark, config, traffic) of ``workload`` from the
    benchmark file at ``root``; raises KeyError for an unknown cell."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, bench, config, traffic


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_cache_env(root: Path = ROOT) -> None:
    """Point every cache a run may fill at fixed directories inside the
    checkout, so that only a checkout's first run builds anything. The
    port's kernels build into ``build/repro_torch`` (``kernels/build.py``)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    forbidden, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_facts(torch) -> dict:
    """The card's name, count, memory and power limit (``nvidia-smi``)."""
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": 1,
             "memory_total_bytes": torch.cuda.get_device_properties(0)
             .total_memory}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        facts["nvidia_smi"] = out.stdout.strip().splitlines()[:1]
    except (OSError, subprocess.TimeoutExpired) as e:
        facts["nvidia_smi"] = [f"not read: {e}"]
    return facts


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def percentile(values: List[float], p: float) -> Optional[float]:
    """The ``p``-th percentile by linear interpolation between order
    statistics (numpy's default); None for no values."""
    if not values:
        return None
    xs = sorted(values)
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def spread(values: List[float]) -> float:
    """Inter-quartile distance over the median, as
    ``statistics.quantiles(values, n=4)`` gives the quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def log_uniform_quantiles(lo: int, hi: int, n: int) -> List[int]:
    """``n`` integers at the mid-quantiles of a log-uniform law on
    [lo, hi]: the same multiset for every seed."""
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def exponential_quantiles(mean: float, n: int) -> List[float]:
    """``n`` mid-quantiles of an exponential law of mean ``mean``."""
    return [-mean * math.log(1.0 - (i + 0.5) / n) for i in range(n)]


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict], breakdown: Optional[dict] = None
                ) -> str:
    """The run's last line on standard output: the contract's keys, then
    the numbers compared beside their limits under ``checks``, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)

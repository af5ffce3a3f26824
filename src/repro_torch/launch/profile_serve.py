"""Where a serving step's time goes on the card: profile a window of
decode steps of the full-width engine with ``torch.profiler``.

Builds the engine as ``launch/serve.py`` does (qwen2-1.5b bfloat16, 4-layer
parallel drafter, batch 8, 512-token prompts), prefills, runs warm-up
steps, then times 16 unprofiled steps and profiles 16 more. With
``--kv-layout paged`` the cache is a page pool (page 16, pages reserved up
front) and each prompt is admitted into its slot as the scheduler admits
it, so the steps are the scheduler's steps without its host loop. Prints, per
step: the host-clock time of the unprofiled window (synchronized at both
ends), the device time summed over every kernel and
copy the profiler recorded, the device's idle share
(1 - device time / host time), and the kernels by device time, grouped
(the port's attention kernels, matrix products, everything else) and the
15 largest one by one.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--kv-layout paged]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.launch.serve import build_engine, random_prompts

BATCH, PROMPT, WARMUP, STEPS = 8, 512, 8, 16


def _group(name: str) -> str:
    if "attention_kernel" in name:
        return "attention kernels (port)"
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                              "matmul", "splitk")):
        return "matrix products (cuBLAS)"
    return "other kernels and copies"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="parallel", choices=("parallel", "ar", "none"))
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=("contiguous", "paged"))
    args = ap.parse_args(argv)
    steps = STEPS

    max_new = WARMUP + 2 * steps + 2
    eng = build_engine(mode=args.mode, batch=BATCH, seed=0, max_new=max_new,
                       max_len=-(-(PROMPT + max_new + 6) // 16) * 16,
                       kv_layout=args.kv_layout,
                       kv_growth="upfront")
    prompts = random_prompts(eng.tcfg.vocab_size, BATCH, PROMPT, 0)
    if eng.paged:
        state = eng.blank_state()
        for slot, p in enumerate(prompts):
            state, _, _ = eng.prefill_into_slot(state, p, slot, max_new)
        live = (torch.ones(BATCH, dtype=torch.bool, device=eng.device),
                torch.full((BATCH,), max_new, dtype=torch.int32,
                           device=eng.device),
                torch.full((BATCH,), eng.ecfg.K, dtype=torch.int32,
                           device=eng.device))
    else:
        state, live = eng.prefill(prompts), ()
    for _ in range(WARMUP):
        state = eng.step(state, *live)
    torch.cuda.synchronize()
    t0 = time.perf_counter()           # a window without the profiler
    for _ in range(steps):
        state = eng.step(state, *live)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state = eng.step(state, *live)
        torch.cuda.synchronize()

    # device-side events only (kernels, copies, sets): the CPU ops that
    # launched them carry the same time again
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    device_ms = sum(r[2] for r in rows) / 1e3 / steps
    groups = {}
    for name, count, us in rows:
        g = groups.setdefault(_group(name), [0, 0.0])
        g[0] += count
        g[1] += us
    report = {
        "device": torch.cuda.get_device_name(0), "mode": args.mode,
        "kv_layout": args.kv_layout,
        "steps": steps, "host_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": (1 - device_ms / wall_ms) if wall_ms else None,
        "groups": {k: {"launches_per_step": v[0] / steps,
                       "ms_per_step": v[1] / 1e3 / steps}
                   for k, v in sorted(groups.items(), key=lambda kv: -kv[1][1])},
    }
    print(f"host {wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, "
          f"idle share {report['device_idle_share']:.3f}")
    for name, count, us in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step {count / steps:7.1f}"
              f" launches/step  {name[:100]}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

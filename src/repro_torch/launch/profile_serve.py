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
(the port's attention kernels, matrix products, sorts, everything else)
and the 15 largest one by one.

With ``--temperature`` > 0 every slot samples under that policy (the flags
of ``launch/serve.py``; slot i on the key stream of ``--seed + i``), so the
steps run the sampled lane, and the lane's pieces are timed apart at the
step's shapes, as device time summed over their kernels by the profiler
(without the host's launch gaps) with kernels per call: the warp of the
target's (B, K+1, V)
float32 logits (two full-vocabulary sorts), the threefry bits and draws of
the verification (step keys, their split, the K uniforms, the resample and
bonus draws over V) and, with ``--draft-sampling``, the K draft draws.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--kv-layout paged]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --temperature 0.8 --top-k 50 --top-p 0.95 [--draft-sampling]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import prng
from repro_torch.core import spec_decode as SD
from repro_torch.launch.serve import (build_engine, random_prompts,
                                      request_policy)
from repro_torch.serving.sampling import batch_sampling_state, step_keys

BATCH, PROMPT, WARMUP, STEPS = 8, 512, 8, 16


def _group(name: str) -> str:
    if "attention_kernel" in name:
        return "attention kernels (port)"
    low = name.lower()
    if "sort" in low:
        return "sorts"
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                              "matmul", "splitk")):
        return "matrix products (cuBLAS)"
    return "other kernels and copies"


def _device_ms(fn, reps=10) -> dict:
    """Device time per call of ``fn`` (the kernels' own time, summed by the
    profiler, without the host's launch gaps) and kernels per call."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == cuda
            and e.self_device_time_total > 0]
    return {"ms": sum(e.self_device_time_total for e in rows) / 1e3 / reps,
            "launches": sum(e.count for e in rows) / reps}


def sampled_lane_ms(eng, sp, draft_sampling: bool) -> dict:
    """The sampled lane's pieces at one step's shapes, on random logits."""
    B, K, V = eng.batch, eng.ecfg.K, eng.tcfg.vocab_size
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((B, K + 1, V), generator=g, device=dev)
    samp = batch_sampling_state(sp, B, device=dev)
    pos = torch.full((B,), 600, dtype=torch.int32, device=dev)
    t, tk, tp = samp["temperature"], samp["top_k"], samp["top_p"]
    probs = SD.warp_probs(logits, t, tk, tp)
    logp = torch.log(probs[:, -1])

    def threefry():
        ks = prng.split(step_keys(samp, pos), 3)
        prng.uniform(ks[:, 0], (K,))
        prng.categorical(ks[:, 1], logp)
        prng.categorical(ks[:, 2], logp)

    out = {"warp": _device_ms(lambda: SD.warp_probs(logits, t, tk, tp)),
           "threefry_bits_and_draws": _device_ms(threefry)}
    if draft_sampling:
        keys = prng.split(step_keys(samp, pos), K)
        out["draft_draws"] = _device_ms(
            lambda: prng.categorical(keys, torch.log(probs[:, :K])))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="parallel", choices=("parallel", "ar", "none"))
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=("contiguous", "paged"))
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="every slot's temperature (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draft-sampling", action="store_true")
    args = ap.parse_args(argv)
    steps = STEPS

    def policy(i):
        return request_policy(i, temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)

    max_new = WARMUP + 2 * steps + 2
    eng = build_engine(mode=args.mode, batch=BATCH, seed=0, max_new=max_new,
                       max_len=-(-(PROMPT + max_new + 6) // 16) * 16,
                       kv_layout=args.kv_layout,
                       kv_growth="upfront", sampling=policy(0),
                       draft_sampling=args.draft_sampling)
    prompts = random_prompts(eng.tcfg.vocab_size, BATCH, PROMPT, 0)
    if eng.paged:
        state = eng.blank_state()
        for slot, p in enumerate(prompts):
            state, _, _ = eng.prefill_into_slot(state, p, slot, max_new,
                                                sampling=policy(slot))
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
        "kv_layout": args.kv_layout, "temperature": args.temperature,
        "top_k": args.top_k, "top_p": args.top_p,
        "draft_sampling": args.draft_sampling,
        "steps": steps, "host_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": (1 - device_ms / wall_ms) if wall_ms else None,
        "groups": {k: {"launches_per_step": v[0] / steps,
                       "ms_per_step": v[1] / 1e3 / steps}
                   for k, v in sorted(groups.items(), key=lambda kv: -kv[1][1])},
    }
    if args.temperature > 0:
        report["sampled_lane"] = sampled_lane_ms(eng, policy(0),
                                                 args.draft_sampling)
    print(f"host {wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, "
          f"idle share {report['device_idle_share']:.3f}")
    for name, count, us in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step {count / steps:7.1f}"
              f" launches/step  {name[:100]}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

"""Where a serving step's time goes on the card: profile a window of
decode steps of the full-width engine with ``torch.profiler``.

Builds the engine as ``launch/serve.py`` does (``--arch``, default
qwen2-1.5b, bfloat16, 4-layer parallel drafter, batch 8, ``--prompt-len``
512-token prompts; ``--n-layers`` cuts the target's depth, its widths
kept; a VLM or encoder-decoder target's stub extras drawn from the seed),
prefills, runs warm-up steps, then times 16 unprofiled steps and
profiles 16 more. With
``--kv-layout paged`` the cache is a page pool (page 16, pages reserved up
front) and each prompt is admitted into its slot as the scheduler admits
it, so the steps are the scheduler's steps without its host loop. Prints, per
step: the host-clock time of the unprofiled window (synchronized at both
ends), the device time summed over every kernel and
copy the profiler recorded, the device's idle share
(1 - device time / host time), and the kernels by device time, grouped
(the port's attention kernels, matrix products, sorts, everything else)
and the 15 largest one by one, and the memory a step holds beyond the
state it starts from (its peak over the unprofiled window: a recurrent
target's verify keeps each token's state until the commit), beside the
weights' bytes and the time the card takes to read them once at 3.35 TB/s
(the floor of a step that reads every weight, as a verify of an MoE
target whose experts are all routed to does).

The program's own spans (``repro_torch.tracing``: ``engine.step`` and
its phases ``step.draft``, ``step.verify``, ``step.accept``,
``step.commit``, ``step.extend``) are recorded over the profiled steps and
printed as a table by span: calls, host ms a step (the spans' summed
length), device busy ms a step (the union of the card's kernels and
copies inside them) and idle ms a step (the difference), beside the
increase of the program's counters (``tracing.counters()``) a step. Then
slot 0 is admitted again with its ``--prompt-len`` prompt, once to warm
and once profiled, and the same table is printed for that one admission:
``engine.admit`` and its parts ``prefill.target``, ``prefill.drafter``,
``admit.write`` and its readbacks (``sync``).

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
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch gemma2-27b
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch gemma-7b
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch mamba2-780m [--kv-layout paged]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch recurrentgemma-2b [--kv-layout paged]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch dbrx-132b --n-layers 8        # 8 of 40 layers, ~62 GB
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --temperature 0.8 --top-k 50 --top-p 0.95 [--draft-sampling]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch internvl2-1b                  # 256 vision tokens + 512
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch whisper-base --prompt-len 128  # 1500 encoder frames
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import time

import torch

from repro_torch import prng, tracing
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import spec_decode as SD
from repro_torch.launch.serve import (build_engine, random_prompts,
                                      request_policy)
from repro_torch.models.registry import make_extras
from repro_torch.serving.sampling import batch_sampling_state, step_keys

BATCH, WARMUP, STEPS = 8, 8, 16
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if tree is not None else 0


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


def _busy_union(kernels):
    """Sorted, merged (start, end) ns of the card's operations."""
    out = []
    for a, b in sorted(kernels):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(a, b, busy, starts) -> int:
    """Nanoseconds of [a, b] that ``busy`` (sorted, merged; ``starts``
    their starts) covers."""
    total = 0
    for x, y in busy[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if x >= b:
            break
        total += max(0, min(y, b) - max(x, a))
    return total


def span_table(records, kernels, steps: int, per: str = "step") -> dict:
    """By program span name: calls, host ms a step (``per``) (the spans'
    summed length), device busy ms a step (the busy union of ``kernels``,
    (start, end) ns, inside the spans) and idle ms a step."""
    busy = _busy_union(kernels)
    starts = [a for a, _ in busy]
    rows = {}
    for r in records:
        row = rows.setdefault(r.name, [0, 0, 0])
        row[0] += 1
        row[1] += r.t1 - r.t0
        row[2] += _covered(r.t0, r.t1, busy, starts)
    return {name: {"calls": n, f"host_ms_per_{per}": host / 1e6 / steps,
                   f"device_ms_per_{per}": dev / 1e6 / steps,
                   f"idle_ms_per_{per}": (host - dev) / 1e6 / steps}
            for name, (n, host, dev) in rows.items()}


def _device_events(prof):
    """(start, end) ns of the card's operations in a profile."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def admission_table(eng, state, prompt, slot: int, max_new: int,
                    sampling=None, extras=None):
    """Free slot ``slot`` and admit ``prompt`` into it again, twice: once
    to warm, once under the profiler. Returns the state and
    ``span_table`` of that one admission (``engine.admit`` and its
    parts)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for profiled in (False, True):
        state = eng.free_slot(state, slot)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        tracing.clear()
        with (torch.profiler.profile(activities=acts) if profiled
              else contextlib.nullcontext()) as prof:
            state, _, _ = eng.prefill_into_slot(
                state, prompt, slot, max_new, sampling=sampling,
                extras=extras)
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
    table = span_table(tracing.spans(), _device_events(prof), 1,
                       per="admission")
    tracing.clear()
    return state, table


def _print_table(table: dict, per: str) -> None:
    print(f"  {'program span':<16}{'calls':>7}{'host ms':>10}"
          f"{'device ms':>11}{'idle ms':>10}   (per {per})")
    for name, r in table.items():
        print(f"  {name:<16}{r['calls']:>7}"
              f"{r[f'host_ms_per_{per}']:>10.3f}"
              f"{r[f'device_ms_per_{per}']:>11.3f}"
              f"{r[f'idle_ms_per_{per}']:>10.3f}")


def _flat(tree, prefix=""):
    """The numeric leaves of a nested dict, by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)):
            out[prefix + k] = v
    return out


def counters_per_step(before: dict, after: dict, steps: int) -> dict:
    """The counters that moved, their increase a step."""
    b, a = _flat(before), _flat(after)
    return {k: (v - b.get(k, 0)) / steps for k, v in a.items()
            if v != b.get(k, 0)}


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
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the target's depth (widths stay)")
    ap.add_argument("--mode", default="parallel", choices=("parallel", "ar", "none"))
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=("contiguous", "paged"))
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="every slot's temperature (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draft-sampling", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=512)
    args = ap.parse_args(argv)
    steps = STEPS
    prompt_len = args.prompt_len

    def policy(i):
        return request_policy(i, temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)

    max_new = WARMUP + 2 * steps + 2
    vision = get_config(args.arch).vision_tokens
    eng = build_engine(arch=args.arch, n_layers=args.n_layers,
                       mode=args.mode, batch=BATCH, seed=0,
                       max_new=max_new,
                       max_len=-(-(prompt_len + vision + max_new + 6)
                                 // 16) * 16,
                       kv_layout=args.kv_layout,
                       kv_growth="upfront", sampling=policy(0),
                       draft_sampling=args.draft_sampling)
    prompts = random_prompts(eng.tcfg.vocab_size, BATCH, prompt_len, 0)
    extras = make_extras(eng.tcfg, BATCH, "prefill",
                         prng.PRNGKey(args.seed, device=eng.device))
    if eng.paged:
        state = eng.blank_state()
        for slot, p in enumerate(prompts):
            state, _, _ = eng.prefill_into_slot(
                state, p, slot, max_new, sampling=policy(slot),
                extras={k: v[slot:slot + 1] for k, v in extras.items()})
        live = (torch.ones(BATCH, dtype=torch.bool, device=eng.device),
                torch.full((BATCH,), max_new, dtype=torch.int32,
                           device=eng.device),
                torch.full((BATCH,), eng.ecfg.K, dtype=torch.int32,
                           device=eng.device))
    else:
        state, live = eng.prefill(prompts, extras), ()
    for _ in range(WARMUP):
        state = eng.step(state, *live)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(eng.device)
    torch.cuda.reset_peak_memory_stats(eng.device)
    t0 = time.perf_counter()           # a window without the profiler
    for _ in range(steps):
        state = eng.step(state, *live)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    step_peak = torch.cuda.max_memory_allocated(eng.device) - held
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    tracing.clear()
    counted = tracing.counters()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state = eng.step(state, *live)
        torch.cuda.synchronize()
    spans = span_table(tracing.spans(), _device_events(prof), steps)
    tracing.clear()
    counted = counters_per_step(counted, tracing.counters(), steps)
    state, admission = admission_table(
        eng, state, prompts[0], 0, max_new, sampling=policy(0),
        extras={k: v[:1] for k, v in extras.items()})

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
    weights = _bytes(eng.tparams) + _bytes(eng.dparams)
    report = {
        "device": torch.cuda.get_device_name(0), "arch": args.arch,
        "n_layers": eng.tcfg.n_layers, "mode": args.mode,
        "kv_layout": args.kv_layout, "prompt_len": prompt_len,
        "temperature": args.temperature,
        "top_k": args.top_k, "top_p": args.top_p,
        "draft_sampling": args.draft_sampling,
        "steps": steps, "host_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": (1 - device_ms / wall_ms) if wall_ms else None,
        "step_peak_gb": step_peak / 1e9, "state_gb": held / 1e9,
        "weights_gb": weights / 1e9,
        "weights_read_ms": weights / HBM_BYTES_PER_S * 1e3,
        "groups": {k: {"launches_per_step": v[0] / steps,
                       "ms_per_step": v[1] / 1e3 / steps}
                   for k, v in sorted(groups.items(), key=lambda kv: -kv[1][1])},
        "spans": spans, "counters_per_step": counted,
        "admission_spans": admission,
    }
    if args.temperature > 0:
        report["sampled_lane"] = sampled_lane_ms(eng, policy(0),
                                                 args.draft_sampling)
    print(f"host {wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, "
          f"idle share {report['device_idle_share']:.3f}, a step holds "
          f"{step_peak / 1e9:.3f} GB beyond the {held / 1e9:.3f} GB it "
          f"starts from")
    for name, count, us in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step {count / steps:7.1f}"
              f" launches/step  {name[:100]}")
    _print_table(spans, "step")
    print("  counters a step: " + ", ".join(
        f"{k} {v:g}" for k, v in sorted(counted.items())))
    print(f"  one admission of {prompt_len} prompt tokens into slot 0:")
    _print_table(admission, "admission")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

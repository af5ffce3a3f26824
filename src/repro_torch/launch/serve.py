"""Serve requests with greedy P-EAGLE speculative decoding through the
continuous-batching scheduler and print OTPS, acceptance length, latency
on the virtual clock, preemptions and peak KV pages.

The target is full-width qwen2-1.5b in bfloat16 with a 4-layer parallel
drafter, both with random weights drawn from ``--seed``; prompts are random
tokens from the same seed and arrive with Exp(``--mean-gap``) gaps on the
virtual clock (0: all at once). The KV cache is paged on the card and
contiguous on the CPU unless ``--kv-layout`` says otherwise. The run is
repeated and the last (warm) run is reported.

    PYTHONPATH=src python -m repro_torch.launch.serve            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \
        --mean-gap 1 --pool-pages 256          # on the card, under pressure
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --prompt-len 16 --max-new 8 --max-len 64 \
        --kv-layout paged --page-size 8 --pool-pages 12   # CPU rehearsal
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import DrafterConfig, get_config
from repro_torch.core import drafter as D
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Engine, EngineConfig, resolve_device
from repro_torch.serving.scheduler import Request, Scheduler


def build_engine(*, reduced=False, dtype=None, mode="parallel", K=5,
                 max_new=128, max_len=1024, batch=8, seed=0, device="cuda",
                 kv_layout="contiguous", page_size=16, pool_pages=0,
                 kv_growth="incremental"):
    """qwen2-1.5b + the 4-layer drafter with seeded random weights, wrapped
    in an Engine. ``dtype`` defaults to bfloat16 at full width and float32
    reduced."""
    dev = resolve_device(device)
    tcfg = get_config("qwen2-1.5b")
    if reduced:
        tcfg = tcfg.reduced()
    dtype = dtype or ("float32" if reduced else "bfloat16")
    tcfg = tcfg.replace(dtype=dtype)
    dcfg = DrafterConfig().resolve(tcfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tparams = get_model(tcfg).init(gen, device=dev)
    dparams = None
    if mode != "none":
        dparams = D.init_params(dcfg, tcfg, gen, device=dev,
                                dtype=getattr(torch, dtype))
    ecfg = EngineConfig(K=K, max_new_tokens=max_new, drafter_mode=mode,
                        cache_dtype=dtype, max_len=max_len,
                        kv_layout=kv_layout, page_size=page_size,
                        pool_pages=pool_pages, kv_growth=kv_growth)
    return Engine(tcfg, dcfg if mode != "none" else None, tparams, dparams,
                  ecfg, batch, device=dev)


def random_prompts(vocab: int, batch: int, length: int, seed: int):
    """(batch, length) int32 prompts; the drafter's mask token is avoided."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab - 1, (batch, length)).astype(np.int32)


def make_requests(vocab: int, n: int, prompt_len: int, max_new: int,
                  mean_gap: float, seed: int):
    """``n`` requests of random ``prompt_len``-token prompts and ``max_new``
    budgets, arriving with Exp(``mean_gap``) gaps (0: all at time 0)."""
    prompts = random_prompts(vocab, n, prompt_len, seed)
    gaps = (np.random.default_rng(seed + 1).exponential(mean_gap, n)
            if mean_gap > 0 else np.zeros(n))
    return [Request(p, max_new_tokens=max_new, arrival_time=float(t))
            for p, t in zip(prompts, np.cumsum(gaps))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer CPU-test config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="parallel", choices=("parallel", "ar", "none"))
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8, help="decode slots")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--mean-gap", type=float, default=0.0,
                    help="mean Exp arrival gap, virtual time units")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"),
                    default=None, help="default: paged on the card, "
                    "contiguous on the CPU")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="0 = batch * max_len / page_size")
    ap.add_argument("--kv-growth", choices=("incremental", "upfront"),
                    default="incremental")
    ap.add_argument("--no-preempt", action="store_true",
                    help="stall slots on pool exhaustion instead")
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    layout = args.kv_layout or ("paged" if dev.type == "cuda"
                                else "contiguous")
    eng = build_engine(reduced=args.reduced, mode=args.mode, K=args.k,
                       max_new=args.max_new, max_len=args.max_len,
                       batch=args.batch, seed=args.seed, device=dev,
                       kv_layout=layout, page_size=args.page_size,
                       pool_pages=args.pool_pages, kv_growth=args.kv_growth)
    n_req = args.requests or args.batch
    sched = Scheduler(eng, eos_id=args.eos_id, sync_every=args.sync_every,
                      preempt=not args.no_preempt)
    for _ in range(args.runs):
        r = sched.serve(make_requests(eng.tcfg.vocab_size, n_req,
                                      args.prompt_len, args.max_new,
                                      args.mean_gap, args.seed))
    report = {
        "device": (torch.cuda.get_device_name(eng.device)
                   if eng.device.type == "cuda" else "cpu"),
        "arch": eng.tcfg.arch_id, "reduced": args.reduced,
        "mode": args.mode, "kv_layout": layout, "batch": args.batch,
        "requests": n_req, "prompt_len": args.prompt_len,
        "new_tokens": r["total_new_tokens"], "iterations": r["iterations"],
        "otps": r["otps"], "otps_vt": r["otps_vt"],
        "acceptance_length": r["weighted_acceptance_length"],
        "preemptions": r["preemptions"], "peak_pages": r["peak_pages"],
        "p50_latency_vt": r["p50_latency_vt"],
        "p99_latency_vt": r["p99_latency_vt"],
        "makespan_vt": r["makespan_vt"], "wall_s": r["wall_s"],
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

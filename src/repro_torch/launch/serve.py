"""Serve requests with P-EAGLE speculative decoding through the
continuous-batching scheduler and print OTPS, acceptance length, latency
on the virtual clock, preemptions and peak KV pages.

``--temperature/--top-k/--top-p/--seed`` set each request's decoding
policy: temperature 0 (the default) is greedy; above 0 the request is
verified by seeded lossless rejection sampling against its warped target,
request i on the key stream of seed ``--seed + i``. ``--mixed-sampling``
makes even requests greedy and odd ones sampled in one batch, and
``--draft-sampling`` draws sampled requests' drafts from the warped
drafter distribution.

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
    PYTHONPATH=src python -m repro_torch.launch.serve --temperature 0.8 \
        --top-k 50 --seed 1 [--draft-sampling]        # sampled, on the card
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
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler


def build_engine(*, reduced=False, dtype=None, mode="parallel", K=5,
                 max_new=128, max_len=1024, batch=8, seed=0, device="cuda",
                 kv_layout="contiguous", page_size=16, pool_pages=0,
                 kv_growth="incremental", sampling=None,
                 draft_sampling=False):
    """qwen2-1.5b + the 4-layer drafter with seeded random weights, wrapped
    in an Engine. ``dtype`` defaults to bfloat16 at full width and float32
    reduced; ``sampling`` is the engine's default policy (None: greedy)."""
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
                        pool_pages=pool_pages, kv_growth=kv_growth,
                        sampling=sampling, draft_sampling=draft_sampling)
    return Engine(tcfg, dcfg if mode != "none" else None, tparams, dparams,
                  ecfg, batch, device=dev)


def random_prompts(vocab: int, batch: int, length: int, seed: int):
    """(batch, length) int32 prompts; the drafter's mask token is avoided."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab - 1, (batch, length)).astype(np.int32)


def request_policy(i: int, *, temperature=0.0, top_k=0, top_p=1.0, seed=0,
                   mixed=False) -> SamplingParams:
    """Request i's policy: greedy at temperature 0 (and for even i when
    ``mixed``), else sampled on the key stream of ``seed + i``."""
    if temperature <= 0 or (mixed and i % 2 == 0):
        return SamplingParams.greedy(seed=seed + i)
    return SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p,
                          seed=seed + i)


def make_requests(vocab: int, n: int, prompt_len: int, max_new: int,
                  mean_gap: float, seed: int, policy=None):
    """``n`` requests of random ``prompt_len``-token prompts and ``max_new``
    budgets, arriving with Exp(``mean_gap``) gaps (0: all at time 0);
    ``policy(i)`` gives request i's SamplingParams (None: the engine's)."""
    prompts = random_prompts(vocab, n, prompt_len, seed)
    gaps = (np.random.default_rng(seed + 1).exponential(mean_gap, n)
            if mean_gap > 0 else np.zeros(n))
    return [Request(p, max_new_tokens=max_new, arrival_time=float(t),
                    sampling=None if policy is None else policy(i))
            for i, (p, t) in enumerate(zip(prompts, np.cumsum(gaps)))]


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
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and prompts; request i samples on the key "
                         "stream of seed + i")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request temperature (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0, help="0 disables")
    ap.add_argument("--top-p", type=float, default=1.0, help="1.0 disables")
    ap.add_argument("--mixed-sampling", action="store_true",
                    help="even requests greedy, odd ones at --temperature")
    ap.add_argument("--draft-sampling", action="store_true",
                    help="sampled requests draw their drafts from the warped "
                         "drafter distribution (greedy ones are unchanged)")
    args = ap.parse_args(argv)
    if args.mixed_sampling and args.temperature <= 0:
        ap.error("--mixed-sampling needs --temperature > 0")

    dev = resolve_device(args.device)
    layout = args.kv_layout or ("paged" if dev.type == "cuda"
                                else "contiguous")
    eng = build_engine(reduced=args.reduced, mode=args.mode, K=args.k,
                       max_new=args.max_new, max_len=args.max_len,
                       batch=args.batch, seed=args.seed, device=dev,
                       kv_layout=layout, page_size=args.page_size,
                       pool_pages=args.pool_pages, kv_growth=args.kv_growth,
                       draft_sampling=args.draft_sampling)
    n_req = args.requests or args.batch
    sched = Scheduler(eng, eos_id=args.eos_id, sync_every=args.sync_every,
                      preempt=not args.no_preempt)

    def policy(i):
        return request_policy(i, temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed, mixed=args.mixed_sampling)
    for _ in range(args.runs):
        r = sched.serve(make_requests(eng.tcfg.vocab_size, n_req,
                                      args.prompt_len, args.max_new,
                                      args.mean_gap, args.seed, policy))
    report = {
        "device": (torch.cuda.get_device_name(eng.device)
                   if eng.device.type == "cuda" else "cpu"),
        "arch": eng.tcfg.arch_id, "reduced": args.reduced,
        "mode": args.mode, "kv_layout": layout, "batch": args.batch,
        "temperature": args.temperature, "top_k": args.top_k,
        "top_p": args.top_p, "mixed_sampling": args.mixed_sampling,
        "draft_sampling": args.draft_sampling,
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

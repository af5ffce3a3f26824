"""Serve a fixed batch of requests with greedy P-EAGLE speculative decoding
on the card and print OTPS, acceptance length, prefill and decode seconds.

The target is full-width qwen2-1.5b in bfloat16 with a 4-layer parallel
drafter, both with random weights drawn from ``--seed``; prompts are random
tokens from the same seed. The run is repeated and the last (warm) run is
reported.

    PYTHONPATH=src python -m repro_torch.launch.serve            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --prompt-len 16 --max-new 8 --max-len 64                  # CPU rehearsal
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


def build_engine(*, reduced=False, dtype=None, mode="parallel", K=5,
                 max_new=128, max_len=1024, batch=8, seed=0, device="cuda"):
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
                        cache_dtype=dtype, max_len=max_len)
    return Engine(tcfg, dcfg if mode != "none" else None, tparams, dparams,
                  ecfg, batch, device=dev)


def random_prompts(vocab: int, batch: int, length: int, seed: int):
    """(batch, length) int32 prompts; the drafter's mask token is avoided."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab - 1, (batch, length)).astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer CPU-test config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="parallel", choices=("parallel", "ar", "none"))
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    eng = build_engine(reduced=args.reduced, mode=args.mode, K=args.k,
                       max_new=args.max_new, max_len=args.max_len,
                       batch=args.batch, seed=args.seed, device=args.device)
    prompts = random_prompts(eng.tcfg.vocab_size, args.batch, args.prompt_len,
                             args.seed)
    for _ in range(args.runs):
        r = eng.run(prompts)
    report = {
        "device": (torch.cuda.get_device_name(eng.device)
                   if eng.device.type == "cuda" else "cpu"),
        "arch": eng.tcfg.arch_id, "reduced": args.reduced,
        "mode": args.mode, "batch": args.batch, "prompt_len": args.prompt_len,
        "new_tokens": r["new_tokens"], "steps": r["steps"],
        "otps": r["otps"], "acceptance_length": r["acceptance_length"],
        "prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

"""Train a P-EAGLE drafter on the card and print one JSON line: the last
loss, seconds per step, label tokens per second and peak memory.

By default the target is full-width qwen2-1.5b in bfloat16 with random
weights from seed 0 and the drafter (4 layers, full width) is float32,
as the JAX trainer keeps it; ``--reduced`` takes the 2-layer CPU-test
config in float32. The data pipeline is the JAX package's: COD sampling,
padding to the static expanded length and, with ``--segments S``,
Algorithm-1 segments with gradient accumulation inside each sequence.

    PYTHONPATH=src python -m repro_torch.launch.train --data markov \
        --seq-len 2048 --batch 1 --n-seqs 4 --epochs 1      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --epochs 1 --n-seqs 4 --batch 2 --seq-len 24 --ckpt build/ckpt  # CPU
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.data import MTPPipeline, markov_corpus, self_generated_corpus
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import resolve_device
from repro_torch.training import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer CPU-test config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=48)
    ap.add_argument("--n-seqs", type=int, default=64)
    ap.add_argument("--k-train", type=int, default=8)
    ap.add_argument("--cod-rate", type=float, default=0.8)
    ap.add_argument("--segments", type=int, default=1)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--variant", default="shared")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--ar-baseline", action="store_true")
    ap.add_argument("--data", default="self", choices=["self", "markov"])
    ap.add_argument("--ckpt", default="results/ckpt")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tcfg = get_config(args.arch)
    if args.reduced:
        tcfg = tcfg.reduced()
    model = get_model(tcfg)
    print(f"init target {args.arch} (reduced={args.reduced}) on {dev} ...",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    tparams = model.init(gen, device=dev)

    if args.data == "self":
        corpus = self_generated_corpus(
            model, tparams, seed=1, n_seqs=args.n_seqs, seq_len=args.seq_len,
            batch=min(16, args.n_seqs), device=dev)
    else:
        corpus = markov_corpus(0, args.n_seqs, args.seq_len, tcfg.vocab_size)

    dcfg = DrafterConfig(
        n_layers=args.layers, k_train=args.k_train, cod_rate=args.cod_rate,
        hidden_state_variant=args.variant,
        parallel=not args.ar_baseline).resolve(tcfg)
    pipe = MTPPipeline(corpus, k_train=dcfg.k_train, cod_rate=dcfg.cod_rate,
                       batch=args.batch, seed=0, segments=args.segments)
    steps = args.epochs * max(len(corpus) // args.batch, 1)
    tr = Trainer(tcfg, dcfg, tparams,
                 TrainConfig(lr=args.lr, total_steps=steps), device=dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log = tr.train(pipe, epochs=args.epochs, log_every=5)
    fn = save_pytree(tr.dparams, args.ckpt, f"drafter_{args.arch}",
                     step=len(log))
    # the first step warms up (kernel builds, allocator): report the rest
    warm = log[1:] or log
    secs = sum(m["seconds"] for m in warm)
    report = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "arch": args.arch, "reduced": args.reduced,
        "seq_len": args.seq_len, "batch": args.batch,
        "segments": args.segments, "steps": len(log),
        "loss": log[-1]["loss"],
        "s_per_step": secs / len(warm),
        "label_tokens_per_s": (sum(m["label_tokens"] for m in warm)
                               / max(secs, 1e-9)),
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
        "checkpoint": fn,
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

"""Scalable long-context MTP training with the PyTorch port (paper §3): COD
sampling, the closed-form MTP mask and Algorithm-1 sequence partitioning
with gradient accumulation inside each sequence. Prints the reduction of
the largest attention block and the losses of whole-sequence and
segmented training, which reach the same place.

The target is qwen2-1.5b at full width on the card (random weights from
seed 0, in bfloat16; the drafter trains in float32); ``--reduced --device
cpu`` takes the 2-layer test config in float32 on the CPU.

    PYTHONPATH=src python examples/torch_train_long_context.py   # on the card
    PYTHONPATH=src python examples/torch_train_long_context.py --reduced \\
        --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import DrafterConfig, get_config
from repro_torch.core import cod, partition
from repro_torch.data import MTPPipeline, markov_corpus
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import resolve_device
from repro_torch.training import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer CPU-test config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=8)
    args = ap.parse_args(argv)

    n, K, r, S = 96, 6, 0.8, 4
    dev = resolve_device(args.device)
    tcfg = get_config("qwen2-1.5b")
    tcfg = tcfg.reduced() if args.reduced else tcfg
    model = get_model(tcfg, dev)
    tparams = model.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    corpus = markov_corpus(0, 32, n, tcfg.vocab_size, branch=2)

    M = cod.expanded_length(n, K, r)
    rng = np.random.default_rng(0)
    pos, depth = cod.sample_cod(rng, n, K, r)
    segs = partition.build_segments(pos, depth, n, S)
    full_cells = M * M
    seg_cells = max(len(s.kv_pos) ** 2 for s in segs)
    print(f"seq n={n} K={K} r={r}: expanded M={M}")
    print(f"attention cells: whole={full_cells:,}  "
          f"max-segment (S={S})={seg_cells:,}  "
          f"reduction={full_cells / seg_cells:.1f}x")
    print(f"dependencies preserved: "
          f"{partition.check_dependencies_preserved(segs, pos, depth)}")

    dcfg = DrafterConfig(n_layers=1, k_train=K, cod_rate=r).resolve(tcfg)
    losses = {}
    for segments, tag in ((1, "whole-sequence"), (S, f"segmented S={S}")):
        pipe = MTPPipeline(corpus, k_train=K, cod_rate=r, batch=8, seed=0,
                           segments=segments)
        tr = Trainer(tcfg, dcfg, tparams,
                     TrainConfig(lr=2e-3, total_steps=40),
                     device=dev)
        log = tr.train(pipe, epochs=args.epochs)
        losses[tag] = (log[0]["loss"], log[-1]["loss"])
        print(f"{tag:20s}: loss {log[0]['loss']:.3f} -> "
              f"{log[-1]['loss']:.3f}")
    return losses


if __name__ == "__main__":
    main()

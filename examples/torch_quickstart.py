"""Quickstart for the PyTorch port: train a P-EAGLE drafter against a target
model and speculative-decode with it, checking that the output is the
target's own (lossless) and reporting the acceptance length.

The target is qwen2-1.5b at full width on the card (random weights from
seed 0; float32 by default, so that the greedy streams compare exactly:
in bfloat16 a near tie may part them); ``--reduced --device cpu`` takes
the 2-layer test config on the CPU. The corpus is the target's own greedy
rollouts, and the drafter (2 layers, float32) trains on them; its
acceptance length is measured on the corpus's own prompts.

    PYTHONPATH=src python examples/torch_quickstart.py          # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --reduced --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import DrafterConfig, get_config
from repro_torch.data import MTPPipeline, self_generated_corpus
from repro_torch.models.registry import get_model, make_extras, takes_extras
from repro_torch.prng import PRNGKey
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.engine import resolve_device
from repro_torch.training import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer CPU-test config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--k", type=int, default=4)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tcfg = get_config(args.arch)
    tcfg = (tcfg.reduced() if args.reduced else tcfg).replace(
        dtype=args.dtype)
    print(f"== target: {args.arch} ({'reduced' if args.reduced else 'full'}"
          f" config, {tcfg.dtype}, {dev}) ==")
    model = get_model(tcfg, dev)
    tparams = model.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    key = PRNGKey(0, device=dev)
    modal = takes_extras(tcfg)

    print("generating target-trace training corpus ...")
    corpus = self_generated_corpus(
        model, tparams, seed=1, n_seqs=48, seq_len=40, prompt_len=4,
        batch=16, device=dev,
        extras_fn=(lambda b: make_extras(tcfg, b, "prefill", key))
        if modal else None)

    print("training P-EAGLE drafter (2 layers, K_train=6, COD r=0.8) ...")
    dcfg = DrafterConfig(n_layers=2, k_train=6, k_infer=args.k).resolve(tcfg)
    pipe = MTPPipeline(corpus, k_train=6, cod_rate=0.8, batch=16, seed=0)
    tr = Trainer(tcfg, dcfg, tparams,
                 TrainConfig(lr=3e-3, total_steps=args.epochs * 3),
                 device=dev,
                 extras=make_extras(tcfg, 16, "train", key) if modal else {})
    log = tr.train(pipe, epochs=args.epochs, log_every=10)
    print(f"final: loss={log[-1]['loss']:.3f} "
          f"mtp_acc={log[-1]['mtp_acc']:.3f}")

    print("speculative decoding (greedy; must match target exactly) ...")
    B, P, NEW = 4, 6, 24
    prompts = np.asarray(corpus[:B, :P])
    ex = make_extras(tcfg, B, "prefill", key) if modal else {}

    def engine(mode, dc, dp):
        return Engine(tcfg, dc, tparams, dp,
                      EngineConfig(K=args.k, max_new_tokens=NEW,
                                   drafter_mode=mode, max_len=128,
                                   cache_dtype=tcfg.dtype), B, device=dev)
    base = engine("none", None, None).run(prompts, ex)
    spec = engine("parallel", dcfg, tr.dparams).run(prompts, ex)
    off = tcfg.vision_tokens if tcfg.family == "vlm" else 0
    lossless = np.array_equal(base["tokens"][:, off + P:off + P + NEW],
                              spec["tokens"][:, off + P:off + P + NEW])
    print(f"acceptance length : {spec['acceptance_length']:.2f} "
          f"(vanilla = 1.00, max = {args.k + 1})")
    print(f"lossless          : {lossless}")
    print(f"OTPS vanilla={base['otps']:.1f}  P-EAGLE={spec['otps']:.1f}  "
          f"speedup={spec['otps'] / base['otps']:.2f}x")
    return {"acceptance_length": spec["acceptance_length"],
            "lossless": lossless, "loss": log[-1]["loss"]}


if __name__ == "__main__":
    main()

"""End-to-end serving with the PyTorch port: batched speculative decoding
under a request queue, comparing vanilla decoding, AR EAGLE-3 drafting
and P-EAGLE parallel drafting at several speculation depths, each under
both batching disciplines:

  round-based   — fixed batch, queue refilled only between full generation
                  rounds (every round waits for its slowest member):
                  ``serving.serve_round_based``
  continuous    — per-slot refill mid-stream through ``serving.Scheduler``:
                  a finished slot is reused at once

Requests get long-tail budgets (a quarter long, the rest short), so
continuous batching's straggler win shows in the OTPS column. More rows
serve the same mix through the paged engine (twice the slots on the same
pool bytes), under Exp arrival gaps on the scheduler's virtual clock
(latency and wait percentiles, preemption when the pool runs dry), with
the prefix cache over a shared 32-token preamble, and as a mixed batch
(half greedy, half seeded nucleus sampling). The last line checks that
every greedy speculative stream equals vanilla decoding's.

The target is qwen2-1.5b at full width on the card (random weights from
seed 0, float32 by default so that greedy streams compare exactly);
``--reduced --device cpu`` takes the 2-layer test config on the CPU. Both
drafters train on the target's own rollouts first.

    PYTHONPATH=src python examples/torch_serve_batched.py      # on the card
    PYTHONPATH=src python examples/torch_serve_batched.py --reduced \\
        --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import DrafterConfig, get_config
from repro_torch.data import MTPPipeline, self_generated_corpus
from repro_torch.models.registry import get_model
from repro_torch.serving import (Engine, EngineConfig, Request,
                                 SamplingParams, Scheduler,
                                 serve_round_based)
from repro_torch.serving.engine import resolve_device
from repro_torch.training import TrainConfig, Trainer


def longtail_budgets(n_requests: int, max_new: int, rng) -> list:
    """A quarter of the requests long (the full budget), the rest short."""
    return [max_new if i % 4 == 0
            else int(rng.integers(3, max(max_new // 3, 4)))
            for i in range(n_requests)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer CPU-test config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--ks", default="3,5,7",
                    help="speculation depths of the table")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--sync-every", type=int, default=4,
                    help="scheduler iterations between host syncs")
    ap.add_argument("--mean-gap", type=float, default=2.0,
                    help="mean Exp inter-arrival gap (virtual steps) of the "
                         "async row")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tcfg = get_config("qwen2-1.5b")
    tcfg = (tcfg.reduced() if args.reduced else tcfg).replace(
        dtype=args.dtype)
    model = get_model(tcfg, dev)
    tparams = model.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    corpus = self_generated_corpus(model, tparams, seed=1, n_seqs=48,
                                   seq_len=40, prompt_len=4, batch=16,
                                   device=dev)

    print("training drafters (parallel + AR baseline) ...")
    dcfg_p = DrafterConfig(n_layers=2, k_train=6).resolve(tcfg)
    pipe = MTPPipeline(corpus, k_train=6, cod_rate=0.8, batch=16, seed=0)
    tr_p = Trainer(tcfg, dcfg_p, tparams,
                   TrainConfig(lr=3e-3, total_steps=50), device=dev)
    tr_p.train(pipe, epochs=args.epochs)
    dcfg_a = DrafterConfig(n_layers=1, parallel=False, ttt_steps=2,
                           k_train=1, cod_rate=0.99).resolve(tcfg)
    pipe_a = MTPPipeline(corpus, k_train=1, cod_rate=0.99, batch=16, seed=0)
    tr_a = Trainer(tcfg, dcfg_a, tparams,
                   TrainConfig(lr=3e-3, total_steps=50), device=dev)
    tr_a.train(pipe_a, epochs=args.epochs)

    rng = np.random.default_rng(7)
    rows = rng.choice(len(corpus), args.requests, replace=False)
    prompts = [np.asarray(corpus[i, :6]) for i in rows]
    budgets = longtail_budgets(args.requests, args.max_new, rng)

    def make(mode, dcfg, dp, K, slots=args.batch, **kw):
        return Engine(tcfg, dcfg, tparams, dp,
                      EngineConfig(K=K, max_new_tokens=args.max_new,
                                   drafter_mode=mode, max_len=128,
                                   cache_dtype=tcfg.dtype, **kw),
                      slots, device=dev)

    def serve(eng, reqs):
        """The warm (second) run of a scheduler serve."""
        rep = None
        for _ in range(2):
            rep = Scheduler(eng, sync_every=args.sync_every).serve(reqs())
        return rep

    def queue(sampling=None, arrivals=None, pre=None):
        def reqs():
            return [Request(p if pre is None else np.concatenate([pre, p]),
                            max_new_tokens=b,
                            arrival_time=0.0 if arrivals is None
                            else arrivals[i],
                            sampling=None if sampling is None
                            else sampling[i])
                    for i, (p, b) in enumerate(zip(prompts, budgets))]
        return reqs

    def bench(eng):
        """(round-based OTPS, continuous OTPS, continuous AL, tokens) of
        warm second runs."""
        rb = None
        for _ in range(2):
            rb = serve_round_based(eng, prompts, budgets)
        co = serve(eng, queue())
        toks = [r["tokens"] for r in sorted(co["results"],
                                            key=lambda r: r["rid"])]
        return rb["otps"], co["otps"], co["mean_acceptance_length"], toks

    hdr = (f"{'engine':16s} {'round OTPS':>11s} {'cont OTPS':>11s} "
           f"{'cont/round':>10s} {'AL':>5s}")
    print(hdr + "\n" + "-" * len(hdr))
    rb0, co0, _, ref = bench(make("none", None, None, 0))
    print(f"{'vanilla AR':16s} {rb0:11.1f} {co0:11.1f} {co0 / rb0:9.2f}x"
          f" {'—':>5s}")
    lossless = True
    for K in (int(k) for k in args.ks.split(",")):
        rb_a, co_a, al_a, toks_a = bench(make("ar", dcfg_a, tr_a.dparams, K))
        rb_p, co_p, al_p, toks_p = bench(make("parallel", dcfg_p,
                                              tr_p.dparams, K))
        lossless &= all(np.array_equal(a, b) for a, b in zip(toks_a, ref))
        lossless &= all(np.array_equal(a, b) for a, b in zip(toks_p, ref))
        print(f"{f'AR-EAGLE K={K}':16s} {rb_a:11.1f} {co_a:11.1f} "
              f"{co_a / rb_a:9.2f}x {al_a:5.2f}")
        print(f"{f'P-EAGLE  K={K}':16s} {rb_p:11.1f} {co_p:11.1f} "
              f"{co_p / rb_p:9.2f}x {al_p:5.2f}   "
              f"(P/AR cont: {co_p / co_a:.2f}x, P/vanilla: {co_p / co0:.2f}x)")

    # paged KV: the contiguous engine's pool bytes (batch x max_len rows)
    # shared by twice the slots, pages claimed as slots lengthen
    pool = args.batch * 128 // 16
    paged = make("parallel", dcfg_p, tr_p.dparams, 5, kv_layout="paged",
                 page_size=16, pool_pages=pool, slots=2 * args.batch)
    pg = serve(paged, queue())
    print(f"{'P-EAGLE paged':16s} {'—':>11s} {pg['otps']:11.1f} "
          f"{'—':>10s} {pg['mean_acceptance_length']:5.2f}   "
          f"({2 * args.batch} slots on {args.batch}-slot pool bytes, "
          f"page_size=16, peak {paged.allocator.peak_used} pages)")

    # the same engine under Exp arrival gaps on the virtual clock
    arrivals = np.cumsum(rng.exponential(args.mean_gap,
                                         size=args.requests)).tolist()
    asy = serve(paged, queue(arrivals=arrivals))
    print(f"{'P-EAGLE async':16s} {'—':>11s} {asy['otps']:11.1f} "
          f"{'—':>10s} {asy['mean_acceptance_length']:5.2f}   "
          f"(Exp gap {args.mean_gap}: latency p50/p99 "
          f"{asy['p50_latency_vt']:.0f}/{asy['p99_latency_vt']:.0f} vt, "
          f"wait p99 {asy['p99_wait_vt']:.0f} vt, "
          f"{asy['preemptions']} preemptions)")

    # prefix caching: every prompt opens with one 32-token preamble, whose
    # full pages a later admission maps instead of prefilling
    cached = make("parallel", dcfg_p, tr_p.dparams, 5, kv_layout="paged",
                  page_size=16, pool_pages=pool, prefix_cache=True,
                  slots=2 * args.batch)
    preamble = np.asarray(corpus[rows[0], :32])
    px = serve(cached, queue(pre=preamble))
    stats = cached.prefix_cache.stats
    print(f"{'P-EAGLE prefix':16s} {'—':>11s} {px['otps']:11.1f} "
          f"{'—':>10s} {px['mean_acceptance_length']:5.2f}   "
          f"(shared 32-tok preamble: {px['cache_hit_requests']}/"
          f"{args.requests} hit requests, {px['cache_hit_tokens']} prompt "
          f"tokens from cache, {stats['evictions']} LRU evictions)")

    # a mixed batch: even requests greedy, odd ones seeded nucleus sampling
    sps = [SamplingParams.greedy(seed=i) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_p=0.95, seed=i)
           for i in range(args.requests)]
    mx = serve(make("parallel", dcfg_p, tr_p.dparams, 5), queue(sps))
    print(f"{'P-EAGLE mixed':16s} {'—':>11s} {mx['otps']:11.1f} "
          f"{'—':>10s} {mx['mean_acceptance_length']:5.2f}   "
          f"(half greedy / half T=0.8 top-p 0.95, per-request seeds, "
          "one step)")
    print(f"lossless: {lossless}  (every greedy AR-EAGLE and P-EAGLE "
          f"stream equals vanilla's)")
    return {"lossless": lossless}


if __name__ == "__main__":
    main()

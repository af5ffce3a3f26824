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

``--prefix-cache`` admits prompts against the pages of earlier streams,
``--swap host`` preempts to a pinned host pool of ``--host-pool-bytes``
(0: unbounded) instead of recomputing, and ``--adaptive-k`` sets each
request's draft length from its own acceptance (all three paged only).
``--shared-prefix N --prefix-groups G`` makes shared-prefix traffic:
request i opens with the N-token system prompt of group i mod G, followed
by its own suffix of ``--prompt-len / 16`` to ``--prompt-len`` tokens.
``--round-based`` also serves the same prompts and budgets with the
round-based baseline (``serve_round_based``: whole rounds of ``--batch``
prompts, on a contiguous engine sharing the weights, under the engine's
default policy) and reports its OTPS, rounds and AL beside the scheduler's.

The target is ``--arch`` (default qwen2-1.5b; gemma-7b, gemma2-27b,
minitron-4b, the SSM mamba2-780m, the hybrid recurrentgemma-2b and the
MoE dbrx-132b and llama4-maverick too) at full width in bfloat16, random
weights drawn from ``--seed``, with the ``--layers``-layer drafter (4 by
default): the latest ``drafter_{arch}`` checkpoint under ``--ckpt`` (what
``launch.train`` wrote there against the same target), cast once to the
target's dtype, or random weights from the same seed when the directory
holds none; a checkpoint that does not fit (another ``--layers``, hidden-
state variant or target) raises, naming the leaf, and the report's
``drafter`` says which was served. ``--no-bucket`` prefills each admission
at its own length instead of the next power of two. ``--n-layers`` cuts
the target's depth, its widths kept (dbrx-132b's 40 layers do not fit one
card; 8 do, ~62 GB). mamba2-780m keeps its conv and
SSD state per slot, so only its drafter's KV is paged; recurrentgemma-2b
keeps its RG-LRU rows per slot beside its local layers' KV, pooled at a
max_len not above 2048 + K + 1 and per-slot rings above; both admit
prompts in power-of-two chunks. An MoE target builds no prefix cache: its
expert capacity couples the tokens of a call. The VLM internvl2-1b and the
encoder-decoder whisper-base serve with stub frontend inputs (256 vision
tokens of 1024, or 1500 encoder frames of 512), drawn per request from its
prompt at admission (``Request.extras``); neither builds a prefix cache,
and ``--round-based`` refuses them (whole rounds carry no per-request
extras). Prompts are random tokens from the same seed and arrive with
Exp(``--mean-gap``) gaps on the virtual clock (0: all at once);
``--prompts`` serves given prompts instead (a numpy ``.npy`` array of
token rows, e.g. a training corpus's ``data.corpus_prompts``, on which a
drafter trained on that corpus's rollouts accepts: on unseen prompts a
drafter trained on a random target's rollouts accepts next to nothing).
The KV cache is paged on the card and contiguous on the CPU unless
``--kv-layout`` says otherwise. The run is repeated and the last (warm)
run is reported.

    PYTHONPATH=src python -m repro_torch.launch.serve            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --ckpt build/ckpt \
        --seq-len 128 --n-seqs 16 --batch 8 --epochs 20 --lr 3e-3 && \
    PYTHONPATH=src python -c "import numpy as np; from repro_torch.data \
        import corpus_prompts; np.save('build/prompts.npy', corpus_prompts(\
        151936, seed=1, n_seqs=12, batch=16))" && \
    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt build/ckpt \
        --prompts build/prompts.npy --requests 12 --max-new 60 \
        --mean-gap 1                           # the trained drafter
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \
        --mean-gap 1 --pool-pages 256          # on the card, under pressure
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --prompt-len 16 --max-new 8 --max-len 64 \
        --kv-layout paged --page-size 8 --pool-pages 12   # CPU rehearsal
    PYTHONPATH=src python -m repro_torch.launch.serve --temperature 0.8 \
        --top-k 50 --seed 1 [--draft-sampling]        # sampled, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \
        --mean-gap 1 --pool-pages 256 --shared-prefix 320 --prefix-groups 3 \
        --prompt-len 256 --prefix-cache --swap host --adaptive-k
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \
        --mean-gap 1 --round-based       # continuous against round-based
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --requests 12 --mean-gap 1      # gemma2-27b, full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        --requests 24 --mean-gap 1 --pool-pages 256   # head dim 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --requests 24 --mean-gap 1 --pool-pages 256 --swap host   # SSM
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --requests 24 --mean-gap 1 \
        --pool-pages 256 --swap host                  # hybrid
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
        --n-layers 8 --requests 12 --mean-gap 1 --pool-pages 256 \
        --swap host                                   # MoE, 8 of 40 layers
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \
        --requests 24 --mean-gap 1 --max-len 1280 --pool-pages 320 \
        --swap host                                   # VLM, 256 vision tokens
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --requests 24 --mean-gap 1 --prompt-len 128 --max-len 448 \
        --pool-pages 112 --swap host                  # encoder-decoder
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --shard-model 4 --requests 24 --mean-gap 1    # model-sharded, 4 cards

``--shard-model N`` serves storage-sharded (``EngineConfig(shard_model=
True)``) over N ranks started by ``torchrun --nproc-per-node N``, one card
each (``nccl``; ``gloo`` with ``--device cpu``): every rank draws the same
seeded weights leaf by leaf, keeps its slice of each as it is drawn (no
card ever holds the whole model) and runs the same scheduler; rank 0
prints the report. N must be the world size. ``--round-based`` is not
offered with it. llama4-maverick at full width on 4 of its 48 layers
(~77 GB with its drafter, its first global NoPE layer the fourth) serves
on four cards, ~19 GB of slices each:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch llama4-maverick-400b-a17b --n-layers 4 --shard-model 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, load_pytree
from repro_torch.configs import ARCH_IDS, DrafterConfig, get_config
from repro_torch.core import drafter as D
from repro_torch.models.registry import get_model, takes_extras
from repro_torch.serving.engine import Engine, EngineConfig, resolve_device
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (Request, Scheduler,
                                           serve_round_based)
from repro_torch.sharding.rules import (draw_sharded, serve_param_specs,
                                        slice_keeper)
from repro_torch.sharding.utils import serving_mesh, shard_tree


def target_config(arch="qwen2-1.5b", *, reduced=False, n_layers=None,
                  dtype=None):
    """The target's config as the launchers build it: ``arch`` at full
    width (or its reduced CPU-test config), ``n_layers`` cutting its depth,
    in ``dtype`` (default bfloat16 at full width, float32 reduced). The
    training launcher draws its target from the same config, so a drafter
    it trains is served against the same weights."""
    tcfg = get_config(arch)
    if reduced:
        tcfg = tcfg.reduced()
    dtype = dtype or ("float32" if reduced else "bfloat16")
    return tcfg.replace(dtype=dtype, n_layers=n_layers or tcfg.n_layers)


def load_drafter(dcfg, tcfg, ckpt, *, device, mesh=None):
    """The trained drafter ``drafter_{arch}`` of the latest step under
    ``ckpt`` that holds one, in the template ``dcfg`` at the target's dtype
    (each leaf cast once: norms stay float32), and ``(step, path)``; or
    ``(None, None)`` when no step holds one. Under a mesh each leaf is cut
    to its rank's slice as soon as it is read. A checkpoint that does not
    fit the template (another ``--layers``, hidden-state variant or arch)
    raises, naming the leaf."""
    name = f"drafter_{tcfg.arch_id}"
    step = latest_step(ckpt, name)
    if step is None:
        return None, None
    template = D.init_params(dcfg, tcfg, torch.Generator(), device="meta",
                             dtype=getattr(torch, tcfg.dtype))
    keep = None if mesh is None else slice_keeper(template, mesh)
    params = load_pytree(template, ckpt, name, step, device=device,
                         keep=keep)
    if mesh is not None:
        params = shard_tree(params, serve_param_specs(template, mesh), mesh)
    return params, (step, os.path.join(ckpt, f"step_{step:08d}",
                                       f"{name}.npz"))


def build_engine(*, arch="qwen2-1.5b", reduced=False, n_layers=None,
                 dtype=None, mode="parallel", K=5, max_new=128, max_len=1024,
                 batch=8, seed=0, device="cuda", kv_layout="contiguous",
                 page_size=16, pool_pages=0, kv_growth="incremental",
                 sampling=None, draft_sampling=False, prefix_cache=False,
                 swap="none", host_pool_bytes=0, shard_model=False,
                 ckpt=None, drafter_layers=4, bucket_prefill=True):
    """The target ``arch`` with seeded random weights and the
    ``drafter_layers``-layer drafter, wrapped in an Engine. The drafter is
    the latest ``drafter_{arch}`` checkpoint under ``ckpt`` (the training
    launcher's output; trained in float32, served in the target's dtype),
    or seeded random weights when ``ckpt`` holds none;
    ``engine.drafter_source`` says which (``source``, ``path``, ``step``;
    None with ``mode="none"``). ``n_layers`` cuts the target's depth
    (widths stay the published ones). ``dtype`` defaults to bfloat16 at
    full width and float32 reduced; ``sampling`` is the engine's default
    policy (None: greedy); ``bucket_prefill`` pads admission prefills to
    powers of two. ``shard_model`` shards the weights and KV over every
    rank of the initialised process group: each rank draws the same
    weights leaf by leaf, in the unsharded draw's order, and keeps its
    slice of each as soon as it is drawn (``sharding.rules.draw_sharded``;
    a checkpoint is read the same way, leaf by leaf), so its card holds
    its slices plus the one leaf being drawn (a float32 draw and its cast),
    never the whole model, and the slices are bitwise the unsharded draw's
    for the seed. A target the device's kernels cannot serve raises before
    any weight is made."""
    dev = resolve_device(device)
    tcfg = target_config(arch, reduced=reduced, n_layers=n_layers,
                         dtype=dtype)
    dcfg = DrafterConfig(n_layers=drafter_layers, k_infer=K).resolve(tcfg)
    model = get_model(tcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mesh = serving_mesh() if shard_model else None

    def draw(init):
        if mesh is None:
            return init(gen, dev, None)
        return draw_sharded(init, gen, mesh, device=dev)
    tparams = draw(lambda g, d, keep: model.init(g, device=d, keep=keep))
    dparams = source = None
    if mode != "none":
        dparams, found = load_drafter(dcfg, tcfg, ckpt, device=dev,
                                      mesh=mesh)
        source = {"source": "random", "path": None, "step": None}
        if found is not None:
            source = {"source": "checkpoint", "path": found[1],
                      "step": found[0]}
        else:
            dparams = draw(lambda g, d, keep: D.init_params(
                dcfg, tcfg, g, device=d, dtype=getattr(torch, tcfg.dtype),
                keep=keep))
    ecfg = EngineConfig(K=K, max_new_tokens=max_new, drafter_mode=mode,
                        cache_dtype=tcfg.dtype, max_len=max_len,
                        kv_layout=kv_layout, page_size=page_size,
                        pool_pages=pool_pages, kv_growth=kv_growth,
                        sampling=sampling, draft_sampling=draft_sampling,
                        prefix_cache=prefix_cache, swap=swap,
                        host_pool_bytes=host_pool_bytes,
                        bucket_prefill=bucket_prefill,
                        shard_model=shard_model, mesh=mesh)
    eng = Engine(tcfg, dcfg if mode != "none" else None, tparams, dparams,
                 ecfg, batch, device=dev)
    eng.drafter_source = source
    return eng


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
                  mean_gap: float, seed: int, policy=None, prompts=None):
    """``n`` requests of random ``prompt_len``-token prompts (or the first
    ``n`` rows of ``prompts``) and ``max_new`` budgets, arriving with
    Exp(``mean_gap``) gaps (0: all at time 0); ``policy(i)`` gives request
    i's SamplingParams (None: the engine's)."""
    prompts = (random_prompts(vocab, n, prompt_len, seed) if prompts is None
               else np.asarray(prompts, np.int32)[:n])
    gaps = (np.random.default_rng(seed + 1).exponential(mean_gap, n)
            if mean_gap > 0 else np.zeros(n))
    return [Request(p, max_new_tokens=max_new, arrival_time=float(t),
                    sampling=None if policy is None else policy(i))
            for i, (p, t) in enumerate(zip(prompts, np.cumsum(gaps)))]


def shared_prefix_requests(vocab: int, n: int, prefix_len: int, groups: int,
                           suffix_lens, budgets, mean_gap: float, seed: int,
                           repeats: int = 0, policy=None):
    """``n`` requests in ``groups`` groups, request i in group i % groups:
    the group's ``prefix_len``-token system prompt, then a suffix of its
    own whose length is drawn from the inclusive range ``suffix_lens``;
    budgets drawn from the inclusive range ``budgets``; then ``repeats``
    more requests repeating the last ``repeats`` prompts exactly, budgets
    too (arriving soon after them, they find those prompts' pages still
    mapped or recently cached). Exp(``mean_gap``) arrival gaps (0: all at
    time 0); ``policy(i)`` as in ``make_requests``. Tokens avoid the
    drafter's mask token."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab - 1, (groups, prefix_len)).astype(np.int32)
    lens = rng.integers(suffix_lens[0], suffix_lens[1] + 1, n)
    spend = rng.integers(budgets[0], budgets[1] + 1, n)
    prompts = [np.concatenate([system[i % groups],
                               rng.integers(0, vocab - 1, int(m))
                               .astype(np.int32)])
               for i, m in enumerate(lens)]
    prompts += prompts[n - repeats:n]
    spend = np.concatenate([spend, spend[n - repeats:n]]).astype(int)
    total = n + repeats
    gaps = (rng.exponential(mean_gap, total) if mean_gap > 0
            else np.zeros(total))
    return [Request(p, max_new_tokens=int(b), arrival_time=float(t),
                    sampling=None if policy is None else policy(i))
            for i, (p, b, t) in enumerate(zip(prompts, spend,
                                              np.cumsum(gaps)))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS,
                    help="the target architecture")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the target's depth (widths stay)")
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="admit prompts against cached pages of earlier "
                         "streams (paged)")
    ap.add_argument("--swap", choices=("none", "host"), default="none",
                    help="host: preempt to pinned host memory and restore "
                         "bitwise, instead of recompute-prefill (paged)")
    ap.add_argument("--host-pool-bytes", type=int, default=0,
                    help="host swap budget (0 = unbounded); a snapshot "
                         "that does not fit is recomputed instead")
    ap.add_argument("--adaptive-k", action="store_true",
                    help="per-request draft length from the request's own "
                         "acceptance (serving/speculation.py)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="system-prompt tokens shared within a group of "
                         "requests (0: independent random prompts)")
    ap.add_argument("--prefix-groups", type=int, default=1,
                    help="groups of --shared-prefix traffic")
    ap.add_argument("--round-based", action="store_true",
                    help="also serve the same prompts and budgets with the "
                         "round-based baseline")
    ap.add_argument("--shard-model", type=int, default=0, metavar="N",
                    help="storage-shard weights and KV over the N ranks "
                         "torchrun started (N = the world size)")
    ap.add_argument("--ckpt", default="results/ckpt",
                    help="serve the latest drafter_{arch} checkpoint under "
                         "this directory (the training launcher's --ckpt); "
                         "none there: a random drafter")
    ap.add_argument("--layers", type=int, default=4,
                    help="the drafter's depth (the checkpoint's)")
    ap.add_argument("--prompts", default=None, metavar="NPY",
                    help="serve these prompts: an (n, length) integer array "
                         "saved by numpy (default: random --prompt-len "
                         "tokens from --seed)")
    ap.add_argument("--no-bucket", action="store_true",
                    help="prefill each admission at its own length, not "
                         "padded to the next power of two")
    args = ap.parse_args(argv)
    if args.mixed_sampling and args.temperature <= 0:
        ap.error("--mixed-sampling needs --temperature > 0")
    if args.prefix_groups < 1:
        ap.error("--prefix-groups must be at least 1")
    if args.prompts and args.shared_prefix > 0:
        ap.error("--prompts and --shared-prefix both make the prompts")
    if args.round_based and args.shared_prefix > 0:
        ap.error("--round-based stacks equal-length prompts: not with "
                 "--shared-prefix")
    if args.round_based and takes_extras(get_config(args.arch)):
        ap.error(f"--round-based serves whole rounds without per-request "
                 f"extras: serve {args.arch} through the scheduler")

    if args.shard_model and args.round_based:
        ap.error("--round-based is not offered with --shard-model")
    dev = resolve_device(args.device)
    if args.shard_model:
        dev = init_ranks(args.shard_model, dev)
    layout = args.kv_layout or ("paged" if dev.type == "cuda"
                                else "contiguous")
    eng = build_engine(arch=args.arch, reduced=args.reduced,
                       n_layers=args.n_layers, mode=args.mode,
                       K=args.k, max_new=args.max_new, max_len=args.max_len,
                       batch=args.batch, seed=args.seed, device=dev,
                       kv_layout=layout, page_size=args.page_size,
                       pool_pages=args.pool_pages, kv_growth=args.kv_growth,
                       draft_sampling=args.draft_sampling,
                       prefix_cache=args.prefix_cache, swap=args.swap,
                       host_pool_bytes=args.host_pool_bytes,
                       shard_model=args.shard_model > 0, ckpt=args.ckpt,
                       drafter_layers=args.layers,
                       bucket_prefill=not args.no_bucket)
    given = None if args.prompts is None else np.load(args.prompts)
    n_req = args.requests or (args.batch if given is None else len(given))
    if given is not None and (given.ndim != 2 or len(given) < n_req):
        ap.error(f"--prompts holds {given.shape}: {n_req} rows of tokens "
                 f"wanted")
    sched = Scheduler(eng, eos_id=args.eos_id, sync_every=args.sync_every,
                      preempt=not args.no_preempt, adaptive_k=args.adaptive_k)

    def policy(i):
        return request_policy(i, temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed, mixed=args.mixed_sampling)
    def requests():
        if args.shared_prefix > 0:
            return shared_prefix_requests(
                eng.tcfg.vocab_size, n_req, args.shared_prefix,
                args.prefix_groups, (max(args.prompt_len // 16, 1),
                                     args.prompt_len),
                (args.max_new, args.max_new), args.mean_gap, args.seed,
                policy=policy)
        return make_requests(eng.tcfg.vocab_size, n_req, args.prompt_len,
                             args.max_new, args.mean_gap, args.seed, policy,
                             prompts=given)
    for _ in range(args.runs):
        r = sched.serve(requests())
    report = {
        "device": (torch.cuda.get_device_name(eng.device)
                   if eng.device.type == "cuda" else "cpu"),
        "arch": eng.tcfg.arch_id, "reduced": args.reduced,
        "n_layers": eng.tcfg.n_layers,
        "mode": args.mode, "drafter": eng.drafter_source,
        "drafter_layers": args.layers, "kv_layout": layout,
        "batch": args.batch, "k": args.k, "bucket_prefill": not args.no_bucket,
        "temperature": args.temperature, "top_k": args.top_k,
        "top_p": args.top_p, "mixed_sampling": args.mixed_sampling,
        "draft_sampling": args.draft_sampling,
        "requests": n_req, "prompts": args.prompts,
        "prompt_len": (args.prompt_len if given is None
                       else given.shape[1]),
        "new_tokens": r["total_new_tokens"], "iterations": r["iterations"],
        "otps": r["otps"], "otps_vt": r["otps_vt"],
        "acceptance_length": r["weighted_acceptance_length"],
        "preemptions": r["preemptions"], "peak_pages": r["peak_pages"],
        "prefix_cache": args.prefix_cache, "swap": args.swap,
        "adaptive_k": args.adaptive_k, "shared_prefix": args.shared_prefix,
        "cache_hit_tokens": r["cache_hit_tokens"],
        "cache_hit_requests": r["cache_hit_requests"],
        "preempt_swap": r["preempt_swap"],
        "preempt_recompute": r["preempt_recompute"],
        "host_pool_peak_bytes": r["host_pool"]["peak_bytes"],
        "speculation": r.get("speculation"),
        "p50_latency_vt": r["p50_latency_vt"],
        "p99_latency_vt": r["p99_latency_vt"],
        "makespan_vt": r["makespan_vt"], "wall_s": r["wall_s"],
    }
    if args.round_based:
        # one contiguous state a round: a paged engine's weights are shared
        # by a contiguous twin
        rb_eng = eng if not eng.paged else Engine(
            eng.tcfg, eng.dcfg, eng.tparams, eng.dparams,
            dataclasses.replace(eng.ecfg, kv_layout="contiguous",
                                prefix_cache=False, swap="none"),
            eng.batch, device=dev)
        reqs = requests()
        for _ in range(args.runs):
            rb = serve_round_based(rb_eng, [q.prompt for q in reqs],
                                   [q.max_new_tokens for q in reqs])
        report["round_based"] = {
            "otps": rb["otps"], "rounds": rb["rounds"],
            "acceptance_length": rb["mean_acceptance_length"],
            "new_tokens": rb["total_new_tokens"], "wall_s": rb["wall_s"]}
        report["continuous_over_round_based"] = (
            r["otps"] / max(rb["otps"], 1e-9))
    if args.shard_model:
        report["shard_model"] = args.shard_model
        torch.distributed.destroy_process_group()
        if int(os.environ["RANK"]) != 0:
            return report
    print(json.dumps(report))
    return report


def init_ranks(n: int, dev: torch.device) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``nccl`` on the card, ``gloo`` on the CPU) and return this rank's
    device (``cuda:LOCAL_RANK``). Refuses a world that is not ``n`` ranks
    or a launch without ``torchrun``."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"--shard-model {n} runs under torchrun "
                         f"--nproc-per-node {n}")
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise SystemExit(f"--shard-model {n} over a world of {world} ranks: "
                         f"they must be equal")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo")
    return dev


if __name__ == "__main__":
    main()

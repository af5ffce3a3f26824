"""Step functions and their per-rank inputs for the dry-run and the
sharded train step.

Counterpart of the JAX package's ``launch/steps.py``. One ``build_*``
function per workload shape kind:

  train   -> ``build_train_step``: frozen-target taps, the P-EAGLE
             drafter's COD-expanded MTP loss (K_train 8, r 0.8, the paper's
             §5.1 configuration) and AdamW, with ``n_micro`` micro-batches
             accumulated on each rank (fewer where the rank holds fewer
             rows);
  prefill -> ``build_prefill_step``: the target prefill filling the KV
             cache, returning the cache, the last taps and the first token;
  decode  -> ``build_serve_step``: one speculative iteration
             (``serving.engine.speculative_step``).

Each returns ``(fn, make_inputs)``. ``fn`` runs under the active mesh
(``sharding.utils.mesh_scope``; no mesh: one process, everything whole).
``make_inputs(mesh)`` builds this rank's inputs (rank 0's for a described
mesh) on the meta device at their at-rest shapes (``device=`` another
device: seeded random weights, for a run): weights (and AdamW moments) as
``Shard`` s under the training profile's ``param_specs``, the batch cut to
the rank's rows over ("pod", "data") or, where their product does not
divide it, "data" alone (``batch_split``), K/V caches holding the rank's
slice of their trailing axes (``sharding.utils.kv_spec``, which is
``cache_specs``' rule for them) and, where no batch axis divides the
batch, of their sequence (context parallelism). ``shard_train_inputs``
places real tensors the same way for a run.

The train step runs the trainer's stages (``training.trainer``'s
``target_taps``, ``drafter_loss`` and ``param_grads``) on each
micro-batch; what is its own is the sharding around them. Its dataflow
is ZeRO-3 / FSDP's, in eager PyTorch: the drafter's weights are gathered
whole for the step and its AdamW moments stay sliced; the target's are
gathered a layer at a time in its forward; each rank runs its
micro-batches, the float32 gradients are averaged over the batch axes
(``all_reduce_mean``), clipped by their global norm (equal on every
rank), and each rank updates its own slice of the weights and moments.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import (INPUT_SHAPES, DrafterConfig, InputShape,
                                 ModelConfig)
from repro_torch.core import cod
from repro_torch.core import drafter as D
from repro_torch.models.registry import extra_input_shapes, get_model
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, linear_warmup_schedule)
from repro_torch.serving.engine import (EngineConfig, make_decode_state,
                                        speculative_step)
from repro_torch.sharding import utils as SH
from repro_torch.sharding.rules import param_specs
from repro_torch.training.trainer import (TrainConfig, drafter_loss,
                                          param_grads, target_taps)
from repro_torch.tree import leaves, tree_map

Tensor = torch.Tensor


def input_shape(shape) -> InputShape:
    """An ``InputShape``, or the one of ``INPUT_SHAPES`` a name gives;
    every ``build_*`` function takes either (a scaled-down shape for tests)."""
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def resolve_drafter(tcfg: ModelConfig, n_layers: int = 4,
                    **kw) -> DrafterConfig:
    return DrafterConfig(n_layers=n_layers, **kw).resolve(tcfg)


def adapt_for_shape(tcfg: ModelConfig,
                    shape_name: str) -> Optional[ModelConfig]:
    """The (possibly variant) config for this shape, or None = skip."""
    if shape_name != "long_500k":
        return tcfg
    if tcfg.long_context == "skip":
        return None
    if tcfg.long_context == "sliding_window":
        # beyond-spec rolling-KV variant: every layer local, window=long_window
        return tcfg.replace(attn_pattern=("local",),
                            window_size=tcfg.long_window)
    return tcfg


def expanded_len(n: int, K: int, r: float) -> int:
    m = cod.expanded_length(n, K, r)
    return int(math.ceil(m / 128) * 128)


# ---------------------------------------------------------------------------
# placing trees and batches on a mesh
# ---------------------------------------------------------------------------

def _device(device, seed: int):
    """(device, generator): no generator on meta (shapes only), seeded
    random weights elsewhere."""
    dev = torch.device(device)
    if dev.type == "meta":
        return dev, None
    return dev, torch.Generator(device=dev).manual_seed(seed)


def batch_split(mesh: Optional[SH.Mesh], global_batch: int):
    """The batch axes a global batch splits over: ("pod", "data") where
    their product divides it, else "data" alone (the pods repeat the
    rows), else none (every rank holds every row)."""
    axes = SH.batch_axes(mesh) if mesh is not None else None
    for cand in (axes, ("data",)):
        if cand and all(a in mesh for a in cand) and global_batch % int(
                np.prod([mesh.shape[a] for a in cand])) == 0:
            return cand
    return ()


def batch_rows(mesh: Optional[SH.Mesh], global_batch: int) -> slice:
    """The rows of a global batch this rank holds (``batch_split``)."""
    axes = batch_split(mesh, global_batch)
    if not axes:
        return slice(0, global_batch)
    lb = global_batch // int(np.prod([mesh.shape[a] for a in axes]))
    i = mesh.offset(axes)
    return slice(i * lb, (i + 1) * lb)


def shard_params(tree, mesh: Optional[SH.Mesh]):
    """``tree`` as ``Shard`` s under the training profile's
    ``param_specs`` (unchanged without a mesh)."""
    if mesh is None:
        return tree
    return SH.shard_tree(tree, param_specs(tree, mesh=mesh), mesh)


def _locals(tree):
    return tree_map(lambda t: t.local if isinstance(t, SH.Shard) else t, tree)


def shard_train_inputs(mesh: Optional[SH.Mesh], tparams, dparams, tokens,
                       labels, extras=None, opt_state=None):
    """The train step's at-rest inputs on this rank from whole ones: the
    target's and the drafter's weights and the AdamW moments (default
    fresh) sharded by ``param_specs``, the rank's rows of ``tokens``,
    ``labels`` and ``extras``. Returns (tparams, dparams, opt_state,
    tokens, labels, extras)."""
    if opt_state is None:
        opt_state = adamw_init(dparams)
    rows = batch_rows(mesh, tokens.shape[0])
    extras = {k: v[rows] for k, v in (extras or {}).items()}
    opt = AdamWState(step=opt_state.step,
                     m=shard_params(opt_state.m, mesh),
                     v=shard_params(opt_state.v, mesh))
    return (shard_params(tparams, mesh), shard_params(dparams, mesh), opt,
            tokens[rows], labels[rows], extras)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def build_train_step(tcfg: ModelConfig, dcfg: DrafterConfig,
                     shape_name="train_4k", *, n_micro: int = 8,
                     tc: Optional[TrainConfig] = None):
    """``(train_step, make_inputs)``. ``train_step(tparams, dparams,
    opt_state, tokens, pos, depth, labels, rng, extras)`` returns
    ``(dparams, opt_state, metrics)``: the new weights and moments at rest
    (slices under a mesh), and ``loss`` (the mean of the micro-batches'
    losses over every rank) and ``grad_norm`` (global, before clipping)."""
    shape = input_shape(shape_name)
    n, GB = shape.seq_len, shape.global_batch
    tc = tc or TrainConfig(total_steps=10_000)
    model = get_model(tcfg)
    sched = linear_warmup_schedule(tc.lr, tc.total_steps, tc.warmup_ratio)
    M = expanded_len(n, dcfg.k_train, dcfg.cod_rate)

    def train_step(tparams, dparams, opt_state, tokens, pos, depth, labels,
                   rng, extras):
        mesh = SH.current_mesh()
        with torch.no_grad():
            full = SH.full_tree(dparams)            # the drafter, whole
        nm = min(n_micro, tokens.shape[0])
        mb = tokens.shape[0] // nm
        if mb * nm != tokens.shape[0]:
            raise ValueError(f"{tokens.shape[0]} rows in {nm} micro-batches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), full)
        step_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        params = tree_map(lambda p: p.detach().requires_grad_(True), full)
        for i in range(nm):
            rows = slice(i * mb, (i + 1) * mb)
            toks = tokens[rows]
            taps = target_taps(model, tparams, toks,
                               {k: v[rows] for k, v in extras.items()})
            loss, _ = drafter_loss(dcfg, tcfg, tc, params, toks, taps, pos,
                                   depth, labels[rows], rng=rng)
            acc = tree_map(lambda a, g: a + g.float() / nm, acc,
                           param_grads(loss, params))
            step_loss = step_loss + loss.detach() / nm
        if mesh is not None:
            for a in leaves(acc):
                SH.all_reduce_mean(a, mesh)
            SH.all_reduce_mean(step_loss, mesh)
        grads, gnorm = clip_by_global_norm(acc, tc.max_grad_norm)
        with torch.no_grad():
            # each rank's slice of the weights, moments and gradients;
            # clipped already, so the update clips nothing more
            g_loc = tree_map(lambda g, like: SH.shard(g, like.spec, mesh)
                             if isinstance(like, SH.Shard) else g,
                             grads, dparams)
            p_loc = _locals(dparams)
            state = AdamWState(step=opt_state.step, m=_locals(opt_state.m),
                               v=_locals(opt_state.v))
            updates, state, om = adamw_update(
                g_loc, state, p_loc, lr=sched, weight_decay=tc.weight_decay,
                max_grad_norm=float("inf"))
            new = tree_map(lambda p, u: p + u, p_loc, updates)

        def rewrap(like, t):
            return SH.Shard(t, like.spec, like.mesh) \
                if isinstance(like, SH.Shard) else t
        new_d = tree_map(rewrap, dparams, new)
        new_opt = AdamWState(step=state.step,
                             m=tree_map(rewrap, opt_state.m, state.m),
                             v=tree_map(rewrap, opt_state.v, state.v))
        return new_d, new_opt, {"loss": step_loss, "grad_norm": gnorm,
                                "lr": om["lr"]}

    def make_inputs(mesh: Optional[SH.Mesh], device="meta", seed: int = 0):
        meta, g = _device(device, seed)
        tparams = model.init(g, device=meta)
        dparams = D.init_params(dcfg, tcfg, g, device=meta)
        tl = model.text_len(n, "train")
        tokens = torch.zeros((GB, tl), dtype=torch.int32, device=meta)
        labels = torch.zeros((GB, M), dtype=torch.int32, device=meta)
        extras = {k: torch.zeros(s, dtype=d, device=meta) for k, (s, d)
                  in extra_input_shapes(tcfg, GB, "train").items()}
        tp, dp, opt, toks, labs, ex = shard_train_inputs(
            mesh, tparams, dparams, tokens, labels, extras)
        args = dict(tparams=tp, dparams=dp, opt_state=opt, tokens=toks,
                    pos=torch.zeros((M,), dtype=torch.int32, device=meta),
                    depth=torch.zeros((M,), dtype=torch.int32, device=meta),
                    labels=labs,
                    rng=torch.zeros((2,), dtype=torch.int64, device=meta))
        return args, ex

    return train_step, make_inputs


# ---------------------------------------------------------------------------
# prefill step
# ---------------------------------------------------------------------------

def _context_parallel(mesh, global_batch: int) -> bool:
    """No batch axis divides the batch: the caches' sequence splits
    instead (context parallelism)."""
    return (mesh is not None and bool(SH.batch_axes(mesh))
            and not batch_split(mesh, global_batch))


def _context_caches(tree, mesh, fn):
    """``fn(leaf, spec)`` applied to the attention leaves (k, v, positions)
    of every full-length cache in ``tree`` (not a ring: a ring's slots are
    a window, not the sequence), ``spec`` cutting the sequence axis over
    the batch axes; other leaves unchanged. Returns a new tree."""
    axes = SH.batch_axes(mesh)
    if isinstance(tree, dict) and "ring" in tree:
        if tree["ring"]:
            return tree
        return {k: fn(v, (None, axes) + (None,) * (v.dim() - 2))
                if k in ("k", "v", "positions") else v
                for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _context_caches(v, mesh, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_context_caches(v, mesh, fn) for v in tree]
    return tree


def build_prefill_step(tcfg: ModelConfig, shape_name="prefill_32k",
                       cache_dtype=torch.bfloat16):
    """``(prefill_step, make_inputs)``: ``prefill_step(tparams, tokens,
    cache, extras)`` fills ``cache`` in place and returns ``(cache,
    last taps, first token)``."""
    shape = input_shape(shape_name)
    model = get_model(tcfg)
    GB, S = shape.global_batch, shape.seq_len

    def prefill_step(tparams, tokens, cache, extras):
        with torch.no_grad():
            out = model.forward(tparams, tokens, mode="prefill", cache=cache,
                                collect_taps=True, head_last_only=True,
                                **extras)
        first = out.logits[:, -1].argmax(-1).to(torch.int32)
        return out.cache, out.taps[:, -1], first

    def make_inputs(mesh: Optional[SH.Mesh], device="meta", seed: int = 0):
        meta, g = _device(device, seed)
        rows = batch_rows(mesh, GB)
        lb = rows.stop - rows.start
        tl = model.text_len(S, "prefill")
        with SH.mesh_scope(mesh):
            cache = model.make_cache(lb, S, dtype=cache_dtype, device=meta)
        args = dict(tparams=shard_params(model.init(g, device=meta), mesh),
                    tokens=torch.zeros((lb, tl), dtype=torch.int32,
                                       device=meta),
                    cache=cache)
        ex = {k: torch.zeros(s, dtype=d, device=meta) for k, (s, d)
              in extra_input_shapes(tcfg, lb, "prefill").items()}
        return args, ex

    return prefill_step, make_inputs


# ---------------------------------------------------------------------------
# serve (decode) step: one speculative iteration
# ---------------------------------------------------------------------------

def build_serve_step(tcfg: ModelConfig, dcfg: DrafterConfig,
                     shape_name, *, K: int = 5,
                     cache_dtype: str = "bfloat16",
                     drafter_mode: str = "parallel"):
    """``(serve_step, make_inputs)``: ``serve_step(tparams, dparams,
    state)`` runs one speculative iteration over a decode state whose
    caches hold ``seq_len`` positions (``speculative_step``, the sampled
    lane included). Where the batch does not divide the batch axes the
    caches rest cut along their sequence (context parallelism) and the
    step gathers them first."""
    shape = input_shape(shape_name)
    model = get_model(tcfg)
    GB, S = shape.global_batch, shape.seq_len
    max_len = S + 64
    ecfg = EngineConfig(K=K, max_new_tokens=1 << 30,
                        drafter_mode=drafter_mode, cache_dtype=cache_dtype,
                        max_len=max_len)

    def serve_step(tparams, dparams, state):
        mesh = SH.current_mesh()
        if mesh is not None and _context_parallel(mesh, GB):
            state = dict(state)
            for key in ("tcache", "dcache"):
                if key in state:
                    state[key] = _context_caches(
                        state[key], mesh,
                        lambda x, spec: SH.gather(x, spec, mesh))
        with torch.no_grad():
            return speculative_step(model, tcfg, dcfg, ecfg, tparams,
                                    dparams, state)

    def make_inputs(mesh: Optional[SH.Mesh], device="meta", seed: int = 0):
        meta, g = _device(device, seed)
        rows = batch_rows(mesh, GB)
        lb = rows.stop - rows.start
        with SH.mesh_scope(mesh):
            state = make_decode_state(model, tcfg, dcfg, ecfg, lb,
                                      device=meta)
        state["last"].fill_(S)
        if mesh is not None and _context_parallel(mesh, GB):
            for key in ("tcache", "dcache"):
                if key in state:
                    state[key] = _context_caches(
                        state[key], mesh,
                        lambda x, spec: SH.shard(x, spec, mesh))
        tparams = model.init(g, device=meta)
        dparams = D.init_params(dcfg, tcfg, g, device=meta,
                                dtype=torch.bfloat16)
        args = dict(tparams=shard_params(tparams, mesh),
                    dparams=shard_params(dparams, mesh), state=state)
        return args, {}

    return serve_step, make_inputs

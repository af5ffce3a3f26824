"""Parameter and cache sharding specs, path-regex based (MaxText style).

Counterpart of the JAX package's ``sharding/rules.py``; the rule tables
are copied verbatim. Rules map a leaf's '/'-joined path
(``tree.leaves_with_paths``: ``blocks/3/attn/wq`` in the port, where the
JAX package has ``blocks/slot0/attn/wq`` with a stacked leading dim) to
entries for its *trailing* dims; the regexes key on the suffix, so one
table serves both, and the entries are filtered by divisibility
(``utils._filter_spec``), so a 10-head attention falls back to whole heads
while its MLP still shards over "model". A spec here is a tuple with one
entry per dim of the leaf (all None: replicated).

Two profiles:

- the training profile (``param_specs``, ``cache_specs``): 2-D weight
  sharding (output or expert dim over "model", the other matrix dim over
  "data"), and K/V caches with the batch over ("pod", "data") where it
  divides, the sequence otherwise (context parallelism), the KV heads over
  "model" with a head_dim fallback;
- the serving profile (``serve_param_specs``, ``serve_state_specs``;
  ``draw_sharded`` draws a tree leaf by leaf and keeps this rank's slices):
  storage sharding for the model-sharded engine over the 1-D ("model",)
  mesh. The training rules' "data" entries drop out under that mesh, so
  each weight keeps about 1/n of its bytes per rank and is gathered on use
  (``utils.use``); the K/V leaves of rank >= 4 (contiguous rows, page
  pools, per-slot rings, an encoder-decoder target's cross K/V) shard
  their KV-head axis, head_dim where the heads do not divide
  (``utils.kv_spec``); everything else replicates: positions and block
  tables (index math), recurrent state (O(B·d) a slot), tokens, counters
  and sampling rows (read back at every scheduler sync).
"""
from __future__ import annotations

import re

import torch

from repro_torch.sharding.utils import (Mesh, Shard, _filter_spec,
                                        current_mesh, is_sharded, kv_spec,
                                        mesh_scope, shard, shard_tree)
from repro_torch.tree import leaves_with_paths, unflatten

# (regex over the path, spec entries of the *trailing* dims); a leaf with
# more dims (a stacked leading one) is padded with None in front, one with
# fewer takes the last entries.
PARAM_RULES = [
    # 2D ("FSDP-style") weight sharding: output/expert dim over model +
    # the other matrix dim over data (§Perf iteration 4 — model-only
    # sharding replicates every weight across the 16-way data axis; for a
    # 27B bf16 target that is 3.4 GB/chip of avoidable replication, and for
    # the drafter it ZeRO-shards AdamW state as well). XLA all-gathers
    # weights per scanned layer on use — classic FSDP dataflow.
    (r"(^|/)embed$", ("model", "data")),
    (r"lm_head$", ("data", "model")),
    # attention projections
    (r"attn/wq$", ("data", "model")),
    (r"attn/wk$", ("data", "model")),
    (r"attn/wv$", ("data", "model")),
    (r"attn/wo$", ("model", "data")),
    (r"attn/b[qkv]$", ("model",)),
    # MLP
    (r"mlp/w_gate$", ("data", "model")),
    (r"mlp/w_up$", ("data", "model")),
    (r"mlp/w_down$", ("model", "data")),
    (r"shared/w_gate$", ("data", "model")),
    (r"shared/w_up$", ("data", "model")),
    (r"shared/w_down$", ("model", "data")),
    # MoE experts: 2D sharding — experts over data, FFN dim over model
    # (§Perf pair B: expert-parallel over model alone replicates the expert
    # stack across the data axis: 50 GB/chip for llama4-maverick. 2D
    # sharding brings per-chip expert weights down 16x; the token dispatch
    # becomes an all-to-all on the data axis.)
    (r"moe/w_gate$", ("data", None, "model")),
    (r"moe/w_up$", ("data", None, "model")),
    (r"moe/w_down$", ("data", "model", None)),
    (r"moe/router$", (None, None)),
    # Mamba-2 mixer: inner channels over model
    (r"in_proj$", (None, "model")),
    (r"out_proj$", ("model", None)),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    # RG-LRU
    (r"rec/in_x$", (None, "model")),
    (r"rec/in_gate$", (None, "model")),
    (r"rec/w_rec_gate$", (None, "model")),
    (r"rec/w_in_gate$", (None, "model")),
    (r"rec/out$", ("model", None)),
    (r"rec/lam$", ("model",)),
    # vision projector
    (r"vis_proj/w1$", (None, "model")),
    (r"vis_proj/w2$", ("model", None)),
]

DRAFTER_RULES = PARAM_RULES  # the drafter is a llama-style transformer

_EMBED = r"(^|/)embed$"


def _param_leaf(path: str, shape, rules, mesh: Mesh):
    nd = len(shape)
    for rx, entries in rules:
        if re.search(rx, path):
            ent = list(entries)
            pad = nd - len(ent)
            if pad < 0:                     # fewer dims: the last entries
                ent = ent[-nd:] if nd else []
                pad = 0
            spec = _filter_spec(shape, [None] * pad + ent, mesh)
            # embed fallback: a vocab that does not divide shards d_model
            if rx == _EMBED and spec == (None, None) and nd == 2:
                spec = _filter_spec(shape, [None, "model"], mesh)
            return spec
    return (None,) * nd


def _specs(tree, fn):
    return unflatten(tree, [fn(p, leaf) for p, leaf in leaves_with_paths(tree)])


def _full_shape(leaf):
    return leaf.full_shape if isinstance(leaf, Shard) else tuple(leaf.shape)


def param_specs(params, rules=PARAM_RULES, mesh: Mesh = None):
    """A tree of specs matching ``params`` (tensors, :class:`Shard` slices
    at their full shape, or anything with a ``shape``) under ``mesh``
    (default the active one; all None without)."""
    mesh = mesh or current_mesh()
    return _specs(params, lambda p, leaf: (None,) * len(_full_shape(leaf))
                  if mesh is None else
                  _param_leaf(p, _full_shape(leaf), rules, mesh))


# per-layer rank of each named cache leaf; more dims are stacked ones
_CACHE_RANKS = {"k": 4, "v": 4, "positions": 2, "conv": 3, "state": 4, "h": 2}


def _cache_leaf(path: str, shape, mesh: Mesh):
    nd = len(shape)
    name = path.rsplit("/", 1)[-1]
    rank = _CACHE_RANKS.get(name)
    if name == "ring" or nd == 0 or rank is None or nd < rank:
        return (None,) * nd
    baxes = tuple(a for a in ("pod", "data") if a in mesh)
    bsize = 1
    for a in baxes:
        bsize *= mesh.shape[a]
    pad = nd - rank
    B = shape[pad]
    batch_ok = B % bsize == 0 and bsize > 1
    ent = [None] * pad
    if name in ("k", "v"):
        ent += [baxes if batch_ok else None,
                None if batch_ok else baxes,     # context parallelism
                "model", None]
        spec = _filter_spec(shape, ent, mesh)
        if spec[pad + 2] is None:                # KV not divisible: hd
            ent[pad + 2], ent[pad + 3] = None, "model"
            spec = _filter_spec(shape, ent, mesh)
        return spec
    if name == "positions":
        ent += [baxes if batch_ok else None, None if batch_ok else baxes]
    elif name == "conv":
        ent += [baxes if batch_ok else None, None, "model"]
    elif name == "state":
        ent += [baxes if batch_ok else None, "model", None, None]
    elif name == "h":
        ent += [baxes if batch_ok else None, "model"]
    return _filter_spec(shape, ent, mesh)


def _shape(leaf):
    return tuple(getattr(leaf, "shape", ()))


def cache_specs(cache, mesh: Mesh = None):
    """Training-profile specs of a cache tree: batch over ("pod", "data")
    where it divides, else the sequence (context parallelism); KV heads
    over "model", head_dim where they do not divide; recurrent leaves'
    channels over "model". A ``ring`` flag replicates."""
    mesh = mesh or current_mesh()
    return _specs(cache, lambda p, leaf: (None,) * len(_shape(leaf))
                  if mesh is None else _cache_leaf(p, _shape(leaf), mesh))


def serve_param_specs(params, mesh: Mesh, rules=PARAM_RULES):
    """Storage-sharding specs of serving weights under the ("model",)
    mesh: the training rules, whose "data" entries drop out, so each weight
    keeps about 1/n of its bytes per rank and is gathered on use."""
    with mesh_scope(mesh):
        return param_specs(params, rules)


def draw_sharded(init, generator: torch.Generator, mesh: Mesh, *, device,
                 rules=PARAM_RULES):
    """This rank's storage-sharded serving tree, drawn leaf by leaf:
    ``init(generator, device, keep)`` draws a parameter tree from
    ``generator`` handing each drawn leaf to the per-leaf hook ``keep``
    (``Model.init``, ``core.drafter.init_params``). A first call on the
    meta device (another generator: no storage, no draw) gives the tree's
    template and the order its leaves are drawn in, so each leaf's spec is
    known when it is drawn; the second draws on ``device`` from
    ``generator`` and cuts each sharded leaf to its :class:`Shard` as soon
    as it is drawn, freeing the full leaf, so ``device`` holds the slices
    plus the one leaf being drawn. The leaves no hook saw (norms, biases)
    are cut after. Bitwise ``shard_tree`` of the tree ``init`` draws
    without a hook, the generator left where that draw leaves it."""
    order = []
    template = init(torch.Generator(), "meta",
                    lambda t: order.append(t) or t)
    spec_of = {id(t): _param_leaf(path, tuple(t.shape), rules, mesh)
               for path, t in leaves_with_paths(template)}
    specs = [spec_of[id(t)] for t in order]
    shapes = [tuple(t.shape) for t in order]
    del order
    drawn = iter(zip(specs, shapes))

    def keep(t):
        spec, shape = next(drawn)
        if tuple(t.shape) != shape:
            raise ValueError(f"drew a leaf of {tuple(t.shape)} where the "
                             f"template drew {shape}")
        return Shard(shard(t, spec, mesh), spec, mesh) \
            if is_sharded(spec) else t
    tree = init(generator, device, keep)
    return shard_tree(tree, serve_param_specs(template, mesh, rules), mesh)


def slice_keeper(template, mesh: Mesh, rules=PARAM_RULES):
    """A per-leaf hook ``keep(path, leaf)`` for a tree read leaf by leaf
    (``checkpoint.load_pytree(keep=)``): each leaf that the serving specs
    of ``template`` shard is cut to this rank's :class:`Shard` as soon as
    it is read, so the whole leaf can go; the others are kept whole.
    ``shard_tree`` with the same specs then gives the tree that cutting
    the whole read tree would give."""
    specs = {path: _param_leaf(path, tuple(t.shape), rules, mesh)
             for path, t in leaves_with_paths(template)}

    def keep(path, t):
        spec = specs[path]
        return Shard(shard(t, spec, mesh), spec, mesh) \
            if is_sharded(spec) else t
    return keep


def _serve_state_leaf(path: str, shape, mesh: Mesh):
    name = path.rsplit("/", 1)[-1]
    if name in ("k", "v") and len(shape) >= 4:
        return kv_spec(shape, mesh)
    return (None,) * len(shape)


def serve_state_specs(state, mesh: Mesh):
    """Storage-sharding specs of a serving decode state, either layout:
    the k/v leaves of rank >= 4 (target, drafter and cross caches;
    contiguous rows, page pools or per-slot rings) shard their KV-head
    axis, head_dim where the heads do not divide; every other leaf
    replicates, so page growth and preemption never move a sharded
    pool's layout."""
    return _specs(state, lambda p, leaf: _serve_state_leaf(p, _shape(leaf),
                                                           mesh))

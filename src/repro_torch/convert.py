"""Turn the JAX package's parameter and cache trees, given as nested dicts
of numpy arrays, into the port's tensors.

The JAX target stacks its layers for ``lax.scan``: ``blocks`` holds one
``slot{i}`` subtree per position in a super-block of ``period`` layers,
each leaf with a leading super-block axis, and ``tail`` holds the
``n_layers % period`` remaining layers unstacked (a dense target's period
is its attention pattern's, an interleaved MoE target's the lcm of that and
2: 4 for llama4, so a 2-layer one is all tail; a hybrid target's its block
pattern's: 3 for recurrentgemma, with a tail of 2). The JAX drafter, the
JAX SSM target and the JAX encoder-decoder target (``enc_blocks`` and
``dec_blocks``) stack their blocks along a leading layer axis (``vmap``).
Their caches are stacked the same way (an SSM target's ``conv`` and
``state`` leaves, and its verify's snapshots, too; an encoder-decoder
target's ``self`` caches and ``cross`` K/V). The port keeps layers as
Python lists, so every converter here unstacks into layer order.
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor(a, device="cpu", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy array (bfloat16 included) -> torch tensor on ``device``."""
    a = np.array(a)     # a writable copy: the port updates caches in place
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, i: int, device, dtype):
    return _map(tree, lambda a: tensor(np.asarray(a)[i], device, dtype))


def _period(cfg: ModelConfig) -> int:
    """Layers in one scanned super-block: a hybrid target's block pattern,
    a dense or MoE target's attention pattern, and for interleaved MoE the
    lcm of that and 2 (the JAX package's ``block_period``)."""
    if cfg.family == "hybrid":
        return len(cfg.hybrid.block_pattern)
    if cfg.moe.n_experts and cfg.moe.pattern == "interleaved":
        return math.lcm(len(cfg.attn_pattern), 2)
    return len(cfg.attn_pattern)


def _scan_layers(tree: dict, cfg: ModelConfig):
    """Yield (subtree, super-block index or None for a tail layer) per
    layer, in layer order, from a scan-stacked ``{"blocks": {slot{i}: ...},
    "tail": {slot{i}: ...}}`` tree."""
    period = _period(cfg)
    n_sb = cfg.n_layers // period
    for sb in range(n_sb):
        for i in range(period):
            yield tree["blocks"][f"slot{i}"], sb
    tail = tree.get("tail", {})
    for i in range(len(tail)):
        yield tail[f"slot{i}"], None


def _stacked(tree: dict):
    """Layers of a tree whose leaves stack the layers on axis 0."""
    def first(t):
        return first(next(iter(t.values()))) if isinstance(t, dict) else t
    return np.asarray(first(tree)).shape[0]


# SSM block leaves kept in float32 whatever the weights' dtype (the JAX
# model makes them float32)
_SSM_F32 = ("ln", "A_log", "dt_bias", "D", "gnorm")


def target_params(jparams: dict, cfg: ModelConfig, *, device="cpu",
                  dtype: Optional[torch.dtype] = None) -> dict:
    """JAX ``models/transformer.init_params`` (or, for the SSM and hybrid
    families, ``models/ssm.init_params`` / ``models/hybrid.init_params``)
    tree -> the port's layout. ``dtype`` casts the weights (norms,
    post-norms, the SSD's A, dt and D and the RG-LRU's ``lam`` stay
    float32, and so does an MoE layer's router); an untied ``lm_head`` and
    a VLM target's ``vis_proj`` come along. An encoder-decoder target's
    (``models/encdec.init_params``) ``enc_blocks`` and ``dec_blocks`` are
    unstacked into layer lists."""
    def conv(a):
        return tensor(a, device, dtype)

    if cfg.family == "encdec":
        out = {"embed": conv(jparams["embed"])}
        for name in ("enc_blocks", "dec_blocks"):
            out[name] = []
            for li in range(_stacked(jparams[name])):
                layer = _layer(jparams[name], li, device, dtype)
                for norm in ("ln1", "lnx", "ln2"):
                    if norm in layer:
                        layer[norm] = layer[norm].float()
                out[name].append(layer)
        for norm in ("enc_norm", "final_norm"):
            out[norm] = tensor(jparams[norm], device, torch.float32)
        return out

    if cfg.family == "ssm":
        blocks = []
        for li in range(_stacked(jparams["blocks"])):
            layer = _layer(jparams["blocks"], li, device, dtype)
            for name in _SSM_F32:
                layer[name] = tensor(np.asarray(jparams["blocks"][name])[li],
                                     device, torch.float32)
            blocks.append(layer)
        return {"embed": conv(jparams["embed"]), "blocks": blocks,
                "final_norm": tensor(jparams["final_norm"], device,
                                     torch.float32)}
    blocks = []
    for sub, sb in _scan_layers(jparams, cfg):
        layer = (_map(sub, conv) if sb is None
                 else _layer(sub, sb, device, dtype))
        for norm in ("ln1", "ln2", "pn1", "pn2"):
            if norm in layer:
                layer[norm] = layer[norm].float()
        # lam and a router from the source: a cast would round them
        for outer, name in (("rec", "lam"), ("moe", "router")):
            if outer in layer:
                a = np.asarray(sub[outer][name])
                layer[outer][name] = tensor(a if sb is None else a[sb],
                                            device, torch.float32)
        blocks.append(layer)
    out = {"embed": conv(jparams["embed"]), "blocks": blocks,
           "final_norm": tensor(jparams["final_norm"], device, torch.float32)}
    if "lm_head" in jparams:
        out["lm_head"] = conv(jparams["lm_head"])
    if "vis_proj" in jparams:
        out["vis_proj"] = _map(jparams["vis_proj"], conv)
    return out


def jax_checkpoint(directory: str, name: str,
                   step: Optional[int] = None) -> dict:
    """The tree the JAX package's ``checkpoint.save_pytree`` wrote under
    ``name`` at ``step`` (the latest by default), as nested dicts of numpy
    arrays in its own (stacked) layout: the npz keys are the tree's
    ``/``-joined paths, and a leaf recorded as bfloat16 in
    ``<name>.meta.json`` (stored as a uint16 view) comes back widened to
    float32, exactly (numpy has no bfloat16). Feed the result to
    :func:`drafter_params` or :func:`target_params`."""
    from repro_torch.checkpoint.store import latest_step
    if step is None:
        step = latest_step(directory, name)
        if step is None:
            raise FileNotFoundError(f"no {name} under {directory}")
    base = os.path.join(directory, f"step_{step:08d}")
    dtypes = {}
    meta_fn = os.path.join(base, f"{name}.meta.json")
    if os.path.exists(meta_fn):
        with open(meta_fn) as f:
            dtypes = json.load(f).get("dtypes", {})
    tree: dict = {}
    with np.load(os.path.join(base, f"{name}.npz")) as data:
        for key in data.files:
            arr = data[key]
            if dtypes.get(key) == "bfloat16":
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            *outer, leaf = key.split("/")
            node = tree
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return tree


def drafter_params(jparams: dict, *, device="cpu",
                   dtype: Optional[torch.dtype] = None) -> dict:
    """JAX ``core/drafter.init_params`` tree -> the port's layout."""
    n_layers = np.asarray(jparams["blocks"]["ln1"]).shape[0]
    out = {k: tensor(v, device, dtype) for k, v in jparams.items()
           if k not in ("blocks", "final_norm", "alpha")}
    out["final_norm"] = tensor(jparams["final_norm"], device, torch.float32)
    if "alpha" in jparams:
        out["alpha"] = tensor(jparams["alpha"], device, torch.float32)
    out["blocks"] = []
    for li in range(n_layers):
        layer = _layer(jparams["blocks"], li, device, dtype)
        for norm in ("ln1", "ln2"):
            layer[norm] = layer[norm].float()
        out["blocks"].append(layer)
    return out


def _layer_cache(c: dict, i: Optional[int], device) -> dict:
    def pick(a):
        a = np.asarray(a)
        return a if i is None else a[i]
    return {"k": tensor(pick(c["k"]), device),
            "v": tensor(pick(c["v"]), device),
            "positions": tensor(pick(c["positions"]), device, torch.int32),
            "ring": bool(pick(c["ring"]))}


def _mixed_layer(sub, sb: Optional[int], device):
    """One layer of a hybrid tree: a KV cache, recurrent leaves (``conv``,
    ``h``: their dtype kept), or None (an attention layer's snapshots)."""
    if sub is None:
        return None
    if "positions" in sub:
        return _layer_cache(sub, sb, device)
    return (_map(sub, lambda a: tensor(a, device)) if sb is None
            else _layer(sub, sb, device, None))


def target_cache(jcache: dict, cfg: ModelConfig, *, device="cpu") -> dict:
    """JAX ``models/transformer.make_cache`` tree -> ``{"blocks": [...]}``.
    A ring keeps the JAX package's length (``window`` slots), not the
    port's ``window + block``; each layer keeps its own ring flag. An SSM
    target's (``models/ssm.make_cache``, or its verify's snapshots) keeps
    its ``conv`` and ``state`` leaves, one layer each. A hybrid target's
    (``models/hybrid.make_cache``, or its verify's ``aux["snapshots"]``,
    whose recurrent leaves carry T on the axis after the batch and whose
    attention layers are None) mixes KV caches and ``conv`` / ``h``
    leaves in layer order. An encoder-decoder target's
    (``models/encdec.make_cache``) gives each decoder layer its ``self``
    KV cache and its ``cross`` K/V."""
    if cfg.family == "ssm":
        return ssm_layers(jcache["blocks"], device=device)
    if cfg.family == "encdec":
        c = jcache["blocks"]
        return {"blocks": [
            {"self": _layer_cache(c["self"], li, device),
             "cross": _layer(c["cross"], li, device, None)}
            for li in range(_stacked(c["cross"]))]}
    return {"blocks": [_mixed_layer(sub, sb, device)
                       for sub, sb in _scan_layers(jcache, cfg)]}


def ssm_layers(jblocks: dict, *, device="cpu") -> dict:
    """A JAX SSM tree stacked on the layer axis (a cache's ``blocks``, or
    ``aux["snapshots"]["blocks"]``) -> ``{"blocks": [{"conv", "state"},
    ...]}``, every leaf keeping its dtype."""
    return {"blocks": [_layer(jblocks, li, device, None)
                       for li in range(_stacked(jblocks))]}


def drafter_cache(jcache: dict, *, device="cpu") -> dict:
    """JAX ``core/drafter.make_cache`` tree -> ``{"blocks": [...]}``."""
    c = jcache["blocks"]
    n_layers = np.asarray(c["positions"]).shape[0]
    return {"blocks": [_layer_cache(c, li, device) for li in range(n_layers)]}


def decode_state(jstate: dict, cfg: ModelConfig, *, device="cpu") -> dict:
    """A JAX engine's decode state (nested dicts of numpy arrays) -> the
    port's. The ``"sampling"`` subtree keeps its leaves; its uint32 keys
    become int64 words. A paged state's pools (NP, page, ...) get the
    port's sink page appended (positions -1, K/V 0) and keep their
    ``block_table``; an SSM or hybrid target's recurrent leaves and an
    encoder-decoder target's cross K/V are per slot in both layouts."""
    out = {k: tensor(v, device) for k, v in jstate.items()
           if k not in ("tcache", "dcache", "sampling")}
    if "sampling" in jstate:
        samp = jstate["sampling"]
        out["sampling"] = {k: tensor(np.asarray(v).astype(np.int64)
                                     if k == "key" else v, device)
                           for k, v in samp.items()}
    out["tcache"] = target_cache(jstate["tcache"], cfg, device=device)
    if "dcache" in jstate:
        out["dcache"] = drafter_cache(jstate["dcache"], device=device)
    if "block_table" in jstate:
        for name in ("tcache", "dcache"):
            for c in out.get(name, {"blocks": []})["blocks"]:
                c = c.get("self", c)     # an encoder-decoder layer's pool
                if "positions" not in c:  # recurrent leaves stay per slot
                    continue
                c["k"] = torch.cat([c["k"], torch.zeros_like(c["k"][:1])])
                c["v"] = torch.cat([c["v"], torch.zeros_like(c["v"][:1])])
                c["positions"] = torch.cat(
                    [c["positions"], torch.full_like(c["positions"][:1], -1)])
    return out

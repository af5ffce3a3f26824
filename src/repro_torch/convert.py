"""Turn the JAX package's parameter and cache trees, given as nested dicts
of numpy arrays, into the port's tensors.

The JAX target stacks its layers for ``lax.scan``: ``blocks`` holds one
``slot{i}`` subtree per position in a super-block of ``period`` layers,
each leaf with a leading super-block axis, and ``tail`` holds the
``n_layers % period`` remaining layers unstacked. The JAX drafter stacks
its blocks along a leading layer axis (``vmap``). Their KV caches are
stacked the same way. The port keeps layers as Python lists, so every
converter here unstacks into layer order.
"""
from __future__ import annotations

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


def _scan_layers(tree: dict, cfg: ModelConfig):
    """Yield one subtree per layer, in layer order, from a scan-stacked
    ``{"blocks": {slot{i}: ...}, "tail": {slot{i}: ...}}`` tree. A dense
    target's super-block spans its attention pattern (MoE is not ported)."""
    period = len(cfg.attn_pattern)
    n_sb = cfg.n_layers // period
    for sb in range(n_sb):
        for i in range(period):
            yield tree["blocks"][f"slot{i}"], sb
    tail = tree.get("tail", {})
    for i in range(len(tail)):
        yield tail[f"slot{i}"], None


def target_params(jparams: dict, cfg: ModelConfig, *, device="cpu",
                  dtype: Optional[torch.dtype] = None) -> dict:
    """JAX ``models/transformer.init_params`` tree -> the port's layout.
    ``dtype`` casts the weights (norms stay float32)."""
    def conv(a):
        return tensor(a, device, dtype)

    blocks = []
    for sub, sb in _scan_layers(jparams, cfg):
        layer = (_map(sub, conv) if sb is None
                 else _layer(sub, sb, device, dtype))
        for norm in ("ln1", "ln2"):
            layer[norm] = layer[norm].float()
        blocks.append(layer)
    return {"embed": conv(jparams["embed"]), "blocks": blocks,
            "final_norm": tensor(jparams["final_norm"], device, torch.float32)}


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


def target_cache(jcache: dict, cfg: ModelConfig, *, device="cpu") -> dict:
    """JAX ``models/transformer.make_cache`` tree -> ``{"blocks": [...]}``."""
    return {"blocks": [_layer_cache(sub, sb, device)
                       for sub, sb in _scan_layers(jcache, cfg)]}


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
    ``block_table``."""
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
                c["k"] = torch.cat([c["k"], torch.zeros_like(c["k"][:1])])
                c["v"] = torch.cat([c["v"], torch.zeros_like(c["v"][:1])])
                c["positions"] = torch.cat(
                    [c["positions"], torch.full_like(c["positions"][:1], -1)])
    return out

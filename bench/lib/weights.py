"""The benchmark's own weights: drawn on the device from ``--seed`` in a
few large calls, in the port's tree layout, and handed alike to the
program and to the reference.

Every weight in the served dtype is a view into one buffer drawn by one
``randn`` call, clipped at 3 and scaled per leaf (1 / sqrt(fan-in) for a
projection, 0.02 for embeddings, biases and the drafter's shared hidden
input); every float32 leaf (norm gains) is a view into a second buffer,
1 + 0.1 N(0, 1). Biases and gains are drawn away from their usual zeros
and ones so that the comparison sees them. The layout is the port's
(``models/transformer.py``, ``core/drafter.py``), written out here from the
configuration: the benchmark calls no initialiser of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (path, shape, dtype group "w" | "f32", init: dense | small | norm)
Leaf = Tuple[Tuple, Tuple[int, ...], str, str]


def target_layout(t: dict) -> List[Leaf]:
    d, H, KV, hd, f = (t["d_model"], t["n_heads"], t["n_kv_heads"],
                       t["head_dim"], t["d_ff"])
    out: List[Leaf] = [(("embed",), (t["vocab_size"], d), "w", "small")]
    moe = t.get("moe") or {}
    for i in range(t["n_layers"]):
        b = ("blocks", i)
        out += [(b + ("ln1",), (d,), "f32", "norm"),
                (b + ("ln2",), (d,), "f32", "norm"),
                (b + ("attn", "wq"), (d, H * hd), "w", "dense"),
                (b + ("attn", "wk"), (d, KV * hd), "w", "dense"),
                (b + ("attn", "wv"), (d, KV * hd), "w", "dense"),
                (b + ("attn", "wo"), (H * hd, d), "w", "dense")]
        if t.get("qkv_bias"):
            out += [(b + ("attn", "bq"), (H * hd,), "w", "small"),
                    (b + ("attn", "bk"), (KV * hd,), "w", "small"),
                    (b + ("attn", "bv"), (KV * hd,), "w", "small")]
        if moe.get("n_experts"):
            E = moe["n_experts"]
            out += [(b + ("moe", "router"), (d, E), "f32", "small"),
                    (b + ("moe", "w_gate"), (E, d, f), "w", "dense"),
                    (b + ("moe", "w_up"), (E, d, f), "w", "dense"),
                    (b + ("moe", "w_down"), (E, f, d), "w", "dense")]
        else:
            out += [(b + ("mlp", "w_gate"), (d, f), "w", "dense"),
                    (b + ("mlp", "w_up"), (d, f), "w", "dense"),
                    (b + ("mlp", "w_down"), (f, d), "w", "dense")]
    out.append((("final_norm",), (d,), "f32", "norm"))
    if not t.get("tie_embeddings", True):
        out.append((("lm_head",), (d, t["vocab_size"]), "w", "dense"))
    return out


def drafter_layout(dr: dict, t: dict) -> List[Leaf]:
    d, H, KV, hd, f = (dr["d_model"], dr["n_heads"], dr["n_kv_heads"],
                       dr["head_dim"], dr["d_ff"])
    out: List[Leaf] = [
        (("embed",), (t["vocab_size"], d), "w", "small"),
        (("fc",), (dr["num_taps"] * t["d_model"], d), "w", "dense"),
        (("fuse",), (2 * d, d), "w", "dense"),
        (("h_shared",), (d,), "w", "small")]
    for i in range(dr["n_layers"]):
        b = ("blocks", i)
        out += [(b + ("ln1",), (d,), "f32", "norm"),
                (b + ("ln2",), (d,), "f32", "norm"),
                (b + ("attn", "wq"), (d, H * hd), "w", "dense"),
                (b + ("attn", "wk"), (d, KV * hd), "w", "dense"),
                (b + ("attn", "wv"), (d, KV * hd), "w", "dense"),
                (b + ("attn", "wo"), (H * hd, d), "w", "dense"),
                (b + ("mlp", "w_gate"), (d, f), "w", "dense"),
                (b + ("mlp", "w_up"), (d, f), "w", "dense"),
                (b + ("mlp", "w_down"), (f, d), "w", "dense")]
    out += [(("final_norm",), (d,), "f32", "norm"),
            (("lm_head",), (d, t["vocab_size"]), "w", "dense")]
    return out


def _numel(shape) -> int:
    return math.prod(shape)


def _place(tree: dict, path: Tuple, leaf) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def draw(layouts: Dict[str, List[Leaf]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, dict]:
    """The trees of ``layouts`` (name -> leaves) drawn from ``seed`` on
    ``device``: one ``randn`` for every ``dtype`` leaf of every tree, one
    for the float32 ones."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {"w": 0, "f32": 0}
    for leaves in layouts.values():
        for _, shape, group, _ in leaves:
            sizes[group] += _numel(shape)
    bufs = {"w": torch.randn(sizes["w"], generator=gen, device=device,
                             dtype=dtype).clamp_(-3.0, 3.0),
            "f32": torch.randn(sizes["f32"], generator=gen, device=device,
                               dtype=torch.float32)}
    offs = {"w": 0, "f32": 0}
    trees: Dict[str, dict] = {}
    for name, leaves in layouts.items():
        tree: dict = {}
        for path, shape, group, init in leaves:
            n = _numel(shape)
            leaf = bufs[group][offs[group]:offs[group] + n].view(shape)
            offs[group] += n
            if init == "dense":
                leaf.mul_(1.0 / math.sqrt(shape[-2]))
            elif init == "small":
                leaf.mul_(0.02)
            else:
                leaf.mul_(0.1).add_(1.0)
            _place(tree, path, leaf)
        trees[name] = tree
    return trees

"""Tree checkpointing: flattened-path npz + json metadata.

Counterpart of the JAX package's ``checkpoint/store.py``, with its on-disk
layout: <dir>/step_<N>/<name>.npz — one npz per named tree (drafter
params, optimizer state, ...), keys are '/'-joined tree paths (dict keys,
list indices, NamedTuple fields), bfloat16 stored as a uint16 view with the
logical dtype recorded in <name>.meta.json. The port's trees keep layers
as lists, so their keys name the layer (``blocks/0/attn/wq``) where the
JAX package's stacked trees do not.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, unflatten


def _to_numpy(leaf: torch.Tensor):
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_pytree(tree: Any, directory: str, name: str, step: int,
                metadata: Optional[dict] = None) -> str:
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in leaves_with_paths(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    fn = os.path.join(d, f"{name}.npz")
    np.savez(fn, **arrays)
    meta = dict(metadata or {})
    meta["step"] = step
    meta["dtypes"] = dtypes
    with open(os.path.join(d, f"{name}.meta.json"), "w") as f:
        json.dump(meta, f)
    return fn


def load_pytree(template: Any, directory: str, name: str,
                step: Optional[int] = None) -> Any:
    """The tree saved under ``name`` at ``step`` (the latest by default),
    shaped like ``template``, each leaf on its template leaf's device and
    in its dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    base = os.path.join(directory, f"step_{step:08d}")
    dtypes = {}
    meta_fn = os.path.join(base, f"{name}.meta.json")
    if os.path.exists(meta_fn):
        with open(meta_fn) as f:
            dtypes = json.load(f).get("dtypes", {})
    out = []
    with np.load(os.path.join(base, f"{name}.npz")) as data:
        for key, tmpl in leaves_with_paths(template):
            arr = data[key]
            if dtypes.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                                 f"{tuple(tmpl.shape)}")
            out.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
    return unflatten(template, out)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", f))]
    return max(steps) if steps else None

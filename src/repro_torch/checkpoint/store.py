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
from typing import Any, Callable, Optional

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
                step: Optional[int] = None, *, device=None,
                keep: Optional[Callable[[str, torch.Tensor], Any]] = None
                ) -> Any:
    """The tree saved under ``name`` at ``step`` (the latest by default),
    shaped like ``template``: each leaf cast once to its template leaf's
    dtype, on ``device`` (default: the template leaf's; a template on the
    meta device holds no storage). The npz members are read one at a time,
    and ``keep(path, leaf)``, when given, is handed each leaf as soon as it
    is read: what it returns stands in the tree (a sharded build keeps its
    slice and drops the rest), so no more than one whole leaf is held at
    once. A checkpoint whose leaves are not the template's (a missing or
    an extra leaf, another shape) raises, naming the leaf."""
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
    fn = os.path.join(base, f"{name}.npz")
    out = []
    with np.load(fn) as data:
        paths = leaves_with_paths(template)
        for key, tmpl in paths:
            if key not in data.files:
                raise ValueError(f"{fn}: the template's leaf {key} is "
                                 "missing")
            arr = data[key]
            if dtypes.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"{fn}: leaf {key} has shape "
                                 f"{tuple(t.shape)}, the template "
                                 f"{tuple(tmpl.shape)}")
            t = t.to(device=device or tmpl.device, dtype=tmpl.dtype)
            out.append(t if keep is None else keep(key, t))
            del arr, t
        extra = sorted(set(data.files) - {key for key, _ in paths})
    if extra:
        raise ValueError(f"{fn}: leaf {extra[0]} is not in the template "
                         f"({len(extra)} such leaves)")
    return unflatten(template, out)


def latest_step(directory: str, name: Optional[str] = None
                ) -> Optional[int]:
    """The latest step under ``directory`` (that holds ``name``'s npz, when
    given); None when there is none."""
    if not directory or not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", f)) and (
                 name is None or os.path.exists(
                     os.path.join(directory, f, f"{name}.npz")))]
    return max(steps) if steps else None

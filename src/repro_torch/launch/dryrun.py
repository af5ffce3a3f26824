"""Dry-run of every (architecture x input shape) on the H100 production
meshes, on the meta device: how many GPUs each published model needs and
what bounds its step.

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each step for 256 and 512 TPU chips. Here a production mesh is a
description (``launch/mesh.py``: (data=32, model=8) and (pod=2, data=32,
model=8)), and rank 0's step runs eagerly on the meta device: its inputs
at their at-rest shard shapes (``launch/steps.py``), its gathers making
empty tensors of the gathered shape and counting their bytes. Each record
holds:

- ``memory``: the per-GPU bytes at rest (weights, AdamW state, caches and
  the rest of the inputs, at their shard shapes), the step's activation
  peak (the most bytes the step's own tensors held at once, counted on
  live meta tensors), their sum and ``fits_80GB``;
- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  step (per GPU) plus ``attention_flops``, the attention calls' (on meta
  the kernels' wrappers return their output shapes and count QK and PV,
  ``kernels.ops.meta_flops``: no score matrix is built, as on the card),
  and ``bytes_accessed``, every op's operand and result bytes (an upper
  bound on HBM traffic);
- ``collectives``: the collective calls and bytes per kind and axis;
- ``roofline``: the three terms against the H100 constants of
  ``launch/roofline.py``, ``bottleneck`` and ``useful_flops_ratio``.

All of it is an estimate from those constants, not a measurement. A cell
whose step cannot run on meta records ``status: "error"`` with the op
that stopped it. ``--variant optimized`` is the JAX package's optimized
variant: the drafter's blocks recomputed in the training backward
(``DrafterConfig.remat``); its records are written beside the baseline's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k [--multipod] [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --variant optimized
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (adapt_for_shape, build_prefill_step,
                                      build_serve_step, build_train_step,
                                      input_shape, resolve_drafter)
from repro_torch.sharding import utils as SH
from repro_torch.sharding.utils import Shard

GB80 = 80e9
VARIANTS = ("baseline", "optimized")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes(TorchDispatchMode):
    """Counts the bytes of the storages a region's ops create while they
    are alive, and their peak (the inputs' storages, given, are not
    counted: they are at rest), every op's operand and result bytes, and
    remembers the last op dispatched (for an error record)."""

    def __init__(self, at_rest):
        super().__init__()
        self.rest = {t.untyped_storage()._cdata for t in at_rest}
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self.last_op = None
        self._refs = {}            # storage key -> [nbytes, tensors]
        self._seen = set()         # id of tensors already counted

    def _drop(self, key, tid):
        self._seen.discard(tid)
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last_op = str(func)
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs or {})):
            if isinstance(t, torch.Tensor):
                self.accessed += _nbytes(t)
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            self.accessed += _nbytes(t)
            st = t.untyped_storage()
            key = st._cdata
            if key in self.rest or id(t) in self._seen:
                continue
            ent = self._refs.get(key)
            if ent is None:
                ent = self._refs[key] = [st.nbytes(), 0]
                self.live += ent[0]
                self.peak = max(self.peak, self.live)
            ent[1] += 1
            self._seen.add(id(t))
            weakref.finalize(t, self._drop, key, id(t))
        return out


def _tensors(tree):
    out = []

    def walk(t):
        if isinstance(t, Shard):
            out.append(t.local)
        elif isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    return out


def _mesh_name(multi_pod: bool) -> str:
    return "2x32x8" if multi_pod else "32x8"


def run_step(fn, args: dict, extras: Optional[dict], mesh) -> dict:
    """Run ``fn`` on rank 0's meta inputs under ``mesh``: (memory, flops,
    collectives) of the step. Raises with the op that stopped it."""
    rest = _tensors(args) + _tensors(extras or {})
    by_group = {k: sum(_nbytes(t) for t in _tensors(v))
                for k, v in args.items()}
    SH.reset_counters()
    ops.reset_launches()
    live = LiveBytes(rest)
    try:
        with SH.mesh_scope(mesh), FlopCounterMode(display=False) as fc, live:
            if extras is None:
                fn(**args)
            else:
                fn(**args, extras=extras)
    except Exception as e:
        raise RuntimeError(f"{type(e).__name__} at {live.last_op}: {e}") \
            from e
    at_rest = sum(by_group.values()) + sum(_nbytes(t) for t in
                                           _tensors(extras or {}))
    total = at_rest + live.peak
    memory = {"at_rest_bytes": at_rest, "at_rest_by_input": by_group,
              "activation_peak_bytes": live.peak, "total_bytes": total,
              "fits_80GB": bool(total < GB80)}
    attn = sum(ops.meta_flops.values())
    return {"memory": memory,
            "flops": float(fc.get_total_flops()) + attn,
            "attention_flops": attn,
            "bytes_accessed": float(live.accessed),
            "collectives": RL.collective_stats()}


def run_one(arch: str, shape_name, multi_pod: bool, *, k_infer: int = 5,
            n_micro: int = 8, variant: str = "baseline", mesh=None,
            tcfg=None) -> dict:
    """One cell's record. ``shape_name`` may be an ``InputShape``, and
    ``mesh`` / ``tcfg`` override the production mesh and the published
    config (scaled-down runs). ``variant="optimized"`` recomputes each
    drafter block in the training backward (``DrafterConfig.remat``), as
    the JAX package's optimized variant does."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    t0 = time.time()
    shape = input_shape(shape_name)
    shape_name = shape.name
    tcfg = adapt_for_shape(tcfg or get_config(arch), shape_name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.shape.values()),
           "axes": list(mesh.axis_names), "variant": variant}
    if tcfg is None:
        rec.update(status="skip", reason=get_config(arch).long_context)
        return rec
    dcfg = resolve_drafter(tcfg, remat=variant == "optimized")
    if shape.kind == "train":
        fn, make_inputs = build_train_step(tcfg, dcfg, shape, n_micro=n_micro)
    elif shape.kind == "prefill":
        fn, make_inputs = build_prefill_step(tcfg, shape)
    else:
        fn, make_inputs = build_serve_step(tcfg, dcfg, shape, K=k_infer)
    args, extras = make_inputs(mesh)
    if shape.kind == "decode":
        extras = None
    out = run_step(fn, args, extras, mesh)
    model_flops = RL.model_flops_estimate(tcfg, shape, dcfg, k_infer)
    terms = RL.roofline_terms(out["flops"], out["bytes_accessed"],
                              out["collectives"], mesh.size,
                              model_flops=model_flops)
    rec.update(status="ok", seconds=round(time.time() - t0, 1),
               n_gpus=mesh.size, roofline=terms, **out)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--n-micro", type=int, default=8)
    ap.add_argument("--variant", default="baseline", choices=VARIANTS,
                    help="optimized: the drafter's blocks recomputed in the "
                         "training backward")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells whose record exists")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multipod]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}" + (
                    "" if args.variant == "baseline" else
                    f"__{args.variant}")
                out_fn = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_fn) and not args.force:
                    print(f"[skip existing] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rec = run_one(arch, shape, mp, k_infer=args.k,
                                  n_micro=args.n_micro, variant=args.variant)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": _mesh_name(mp), "variant": args.variant,
                           "status": "error",
                           "error": repr(e),
                           "traceback": traceback.format_exc()}
                with open(out_fn, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    m = rec["memory"]
                    note = (f"{m['total_bytes'] / 1e9:.1f} GB/GPU, fits "
                            f"{m['fits_80GB']}, "
                            f"{rec['roofline']['bottleneck']}, "
                            f"{rec['seconds']} s")
                else:
                    note = rec.get("error", rec.get("reason", ""))
                print(f"  -> {rec['status']} {note}", flush=True)


if __name__ == "__main__":
    main()

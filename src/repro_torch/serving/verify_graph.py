"""The target's verify forward, replayed from CUDA graphs captured in pieces.

Every speculative step runs the target's decode-mode forward over the K + 1
tokens of each slot (``engine.speculative_step``, ``step.verify``). On one
card that forward is thousands of small eager launches, and the host's
launching, not the card, sets the step's time. ``VerifyGraph`` captures the
forward once and replays it on later steps: the same hand-written kernels
and cuBLAS calls on the same operands.

The forward is captured in pieces. Each paged attention call
(``models.transformer.cache_phase``, through ``kernels.ops.outside_graph``)
ends a piece, is made eagerly, and the next piece begins after it; a
replay runs the pieces in order with the same calls between them, made
again through ``kernels.ops`` (``out=``: into the tensors the next piece
reads). So the paged kernel keeps a Python call with its operands, in
which a wrapper put on ``kernels.ops.paged_decode_attention`` sees each
launch, and every other kernel of the forward, the contiguous decode
kernel's among them, is in the graphs. The pieces share one memory pool.
A call's operands that are leaves of the state (the pools, the block
table) are kept as their place in the state and taken from the step's own
state at each replay, so the graphs hold no reference to a state: one that
a session drops is freed, as it is without graphs.

When it engages. Only on a CUDA engine without a mesh (a storage-sharded
engine gathers each layer over a process group; CPU and meta engines have
no graphs): ``Engine.verify`` is then a ``VerifyGraph``, else ``eager``. A
graph reads its operands by address, so it is keyed on the block's shape
(B, K + 1), the forward's static flags and the (address, shape, dtype) of
every leaf of the target's cache, of the block table and of the target's
weights. The first step under a new key runs eagerly (it also loads every
kernel and warms cuBLAS), the second captures, later ones replay. A new key
drops the old graphs and their pool (a new session's state is a new key,
unless the allocator hands it the freed state's addresses, where the
graphs read it as they read the old one). The serving path writes the
caches and the block table in place (admission, growth, release, swap), so
a session keeps its key; a path that replaces a leaf changes the key and
never replays against stale memory.

The capturing step computes its verify as it captures: each piece is
replayed as soon as it is captured, then the call after it is made, so
every call and kernel runs once in that step as in any other. A replay
calls none of the forward's other Python functions, so a probe that
wraps one, or swaps a kernel for its plain version, runs its engine with
``eager`` in ``engine.verify``; a forward that reads a tensor back to the
host cannot be captured (the capture raises, and leaves the caching
allocator's capture state behind).

What a replay returns. The token block and its positions are copied into
the graphs' input buffers first. Logits, taps and ``aux`` (a recurrent
target's snapshots) are the last piece's output buffers, overwritten by
the next replay: the step reads them and keeps none. The cache returned is
the caller's own tree, which the forward updated in place; a capture whose
forward returned other cache tensors raises. The pool stays reserved for
the session; ``pool_bytes`` is what its capture added to the reserved
device memory.

Counts. Each verify forward is counted once in ``tracing.counters()``:
``verify_graph.eager``, ``.captures`` or ``.replays``. The pieces' kernels
count in ``kernels.ops.launches`` when captured and at every replay, the
calls between them as they are made: the counts stay those of kernels
that ran. While a profiler records, each replay is a ``verify.replay``
span inside ``step.verify``.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.models.transformer import ModelOutput

Tensor = torch.Tensor


class _Place(tuple):
    """A call's operand kept as its path in the step's state."""


def engages(device: torch.device, mesh) -> bool:
    """Whether an engine on ``device`` under ``mesh`` replays its verify
    from graphs: on a CUDA device without a mesh."""
    return device.type == "cuda" and mesh is None


def _signature(tree, out: list) -> list:
    """Append to ``out`` what a graph reads of ``tree`` by address: each
    tensor leaf's (address, shape, dtype), and every other leaf as it is (a
    cache's ``ring`` flag picks the code path)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _signature(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _signature(v, out)
    elif isinstance(tree, Tensor):
        out.append((tree.data_ptr(), tuple(tree.shape), tree.dtype))
    else:
        out.append(tree)
    return out


def graph_key(vt: Tensor, collect_taps: bool, snapshots: bool, cache,
              block_table: Optional[Tensor], tparams) -> tuple:
    """The key a captured verify is valid under: the block's shape, the
    forward's flags, and the addresses, shapes and dtypes of the target's
    cache, the block table and the target's weights."""
    sig: list = [tuple(vt.shape), collect_taps, snapshots]
    for tree in (cache, block_table, tparams):
        sig.append(tuple(_signature(tree, [])))
    return tuple(sig)


def _places(tree, path: tuple, out: dict) -> dict:
    """``out``: id of each tensor leaf of ``tree`` -> its path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _places(v, path + (k,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _places(v, path + (i,), out)
    elif isinstance(tree, Tensor):
        out[id(tree)] = path
    return out


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def eager(model, tparams, vt: Tensor, **kw) -> ModelOutput:
    """The verify forward run eagerly (an engine without graphs)."""
    tracing.count("verify_graph.eager")
    return model.forward(tparams, vt, **kw)


class VerifyGraph:
    """One engine's verify forward, replayed from graphs captured in pieces
    (see the module docstring). Call it as ``model.forward`` is called,
    with the decode-mode keywords of ``speculative_step``."""

    def __init__(self):
        self.pool_bytes = 0
        self._seen = None           # the last eager step's key
        self.drop()

    def drop(self) -> None:
        """Release the graphs, their buffers and their memory pool."""
        self._pieces: list = []     # torch.cuda.CUDAGraph, in order
        self._calls: list = []      # (name, args, kw, out) after each piece
        self._key = self._vt = self._pos = self._out = None
        self._launches: dict = {}   # the pieces' kernels, by name

    def __call__(self, model, tparams, vt: Tensor, *, positions: Tensor,
                 cache, block_table=None, collect_taps=True,
                 snapshots=False, **kw) -> ModelOutput:
        kw.update(positions=positions, cache=cache, block_table=block_table,
                  collect_taps=collect_taps, snapshots=snapshots)
        key = graph_key(vt, collect_taps, snapshots, cache, block_table,
                        tparams)
        if self._pieces and key == self._key:
            with tracing.span("verify.replay"):
                self._vt.copy_(vt)
                self._pos.copy_(positions)
                self._run({"cache": cache, "block_table": block_table})
            for name, n in self._launches.items():
                ops.launches[name] += n
            tracing.count("verify_graph.replays")
        elif key == self._seen:
            self._capture(model, tparams, vt, positions, kw, key)
            tracing.count("verify_graph.captures")
        else:
            self.drop()
            self._seen = key
            return eager(model, tparams, vt, **kw)
        return dataclasses.replace(self._out, cache=cache)

    def _run(self, state: dict) -> None:
        """Replay the pieces, each followed by its call, whose operands
        marked as places are taken from ``state``."""
        for piece, call in zip(self._pieces, self._calls + [None]):
            piece.replay()
            if call is not None:
                name, args, kw, out = call
                args = [_at(state, a) if isinstance(a, _Place) else a
                        for a in args]
                getattr(ops, name)(*args, out=out, **kw)

    def _capture(self, model, tparams, vt, positions, kw, key) -> None:
        """Capture the forward under ``key`` in pieces, computing this
        step's verify as it goes (see the module docstring)."""
        self.drop()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        self._vt, self._pos = vt.clone(), positions.clone()
        kw = dict(kw, positions=self._pos)
        state = {"cache": kw["cache"], "block_table": kw["block_table"]}
        places = _places(state, (), {})
        storages = {_at(state, p).untyped_storage().data_ptr()
                    for p in places.values()}
        pool = torch.cuda.graph_pool_handle()
        before = dict(ops.launches)
        graphed = dict.fromkeys(ops.launches, 0)
        capturing = [False]

        def begin():
            self._pieces.append(torch.cuda.CUDAGraph())
            self._pieces[-1].capture_begin(
                pool=pool, capture_error_mode="thread_local")
            capturing[0] = True

        def end():
            """End the open piece, count its kernels, and run it."""
            self._pieces[-1].capture_end()
            capturing[0] = False
            for name in graphed:
                graphed[name] += ops.launches[name] - before[name]
            self._pieces[-1].replay()

        def split(name, args, call_kw):
            kept = []
            for a in args:
                if isinstance(a, Tensor) and id(a) in places:
                    a = _Place(places[id(a)])
                elif (isinstance(a, Tensor)
                      and a.untyped_storage().data_ptr() in storages):
                    raise RuntimeError(
                        f"a {name} operand is a view of the state, not a "
                        "leaf: the graphs would hold the state")
                kept.append(a)
            end()
            out = getattr(ops, name)(*args, **call_kw)
            self._calls.append((name, kept, call_kw, out))
            before.update(ops.launches)
            begin()
            return out

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), ops.graph_split(split):
            begin()
            try:
                out = model.forward(tparams, self._vt, **kw)
            except BaseException:
                if capturing[0]:
                    self._pieces[-1].capture_end()
                self.drop()
                raise
            end()
        torch.cuda.current_stream().wait_stream(stream)
        if _signature(out.cache, []) != _signature(kw["cache"], []):
            self.drop()
            raise RuntimeError(
                "the verify forward put other tensors in the cache than the "
                "caller's: a replay, which returns the caller's cache, "
                "cannot stand for it")
        self._key, self._launches = key, graphed
        self._out = dataclasses.replace(out, cache=None)
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

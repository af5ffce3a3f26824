"""Meshes, sharding specs and the port's collectives (torch.distributed).

Counterpart of the JAX package's ``sharding/utils.py``. A *spec* is a tuple
with one entry per dim: None (the dim is whole on every rank), an axis
name, or a tuple of names (the dim splits over their product, the first
name major). ``_filter_spec`` drops the names a mesh lacks and the entries
whose names do not divide their dim, as the JAX package does, so one rule
set serves every architecture and mesh.

A :class:`Mesh` lays the first ranks of the world out row-major over its
axes and holds one process group per axis: the ranks that differ only
along it. ``Mesh.build`` makes the groups (collectively: every rank of the
world calls it with the same arguments); ``Mesh.describe`` makes none and
stands for rank 0 of a mesh too large to start, as the dry-run's meshes of
256 and 512 cards do: its collectives run on the meta device only,
producing empty tensors of the gathered shape and counting their bytes.

The storage-sharded profile (``EngineConfig(shard_model=True)``, the
drafter train step of ``launch/steps.py``) keeps weights and K/V sharded at
rest and computes on full tensors gathered right before use, so its
results are bitwise the unsharded port's:

- a weight at rest is a :class:`Shard` (this rank's slice, its spec and
  mesh); ``use`` gathers the shards of one layer's subtree, and the model
  loops call it once a layer (and once for the embedding and the head).
  Without an active mesh (``mesh_scope``) ``use`` is the identity;
- attention K/V at rest are plain tensors holding this rank's slice of
  their trailing ``(KV, hd)`` axes (``kv_spec``): the KV-head axis over
  "model", or head_dim where the heads do not divide. Under an active mesh
  ``make_kv_cache`` allocates that slice (``kv_shape``), ``kv_full``
  gathers a layer's K/V (or pool) right before the kernel and ``kv_local``
  cuts a layer's new K/V to the slice it writes. Cache operations that
  index only batch, sequence or page dims run on the slices as they are.

``shard_hint`` is not ported: eager PyTorch has no partitioner for a hint
to constrain; the gathers above are explicit and the compute runs on full
tensors.

Every collective counts its calls and the bytes of its output, per kind
and axis (``counters`` / ``reset_counters``), the port's counterpart of
the collective statistics the JAX dry-run reads from compiled HLO; ``use``
also keeps the largest subtree one call gathered.

A built mesh also holds a ``gloo`` group over all its ranks for host
objects (nccl carries CUDA tensors only): ``Mesh.broadcast`` sends rank
0's object to every rank, as the wall-clock front end sends its decisions
(``serving/streaming.AsyncEngine``); counted as kind "broadcast", axis
"host".
"""
from __future__ import annotations

import contextlib
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor
AxisEntry = Union[None, str, Sequence[str]]
Spec = Tuple[AxisEntry, ...]


class Mesh:
    """Axis names and sizes over the first ``prod(sizes)`` ranks, laid out
    row-major; this process's coordinates and one group per axis (None for
    a described mesh, which stands for rank 0)."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int],
                 coords: Dict[str, int], groups: Optional[dict],
                 host=None):
        if len(names) != len(sizes):
            raise ValueError(f"axes {names} and sizes {sizes} differ in length")
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.coords = dict(coords)
        self.groups = groups
        self.host = host            # the gloo group of Mesh.broadcast
        # (device, dtype) -> the buffer large gathers reuse (_gather_dim)
        self.scratch: Dict[tuple, Tensor] = {}

    @classmethod
    def build(cls, names: Sequence[str], sizes: Sequence[int]) -> "Mesh":
        """A mesh with a process group per axis, over the first ranks of the
        initialised world; raises when the world is smaller than the mesh
        or no process group is initialised. Collective: every rank calls
        it with the same arguments."""
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("a mesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        world, rank = dist.get_world_size(), dist.get_rank()
        layout = np.arange(int(np.prod(sizes))).reshape(tuple(sizes))
        if layout.size > world:
            raise ValueError(f"a mesh of {layout.size} ranks {dict(zip(names, sizes))}"
                             f" over a world of {world}")
        coords = {}
        if rank < layout.size:
            at = np.argwhere(layout == rank)[0]
            coords = {n: int(c) for n, c in zip(names, at)}
        groups = {}
        for ax, name in enumerate(names):
            lines = np.moveaxis(layout, ax, -1).reshape(-1, sizes[ax])
            for line in lines:          # every rank makes every group
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
        host = dist.new_group([int(r) for r in layout.reshape(-1)],
                              backend="gloo")
        return cls(names, sizes, coords, groups,
                   host if rank < layout.size else None)

    @classmethod
    def describe(cls, names: Sequence[str], sizes: Sequence[int]) -> "Mesh":
        """A mesh without process groups: rank 0's view, for meta-device
        runs (``launch/dryrun.py``)."""
        return cls(names, sizes, {n: 0 for n in names}, None)

    def __contains__(self, name) -> bool:
        return name in self.shape

    def __repr__(self) -> str:
        kind = "described" if self.groups is None else "built"
        return f"Mesh({self.shape}, {kind})"

    def offset(self, names: Sequence[str]) -> int:
        """This rank's chunk index along a dim split over ``names``."""
        idx = 0
        for n in names:
            idx = idx * self.shape[n] + self.coords[n]
        return idx

    @property
    def is_root(self) -> bool:
        """Whether this process is the mesh's first rank (rank 0)."""
        return all(c == 0 for c in self.coords.values())

    def same_layout(self, other: "Mesh") -> bool:
        """Whether ``other`` cuts tensors as this mesh does on this rank:
        the same axes, sizes and coordinates."""
        return (self.axis_names == other.axis_names
                and self.shape == other.shape and self.coords == other.coords)

    def broadcast(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank of the mesh (the others' argument
        is ignored): pickled on rank 0, its length and then its bytes
        broadcast over the mesh's gloo group. Collective over the mesh's
        ranks; one call counted, with the pickle's bytes."""
        if self.host is None:
            raise ValueError(f"{self!r} has no host group to broadcast over")
        root = self.is_root
        data = pickle.dumps(obj) if root else b""
        n = torch.tensor([len(data)], dtype=torch.int64)
        dist.broadcast(n, src=0, group=self.host)
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if root
               else torch.empty(int(n), dtype=torch.uint8))
        dist.broadcast(buf, src=0, group=self.host)
        _count("broadcast", "host", buf)
        return obj if root else pickle.loads(buf.numpy().tobytes())


def serving_mesh(n: Optional[int] = None) -> Mesh:
    """1-D ``("model",)`` mesh over the first ``n`` ranks (the whole world
    when None), the serving engine's storage mesh; raises past the world
    size. There is no data axis: the scheduler's continuous batch is one
    replica, its rows slots of one decode state."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("serving_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n is None else n
    if n < 1 or n > world:
        raise ValueError(f"serving_mesh({n}): the world holds {world} ranks")
    return Mesh.build(("model",), (n,))


# ---------------------------------------------------------------------------
# the active mesh and spec resolution
# ---------------------------------------------------------------------------

_SCOPE: List[Mesh] = []


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh]):
    """Make ``mesh`` the one specs resolve under and the K/V helpers and
    ``use`` act for (None: no mesh, nothing changes)."""
    if mesh is None:
        yield None
        return
    _SCOPE.append(mesh)
    try:
        yield mesh
    finally:
        _SCOPE.pop()


def current_mesh() -> Optional[Mesh]:
    return _SCOPE[-1] if _SCOPE else None


def axis_size(name: str, default: int = 1) -> int:
    mesh = current_mesh()
    if mesh is None or name not in mesh:
        return default
    return mesh.shape[name]


def batch_axes(mesh: Optional[Mesh] = None) -> Optional[Tuple[str, ...]]:
    """Axes the global batch shards over: ("pod", "data") where they exist."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    axes = tuple(a for a in ("pod", "data") if a in mesh)
    return axes or None


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _filter_spec(shape, entries, mesh: Mesh) -> Spec:
    out = []
    for dim, entry in zip(shape, entries):
        names = [n for n in _names(entry) if n in mesh]
        total = int(np.prod([mesh.shape[n] for n in names], dtype=np.int64))
        if not names or total == 0 or dim % total:
            out.append(None)
        else:
            out.append(names[0] if len(names) == 1 else tuple(names))
    return tuple(out)


def spec_for(shape, *entries: AxisEntry) -> Spec:
    """A divisibility-filtered spec for ``shape`` under the active mesh
    (all None without one)."""
    mesh = current_mesh()
    ent = (list(entries) + [None] * len(shape))[:len(shape)]
    if mesh is None:
        return (None,) * len(shape)
    return _filter_spec(shape, ent, mesh)


def local_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    return tuple(d // int(np.prod([mesh.shape[n] for n in _names(e)],
                                  dtype=np.int64))
                 for d, e in zip(shape, spec))


def is_sharded(spec: Spec) -> bool:
    return any(e is not None for e in spec)


# ---------------------------------------------------------------------------
# collectives and their counters
# ---------------------------------------------------------------------------

# (kind, axis) -> [calls, bytes]
_COUNTS: Dict[Tuple[str, str], List[int]] = {}
# use(): calls, bytes gathered, the most one call gathered
_USE = {"calls": 0, "bytes": 0, "max_bytes": 0}


def reset_counters() -> None:
    _COUNTS.clear()
    _USE.update(calls=0, bytes=0, max_bytes=0)


def counters() -> dict:
    """{kind: {"calls", "bytes", "by_axis": {axis: {"calls", "bytes"}}}}
    over the collectives since ``reset_counters``, plus ``"use"``: the
    calls of ``use``, their bytes and the most one call gathered."""
    out: dict = {}
    for (kind, axis), (calls, nbytes) in sorted(_COUNTS.items()):
        k = out.setdefault(kind, {"calls": 0, "bytes": 0, "by_axis": {}})
        k["calls"] += calls
        k["bytes"] += nbytes
        k["by_axis"][axis] = {"calls": calls, "bytes": nbytes}
    out["use"] = dict(_USE)
    return out


def _count(kind: str, axis: str, t: Tensor) -> None:
    c = _COUNTS.setdefault((kind, axis), [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()


def _check_runs(x: Tensor, mesh: Mesh) -> None:
    if mesh.groups is None and x.device.type != "meta":
        raise ValueError(f"{mesh!r} has no process groups: its collectives run "
                         f"on the meta device only, got {x.device}")


def _all_gather_flat():
    """The gather into one tensor along dim 0: ``all_gather_single`` where
    torch has it (it deprecates ``all_gather_into_tensor`` for it), else
    ``all_gather_into_tensor``; gloo and nccl take both."""
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


def _scratch(mesh: Mesh, numel: int, x: Tensor) -> Tensor:
    """``numel`` elements of the mesh's gather buffer for ``x``'s device
    and dtype, grown to the largest request and reused by every large
    gather: a layer's large gathers then peak at their outputs plus this
    one buffer, however long the process group keeps a collective's
    output referenced after the call."""
    key = (x.device, x.dtype)
    buf = mesh.scratch.get(key)
    if buf is None or buf.numel() < numel:
        mesh.scratch.pop(key, None)
        buf = mesh.scratch[key] = torch.empty(numel, dtype=x.dtype,
                                              device=x.device)
    return buf[:numel]


def _gather_dim(x: Tensor, dim: int, mesh: Mesh, axis: str) -> Tensor:
    """All-gather along ``dim`` over ``axis``: the slices end to end in one
    buffer (n, *x.shape), whose rank axis then joins ``dim`` (a view for
    dim 0, one strided copy otherwise). A gather of more than
    ``GATHER_ALONE_BYTES`` lands in the mesh's reused buffer and is copied
    out, so a layer's large gathers hold one buffer between them."""
    n = mesh.shape[axis]
    shape = list(x.shape)
    shape[dim] *= n
    if x.device.type == "meta":
        out = torch.empty(shape, dtype=x.dtype, device="meta")
    else:
        big = n * x.numel() * x.element_size() > GATHER_ALONE_BYTES
        rows = (n * x.shape[0],) + tuple(x.shape[1:])
        buf = (_scratch(mesh, n * x.numel(), x).view(rows) if big else
               torch.empty(rows, dtype=x.dtype, device=x.device))
        _all_gather_flat()(buf, x.contiguous(), group=mesh.groups[axis])
        parts = buf.view((n,) + tuple(x.shape)).movedim(0, dim)
        if big:
            out = torch.empty(shape, dtype=x.dtype, device=x.device)
            out.view(parts.shape).copy_(parts)
        else:
            out = parts.reshape(shape).contiguous()
    _count("all_gather", axis, out)
    return out


def gather(x: Tensor, spec: Spec, mesh: Mesh) -> Tensor:
    """The full tensor of which ``x`` is this rank's slice under ``spec``:
    an all-gather along each sharded dim (the last name of an entry first),
    bitwise the tensor that was sharded. Every entry is gathered, a
    one-rank axis too."""
    _check_runs(x, mesh)
    for dim, entry in enumerate(spec):
        for name in reversed(_names(entry)):
            x = _gather_dim(x, dim, mesh, name)
    return x


def _one_axis(spec: Spec):
    """(dim, axis) of a spec that splits one dim over one axis, else None."""
    split = [(d, _names(e)) for d, e in enumerate(spec) if _names(e)]
    if len(split) == 1 and len(split[0][1]) == 1:
        return split[0][0], split[0][1][0]
    return None


# a slice whose full tensor is larger than this is gathered alone, so its
# gather buffer is freed before the next leaf's (a packed gather holds the
# packed slices, the gathered bytes and the unpacked tensors at once: for
# one of llama4's MoE layers, 3 x 10.7 GB of experts, that is 2.25 layers)
GATHER_ALONE_BYTES = 1 << 30


def gather_many(items, mesh: Mesh) -> List[Tensor]:
    """``gather`` of several (slice, spec) pairs in as few collectives as
    there are axes: the slices split along one dim over the same axis are
    packed end to end as bytes (widest element type first, so every
    offset is aligned), gathered by one call and unpacked; any other spec,
    and a slice of more than ``GATHER_ALONE_BYTES`` in full, is gathered
    alone. Bitwise ``gather``'s tensors; one call is counted a group, with
    the bytes of the full tensors."""
    out: List[Optional[Tensor]] = [None] * len(items)
    groups: Dict[str, List[int]] = {}
    for i, (x, spec) in enumerate(items):
        one = _one_axis(spec)
        if one is None or (x.numel() * x.element_size() * mesh.shape[one[1]]
                           > GATHER_ALONE_BYTES):
            out[i] = gather(x, spec, mesh)
        else:
            groups.setdefault(one[1], []).append(i)
    for axis, idx in groups.items():
        n = mesh.shape[axis]
        if len(idx) == 1:           # one slice: gathered alone, no pack
            out[idx[0]] = gather(*items[idx[0]], mesh)
            continue
        idx.sort(key=lambda i: -items[i][0].element_size())
        fulls = []
        for i in idx:
            x, spec = items[i]
            d = _one_axis(spec)[0]
            shape = list(x.shape)
            shape[d] *= n
            fulls.append(shape)
        _check_runs(items[idx[0]][0], mesh)
        if items[idx[0]][0].device.type == "meta":
            for i, shape in zip(idx, fulls):
                out[i] = torch.empty(shape, dtype=items[i][0].dtype,
                                     device="meta")
        else:
            xs = [items[i][0].contiguous().reshape(-1).view(torch.uint8)
                  for i in idx]
            total = sum(x.numel() for x in xs)
            pad = -total % 16
            flat = torch.cat(xs + [xs[0].new_zeros(pad)])
            buf = torch.empty(n * flat.numel(), dtype=torch.uint8,
                              device=flat.device)
            _all_gather_flat()(buf, flat, group=mesh.groups[axis])
            rows = buf.view(n, flat.numel())
            off = 0
            for i, shape, xb in zip(idx, fulls, xs):
                x, spec = items[i]
                d = _one_axis(spec)[0]
                part = rows[:, off:off + xb.numel()].view(x.dtype)
                part = part.reshape((n,) + tuple(x.shape))
                # contiguous: the kernels take no strides, and a size-1
                # dim beside the rank axis would leave a strided view
                out[i] = part.movedim(0, d).reshape(shape).contiguous()
                off += xb.numel()
        c = _COUNTS.setdefault(("all_gather", axis), [0, 0])
        c[0] += 1
        c[1] += sum(int(np.prod(sh)) * items[i][0].element_size()
                    for i, sh in zip(idx, fulls))
    return out


def shard(x: Tensor, spec: Spec, mesh: Mesh) -> Tensor:
    """This rank's slice of ``x`` under ``spec``: a copy that owns its
    storage, so the full tensor can be freed."""
    out = x
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if names:
            n = int(np.prod([mesh.shape[a] for a in names]))
            size = x.shape[dim] // n
            out = out.narrow(dim, mesh.offset(names) * size, size)
    return out.clone()


def all_reduce_mean(x: Tensor, mesh: Mesh) -> Tensor:
    """In place: the mean of ``x`` over the ranks of the batch axes;
    returns ``x``. Every axis is reduced, a one-rank one too."""
    _check_runs(x, mesh)
    total = 1
    for a in batch_axes(mesh) or ():
        if x.device.type != "meta":
            dist.all_reduce(x, group=mesh.groups[a])
        _count("all_reduce", a, x)
        total *= mesh.shape[a]
    if total > 1:
        x.div_(total)
    return x


# ---------------------------------------------------------------------------
# weights: shards at rest, gathered on use
# ---------------------------------------------------------------------------

class Shard:
    """A weight at rest: this rank's slice ``local`` of a tensor sharded by
    ``spec`` over ``mesh``. Not a tensor: an op on it raises, so a weight
    used without ``use`` cannot pass unnoticed."""
    __slots__ = ("local", "spec", "mesh")

    def __init__(self, local: Tensor, spec: Spec, mesh: Mesh):
        self.local, self.spec, self.mesh = local, spec, mesh

    def __repr__(self) -> str:
        return f"Shard({tuple(self.local.shape)}, {self.spec})"

    @property
    def full_shape(self) -> Tuple[int, ...]:
        """The shape of the tensor this is a slice of."""
        return tuple(d * int(np.prod([self.mesh.shape[n] for n in _names(e)],
                                     dtype=np.int64))
                     for d, e in zip(self.local.shape, self.spec))


def shard_tree(tree, specs, mesh: Mesh, device=None):
    """``tree`` (dicts, lists, tensors) with each leaf whose spec shards a
    dim replaced by its :class:`Shard`; replicated leaves stay tensors.
    ``device``: where the result lies; each leaf is cut where it lies and
    only its slice moves, so ``device`` never holds a whole sharded leaf.
    A leaf that is a :class:`Shard` already (a tree cut as it was drawn)
    is kept, its slice moved; one cut under another spec or for another
    mesh layout raises."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(shard_tree(v, s, mesh, device)
                          for v, s in zip(tree, specs))
    if hasattr(tree, "_fields"):
        return type(tree)(*(shard_tree(v, s, mesh, device)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, Shard):
        if tuple(tree.spec) != tuple(specs) or not \
                tree.mesh.same_layout(mesh):
            raise ValueError(f"{tree!r} was cut for {tree.mesh!r} "
                             f"(coordinates {tree.mesh.coords}); this mesh "
                             f"{mesh!r} ({mesh.coords}) cuts it by {specs}")
        return Shard(tree.local if device is None else
                     tree.local.to(device), tree.spec, mesh)
    if not isinstance(tree, Tensor):
        return tree
    if is_sharded(specs):
        local = shard(tree, specs, mesh)
        return Shard(local if device is None else local.to(device), specs,
                     mesh)
    return tree if device is None else tree.to(device)


def _layer_shards(t, found: List[Shard]) -> None:
    """Append the :class:`Shard` leaves of ``t`` to ``found``: dicts are
    walked, lists (the layer stacks) are not."""
    if isinstance(t, Shard):
        found.append(t)
    elif isinstance(t, dict):
        for v in t.values():
            if not isinstance(v, list):
                _layer_shards(v, found)


def _layer_rebuilt(t, by_id: Dict[int, Tensor]):
    """``t`` with each :class:`Shard` replaced by its gathered tensor."""
    if isinstance(t, Shard):
        return by_id[id(t)]
    if isinstance(t, dict):
        return {k: v if isinstance(v, list) else _layer_rebuilt(v, by_id)
                for k, v in t.items()}
    return t


def use(tree):
    """The full weights of one layer's subtree (or of one leaf): every
    :class:`Shard` in it gathered, in one collective per axis
    (``gather_many``); dicts are walked, lists (the layer stacks) are not,
    so ``use(params)`` gathers the top-level leaves and leaves ``blocks``
    for the loop. The identity without an active mesh. Nothing but the
    returned tree holds the gathered tensors (no closure cycle that only
    the garbage collector would break), so a layer's weights are freed as
    soon as the caller drops them."""
    if not _SCOPE:
        return tree
    found: List[Shard] = []
    _layer_shards(tree, found)
    if not found:
        return tree
    fulls = gather_many([(t.local, t.spec) for t in found], found[0].mesh)
    nbytes = sum(f.numel() * f.element_size() for f in fulls)
    _USE["calls"] += 1
    _USE["bytes"] += nbytes
    _USE["max_bytes"] = max(_USE["max_bytes"], nbytes)
    return _layer_rebuilt(tree, {id(t): f for t, f in zip(found, fulls)})


def full_tree(tree):
    """Every :class:`Shard` of ``tree``, lists included, gathered
    (``gather_many``): a whole parameter tree, as the train step gathers
    its drafter, or for checks and checkpoints; not for serving."""
    from repro_torch.tree import leaves, unflatten
    flat = leaves(tree)
    found = [t for t in flat if isinstance(t, Shard)]
    if not found:
        return tree
    fulls = iter(gather_many([(t.local, t.spec) for t in found],
                             found[0].mesh))
    return unflatten(tree, [next(fulls) if isinstance(t, Shard) else t
                            for t in flat])


# ---------------------------------------------------------------------------
# attention K/V: the trailing (KV, hd) axes sharded at rest
# ---------------------------------------------------------------------------

def kv_spec(shape, mesh: Mesh) -> Spec:
    """The K/V rule: the KV-head axis (dim -2) over "model", or head_dim
    (dim -1) where the heads do not divide; every other dim whole."""
    nd = len(shape)
    ent: List[AxisEntry] = [None] * nd
    ent[nd - 2] = "model"
    spec = _filter_spec(shape, ent, mesh)
    if spec[nd - 2] is None:
        ent[nd - 2], ent[nd - 1] = None, "model"
        spec = _filter_spec(shape, ent, mesh)
    return spec


def kv_shape(shape) -> Tuple[int, ...]:
    """The at-rest shape of a K/V leaf of full ``shape`` under the active
    mesh (the full shape without one)."""
    mesh = current_mesh()
    if mesh is None:
        return tuple(shape)
    return local_shape(shape, kv_spec(shape, mesh), mesh)


def kv_zeros(shape, *, dtype, device) -> Tensor:
    """A zero K/V leaf of full ``shape``, at its at-rest shape."""
    return torch.zeros(kv_shape(shape), dtype=dtype, device=device)


def kv_full(xs: Sequence[Tensor], n_kv: int,
            head_dim: int) -> List[Tensor]:
    """A layer's K/V leaves (rows, pools or rings) at their full trailing
    (n_kv, head_dim) axes: gathered under the active mesh, in one
    collective (``gather_many``); ``xs`` themselves without one."""
    mesh = current_mesh()
    if mesh is None:
        return list(xs)
    items = []
    for x in xs:
        full = tuple(x.shape[:-2]) + (n_kv, head_dim)
        spec = kv_spec(full, mesh)
        if local_shape(full, spec, mesh) != tuple(x.shape):
            raise ValueError(f"K/V of shape {tuple(x.shape)} is not the slice"
                             f" of {full} under {spec} on {mesh!r}")
        items.append((x, spec))
    return gather_many(items, mesh)


def kv_local(x: Tensor) -> Tensor:
    """This rank's slice of new full K/V ``x`` (a view), the part it writes
    into its cache; ``x`` itself without an active mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    for dim, entry in enumerate(kv_spec(x.shape, mesh)):
        names = _names(entry)
        if names:
            size = x.shape[dim] // int(np.prod([mesh.shape[n] for n in names]))
            x = x.narrow(dim, mesh.offset(names) * size, size)
    return x

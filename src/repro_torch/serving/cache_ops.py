"""Cache commit after speculative verification, per-slot batch surgery for
continuous batching, and the paged KV layout (PyTorch).

Counterpart of the JAX package's ``serving/cache_ops.py``.

Attention caches roll back by position invalidation: a slot holding a
position beyond the last accepted token is marked empty (-1), and the next
write reuses it. Recurrent caches (an SSM target's ``conv`` and ``state``,
a hybrid target's ``conv`` and ``h``, beside its attention caches)
roll back by snapshot selection: the verify returns the leaf after each
token of its block, and ``commit`` writes the one at the last accepted
token. They are per slot in both layouts (``paged_spec`` tags them
``NOT_PAGED``), so ``write_slot``, ``reset_slot`` and ``extract_slot``
carry them with the slot's other rows.

The port's decode state is batch-first everywhere: every per-slot leaf has
the batch on axis 0 (the ``"sampling"`` policy rows too, so admission
writes a request's policy and a freed slot's row reads zero, the blank
policy), the global counters (``iters``, ``row_iters``, ``committed``) are
0-dim, and a cache's ``ring`` flag is a Python bool. So
``write_slot`` / ``reset_slot`` need no inferred batch axes (the JAX
package diffs two abstract evaluations for them). Trees are matched by key,
and the functions that take a ``spec`` expect the state without its
``block_table``.

Paged (block) KV layout
-----------------------
``paged_state`` re-expresses every attention KV cache (a dict with
``k/v/positions/ring``, not a ring) as a pool of fixed-size position pages
shared by all slots, plus the state's ``block_table`` (B, max_len / page);
a local layer's ring stays per slot (B, W, ...):

    contiguous   k (B, max_len, KV, hd)    positions (B, max_len)
    paged        k (NP + 1, page, KV, hd)  positions (NP + 1, page)

Page ids come from a ``BlockAllocator`` over NP pages; the pool's last page
is the sink that takes writes to unallocated pages (``models/layers.py``).
The port's decode step reads and writes the pools through the table
(``models.transformer.cache_phase``, ``layers.paged_cache_update``) and
never builds a contiguous view; ``gather_state`` / ``scatter_state`` build
and write back that view, as the JAX engine's paged step does, for the
reference path of the tests.

Every operation here indexes batch, sequence or page dims only, never the
trailing (KV, hd) axes of a K/V leaf, so a storage-sharded engine's K/V
slices (``sharding.utils``) run through them as they are: a swap moves
each rank's slice of a slot's K/V.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.models import layers as L

Tensor = torch.Tensor

# recurrent cache leaves, rolled back by snapshot selection
_SNAP_LEAVES = ("state", "conv", "h")

# paged-spec leaf tags (a tree shaped like the decode state)
NOT_PAGED = 0          # per-slot or global leaf
PAGED_KV = 1           # k/v pool (NP + 1, page, KV, hd)
PAGED_POS = 2          # positions pool (NP + 1, page)


def map_tree(fn, tree, *rest, path=""):
    """fn(path, leaf, *matching leaves) over trees of dicts and lists,
    matched by key (not by order), rebuilt with fn's results."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), path=f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest), path=f"{path}/{i}")
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _spec_or_flat(tree, spec):
    return spec if spec is not None else map_tree(lambda *_: NOT_PAGED, tree)


def _is_kv(node) -> bool:
    return isinstance(node, dict) and {"k", "v", "positions", "ring"} <= set(node)


def has_ring_cache(cache_tree) -> bool:
    """Whether any attention KV cache in the tree is a ring (a local
    layer's sliding window shorter than max_len). A ring wraps on write
    (slot = position % W): a right-padded prefill could evict live prompt
    entries, so admission chunks instead, and a ring stays per slot where
    the other caches are paged."""
    if _is_kv(cache_tree):
        return bool(cache_tree["ring"])
    if isinstance(cache_tree, dict):
        return any(has_ring_cache(v) for v in cache_tree.values())
    if isinstance(cache_tree, list):
        return any(has_ring_cache(v) for v in cache_tree)
    return False


def commit(cache, commit_pos: Tensor,
           block_table: Optional[Tensor] = None, snapshots=None,
           accept_idx: Optional[Tensor] = None):
    """Roll ``cache`` (a tree of dicts and lists) back to the last
    accepted token, in place, and return it. Every ``positions`` leaf is
    invalidated beyond ``commit_pos`` (B,), the last valid absolute
    position of each row; with ``block_table`` the caches that are not
    rings are page pools and each row's own pages are invalidated (rings
    stay per slot). With ``snapshots`` (a recurrent target's verify: a tree
    shaped like the cache whose recurrent leaves carry the block's tokens
    on axis 1, ``ModelOutput.aux["snapshots"]``) each recurrent leaf takes
    its snapshot at ``accept_idx`` (B,), the index of the last committed
    token in the block; a row whose index is negative (a frozen or masked
    slot, which commits nothing) keeps its leaf."""
    if isinstance(cache, dict):
        per_row = block_table is None or bool(cache.get("ring", False))
        for name, leaf in cache.items():
            snap = snapshots.get(name) if isinstance(snapshots, dict) else None
            if name == "positions" and per_row:
                leaf.masked_fill_(leaf > commit_pos[:, None], -1)
            elif name == "positions":
                L.paged_invalidate(leaf, block_table, commit_pos)
            elif name in _SNAP_LEAVES and isinstance(snap, Tensor):
                _select_snapshot(leaf, snap, accept_idx)
            elif isinstance(leaf, (dict, list)):
                commit(leaf, commit_pos, block_table, snap, accept_idx)
    elif isinstance(cache, list):
        for i, sub in enumerate(cache):
            commit(sub, commit_pos, block_table,
                   None if snapshots is None else snapshots[i], accept_idx)
    return cache


def _select_snapshot(leaf: Tensor, snap: Tensor, accept_idx: Tensor) -> None:
    """leaf (B, ...) <- snap (B, T, ...) at token ``accept_idx`` (B,), in
    place; rows with a negative index keep their leaf."""
    rows = torch.arange(leaf.shape[0], device=leaf.device)
    sel = snap[rows, accept_idx.clamp(min=0).long()].to(leaf.dtype)
    keep = (accept_idx < 0).reshape((-1,) + (1,) * (leaf.dim() - 1))
    leaf.copy_(torch.where(keep, leaf, sel))


# ---------------------------------------------------------------------------
# per-slot batch surgery (continuous batching)
# ---------------------------------------------------------------------------

def _per_slot(leaf, tag) -> bool:
    return (isinstance(leaf, Tensor) and leaf.dim() > 0
            and tag == NOT_PAGED)


def write_slot(dst: dict, src: dict, slot: int, spec=None) -> dict:
    """Copy batch row 0 of ``src`` (a batch-1 state) into batch row
    ``slot`` of ``dst``, in place, for every per-slot leaf; global counters,
    ring flags and (with ``spec``) page pools keep their ``dst`` value.
    Returns ``dst``."""
    def w(_, d, s, tag):
        if _per_slot(d, tag):
            d[slot] = s[0].to(d.dtype)
    map_tree(w, dst, src, _spec_or_flat(dst, spec))
    return dst


def reset_slot(tree: dict, slot: int, spec=None,
               fills: Optional[Dict[str, int]] = None) -> dict:
    """Blank batch row ``slot`` in place: cache ``positions`` become -1,
    every other per-slot leaf 0; ``fills`` overrides the value by leaf name
    (the engine refreezes ``new_count`` at the budget). Global counters,
    ring flags and (with ``spec``) page pools are untouched."""
    fills = fills or {}

    def r(path, leaf, tag):
        if _per_slot(leaf, tag):
            name = path.rsplit("/", 1)[-1]
            leaf[slot] = fills.get(name, -1 if name == "positions" else 0)
    map_tree(r, tree, _spec_or_flat(tree, spec))
    return tree


# ---------------------------------------------------------------------------
# paged (block) KV layout
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Host-side refcounted free list over a fixed pool of KV pages.

    ``alloc(n)`` pops n page ids at refcount 1, or returns None (allocating
    nothing) when fewer than n are free, so admission can wait; ``free``
    drops one reference per page and returns a page to the free list at
    refcount zero; ``incref`` adds an owner. Freeing a page that is not
    allocated (a double free or a foreign id) raises: leaked or aliased
    pages corrupt neighbouring requests silently. LIFO: freshly freed pages
    are reused first."""

    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ValueError(f"need a positive pool, got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}      # page id -> reference count
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` page ids at refcount 1, or None when fewer are free. A
        recycled page may hold its previous owner's entries: every caller
        overwrites or blanks it (admission scatters a full view,
        ``Engine.ensure_capacity`` blanks growth pages)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.peak_used = max(self.peak_used, len(self._ref))
        return pages

    def incref(self, pages: List[int]) -> None:
        """Add one owner to each page; raises on a page not allocated."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"incref of page {p} not currently allocated")
        for p in pages:
            self._ref[p] += 1

    def refcount(self, page: int) -> int:
        """Current owner count of ``page`` (0 when free)."""
        return self._ref.get(page, 0)

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page (a page returns to the pool at zero);
        raises on a page not allocated, changing nothing."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"free of page {p} not currently allocated")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)

    def reset_stats(self) -> None:
        """Restart the ``peak_used`` high-water mark at current residency."""
        self.peak_used = self.n_used


class HostPagePool:
    """Byte-budgeted host store of swapped-out requests. Entries are opaque
    handles keyed by request id; the pool only keeps the byte account:
    ``put`` refuses (returns False) when the budget would overflow, which
    is the scheduler's signal to fall back to recompute-prefill preemption.
    ``capacity_bytes`` 0 is unbounded. ``peak_used`` / ``reset_stats`` as
    the ``BlockAllocator``'s."""

    def __init__(self, capacity_bytes: int = 0):
        if capacity_bytes < 0:
            raise ValueError(f"host_pool_bytes={capacity_bytes}")
        self.capacity = int(capacity_bytes)
        self._entries: Dict[object, tuple] = {}   # key -> (handle, nbytes)
        self.used_bytes = 0
        self.peak_used = 0

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def can_store(self, nbytes: int) -> bool:
        """Whether ``nbytes`` more would still fit the budget."""
        return self.capacity <= 0 or self.used_bytes + nbytes <= self.capacity

    def put(self, key, handle, nbytes: int) -> bool:
        """Store ``handle`` under ``key``; False (storing nothing) when the
        budget cannot hold it. A duplicate key raises: two live snapshots of
        one request would mean a lost or a double resume."""
        if key in self._entries:
            raise ValueError(f"swap handle for {key!r} already stored")
        nbytes = int(nbytes)
        if not self.can_store(nbytes):
            return False
        self._entries[key] = (handle, nbytes)
        self.used_bytes += nbytes
        self.peak_used = max(self.peak_used, self.used_bytes)
        return True

    def get(self, key):
        """The stored handle, or None."""
        ent = self._entries.get(key)
        return None if ent is None else ent[0]

    def pop(self, key):
        """Remove and return the handle, releasing its bytes; a missing key
        raises."""
        if key not in self._entries:
            raise KeyError(f"no swap handle for {key!r}")
        handle, nbytes = self._entries.pop(key)
        self.used_bytes -= nbytes
        return handle

    def reset_stats(self) -> None:
        """Restart the ``peak_used`` high-water mark at current usage."""
        self.peak_used = self.used_bytes


def paged_spec(tree):
    """A tree shaped like ``tree`` (a decode state or cache, either layout)
    tagging each leaf: PAGED_KV / PAGED_POS for the leaves of attention KV
    caches that are not rings, NOT_PAGED otherwise (a ring stays per slot:
    its batch-first rows are written, reset and swapped like any per-slot
    leaf)."""
    def walk(node):
        if isinstance(node, dict):
            if _is_kv(node) and not node["ring"]:
                return {k: (PAGED_KV if k in ("k", "v") else
                            PAGED_POS if k == "positions" else NOT_PAGED)
                        for k in node}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return NOT_PAGED
    return walk(tree)


def paged_pool(leaf: Tensor, tag: int, page: int, n_pages: int) -> Tensor:
    """The pool of one contiguous cache leaf (B, W, ...): (n_pages + 1,
    page, ...), the last page being the sink; positions -1, K/V 0. A K/V
    leaf's trailing axes are kept, so the pool of a K/V slice (a sharded
    engine's) is a slice too."""
    fill = -1 if tag == PAGED_POS else 0
    return torch.full((n_pages + 1, page) + tuple(leaf.shape[2:]), fill,
                      dtype=leaf.dtype, device=leaf.device)


def paged_state(state: dict, spec, page: int, n_pages: int) -> dict:
    """``state`` with every paged leaf replaced by its pool (other leaves
    are the same objects)."""
    return map_tree(lambda _, leaf, tag: leaf if tag == NOT_PAGED
                else paged_pool(leaf, tag, page, n_pages), state, spec)


def _sink_index(table: Tensor, pool: Tensor) -> Tensor:
    """Table entries as pool page indices, -1 entries sent to the sink."""
    return torch.where(table < 0, pool.shape[0] - 1, table).long()


def gather_pages(pool: Tensor, table: Tensor, tag: int) -> Tensor:
    """pool (NP + 1, page, ...) + table (B, nb) -> contiguous view (B, nb *
    page, ...). Unallocated entries (-1) read page 0 with positions -1."""
    return L.paged_view(pool, table, empty=-1 if tag == PAGED_POS else None)


def scatter_pages(pool: Tensor, view: Tensor, table: Tensor) -> Tensor:
    """Inverse of ``gather_pages``, in place: write the view back through
    the table; blocks of unallocated entries (-1) go to the sink page
    (dropped). Returns ``pool``."""
    B, nb = table.shape
    page = pool.shape[1]
    blocks = view.reshape((B * nb, page) + tuple(pool.shape[2:]))
    pool[_sink_index(table, pool).flatten()] = blocks.to(pool.dtype)
    return pool


def gather_state(pstate: dict, table: Tensor, spec) -> dict:
    """Paged state -> contiguous per-slot view (other leaves pass through)."""
    return map_tree(lambda _, leaf, tag: leaf if tag == NOT_PAGED
                else gather_pages(leaf, table, tag), pstate, spec)


def scatter_state(pstate: dict, view_state: dict, table: Tensor,
                  spec) -> dict:
    """Contiguous view -> paged state: paged leaves scatter into the pools
    of ``pstate`` (in place); every other leaf takes the view's value."""
    return map_tree(lambda _, pool, view, tag: view if tag == NOT_PAGED
                else scatter_pages(pool, view, table), pstate, view_state, spec)


def blank_pages(pstate: dict, table_row: Tensor, spec) -> dict:
    """Mark every position of the pages in ``table_row`` (nb,) empty (-1),
    in place; -1 entries are dropped. A recycled page must read empty when
    it is acquired: incremental growth maps it into a row without the full
    overwrite an admission does. K/V bytes stay; empty positions mask them."""
    def blank(_, pool, tag):
        if tag == PAGED_POS:
            pool[_sink_index(table_row, pool)] = -1
        return pool
    return map_tree(blank, pstate, spec)


def copy_page(pstate: dict, src: int, dst: int, spec) -> dict:
    """Copy pool page ``src`` to page ``dst``, K/V and positions alike, in
    every paged leaf, in place: the copy-on-write step of the prefix cache
    (a cached page whose last drafter entry a new request must amend is
    duplicated into a page the request owns; the original stays
    byte-stable for its other owners). Neither page may be the sink."""
    def cp(_, pool, tag):
        if tag != NOT_PAGED:
            sink = pool.shape[0] - 1
            if not (0 <= src < sink and 0 <= dst < sink):
                raise ValueError(f"copy_page({src} -> {dst}) outside pages "
                                 f"0..{sink - 1} (page {sink} is the sink)")
            pool[dst] = pool[src]
        return pool
    return map_tree(cp, pstate, spec)


def admit_pages(pstate: dict, src: dict, slot: int, table_row: Tensor,
                spec, scatter_row: Optional[Tensor] = None) -> dict:
    """Admit a batch-1 contiguous state ``src`` into slot ``slot`` of a
    paged state, in place: per-slot leaves via ``write_slot``, paged leaves
    by scattering src row 0 into the pages of ``table_row`` (nb,), whose
    -1 entries are dropped. ``scatter_row`` (default ``table_row``) picks
    which pages receive the view: a prefix-cache hit masks its shared pages
    to -1, so admission never writes a page another owner maps.
    ``block_table`` itself is left to the caller."""
    write_slot(pstate, src, slot, spec)
    row = table_row if scatter_row is None else scatter_row

    def admit(_, pool, s, tag):
        if tag != NOT_PAGED:
            scatter_pages(pool, s[:1], row[None])
    map_tree(admit, pstate, src, spec)
    return pstate


def view_width_axis(ndim: int, tag: int) -> int:
    """The W (position within the slot) axis of a contiguous view leaf of
    ``ndim`` dims: page ``i`` of a row spans ``[i * page, (i + 1) * page)``
    along it. The port's views are batch-first, so it is axis 1 for K/V
    (B, W, KV, hd) and positions (B, W) alike."""
    if tag == NOT_PAGED or ndim < 2:
        raise ValueError(f"a leaf of tag {tag}, {ndim} dims, has no W axis")
    return 1


def extract_slot(pstate: dict, slot: int, table_row: Tensor, spec) -> dict:
    """Inverse of ``admit_pages``: batch row ``slot`` of a paged state as a
    batch-1 contiguous state. Per-slot leaves slice their row; paged leaves
    gather the pages of ``table_row`` (nb,) end to end (a -1 entry reads
    empty positions); global counters and ring flags pass through. The
    result aliases nothing: swap-out copies it to the host, and
    ``admit_pages`` with the same (or freshly allocated) pages restores it
    bitwise."""
    def ex(_, leaf, tag):
        if tag != NOT_PAGED:
            return gather_pages(leaf, table_row[None], tag)
        if isinstance(leaf, Tensor) and leaf.dim() > 0:
            return leaf[slot:slot + 1].clone()
        return leaf
    return map_tree(ex, pstate, spec)

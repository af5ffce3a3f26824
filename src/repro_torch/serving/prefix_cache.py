"""Cross-request prefix caching over the paged KV pool (hash-consed pages).

Counterpart of the JAX package's ``serving/prefix_cache.py``; host-only
Python and numpy, so the port keeps its own copy of the same index.

At serving scale most traffic shares a system prompt or few-shot preamble.
The paged layout makes the KV of every ``page_size``-position span a pool
page, and pages are positions-exact: the page at block-table index ``m``
holds absolute positions ``[m*ps, (m+1)*ps)``, and its content (target K/V
and the drafter's fused (tap, embedding) entries) is a pure function of the
token stream. So full pages can be hash-consed: :class:`PrefixCache` keys
each page by its token-prefix chain, and admission of a request whose
prompt walks the same chain maps the cached pages into its block-table row
(``Engine.prefill_into_slot``), prefilling only the uncached suffix.

Key scheme (why the lookahead token is part of the key)
-------------------------------------------------------
Target KV at position ``p`` depends on tokens ``0..p``. The drafter cache
entry at ``p`` fuses ``(tap[p], embedding(token[p+1]))``, so the page
covering ``[m*ps, (m+1)*ps)`` depends on tokens ``0..(m+1)*ps`` inclusive:
the page's own tokens plus one lookahead token. Hence two keys per page:

  partial key   h_{m+1}            = H(h_m || page_tokens)   (chain)
  full key      H(h_{m+1} || lookahead_token)

A page is shareable as-is only through its full key. A partial match (same
chain, another or no lookahead) still holds valid target KV for all ``ps``
positions and valid drafter entries for all but the last, so it serves as a
copy-on-write source: the engine copies it into a fresh page the new
request owns (``cache_ops.copy_page``) and recomputes the final position,
leaving the shared original byte-stable for its owners.

Sharing, refcounts, eviction
----------------------------
The cache holds its own reference on every indexed page
(``BlockAllocator.incref``), so cached pages survive ``free_slot``: a
request's prefix stays warm after it finishes, and a preempted request's
resume can hit the pages its eviction left behind. Pages are inserted after
admission (the verifiable prompt prefix) and at ``free_slot`` (the
committed stream), deduplicated by full key. Under pool pressure the engine
evicts least-recently-used cache-only pages (refcount 1); pages a live slot
still maps (refcount > 1) are pinned and skipped. Everything here is
host-side bookkeeping, page ids and hashes: device pools are never touched
by this module.

Every page the index shares holds positions below each sharer's first
write: a page is inserted only when its stream holds its lookahead token,
and a sharer's decode starts past that token. The port's paged step relies
on it (``Engine._check_shared_pages``).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_ROOT = b"prefix-cache-root"


def _h(*parts: bytes) -> bytes:
    d = hashlib.blake2b(digest_size=16)
    for p in parts:
        d.update(p)
    return d.digest()


@dataclass
class _Entry:
    full_key: bytes      # H(chain || lookahead) — shareable identity
    partial_key: bytes   # chain hash — CoW-source identity
    page: int            # pool page id (cache holds one allocator ref)


class PrefixCache:
    """Host-side index: token-prefix chain -> pool page id.

    One instance per ``Engine`` (the engine IS
    the model axis of the (token-prefix, model) key — pages from different
    models never share a pool). All methods take token streams as 1-D
    int32 arrays and return plain page ids; the engine owns every device
    interaction and all refcount transitions except the cache's own
    insert-ref/evict-deref pair."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"need a positive page_size, got {page_size}")
        self.page_size = page_size
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()  # LRU
        self._partial: Dict[bytes, "OrderedDict[bytes, None]"] = {}
        self.stats = {"admissions": 0, "hits": 0, "misses": 0,
                      "hit_tokens": 0, "cow_hits": 0, "inserts": 0,
                      "evictions": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def pages(self) -> List[int]:
        """Page ids currently indexed (one allocator ref each)."""
        return [e.page for e in self._entries.values()]

    # ------------------------------------------------------------------
    def _page_bytes(self, toks: np.ndarray, m: int) -> bytes:
        ps = self.page_size
        return toks[m * ps:(m + 1) * ps].tobytes()

    def _walk(self, toks: np.ndarray, touch: bool):
        """Longest full-key chain walk. Returns ``(shared_page_ids, h_m)``
        where ``h_m`` is the chain hash *before* the first unmatched page
        (ready for the CoW probe). ``touch`` refreshes LRU order."""
        ps = self.page_size
        P = toks.size
        m_max = (P - 1) // ps     # pages whose lookahead the stream contains
        shared: List[int] = []
        h = _ROOT
        for m in range(m_max):
            h2 = _h(h, self._page_bytes(toks, m))
            fk = _h(h2, toks[(m + 1) * ps].tobytes())
            e = self._entries.get(fk)
            if e is None:
                break
            if touch:
                self._entries.move_to_end(fk)
            shared.append(e.page)
            h = h2
        return shared, h

    def _match(self, tokens, touch: bool):
        toks = np.asarray(tokens, np.int32).reshape(-1)
        shared, h = self._walk(toks, touch)
        cow = None
        m = len(shared)
        if (m + 1) * self.page_size <= toks.size:
            bucket = self._partial.get(_h(h, self._page_bytes(toks, m)))
            if bucket:
                cow = self._entries[next(reversed(bucket))].page
        return shared, cow

    def match(self, tokens) -> Tuple[List[int], Optional[int]]:
        """Longest cached prefix of ``tokens``: ``(shared_pages, cow_src)``.

        ``shared_pages`` are full-key hits, mappable as-is (the caller must
        ``incref`` them before any allocation that could evict). ``cow_src``
        — when the page after the shared run has a partial-chain match whose
        ``page_size`` tokens the stream fully contains — is a page to
        copy-on-write: valid except its last drafter entry. Matched entries
        are LRU-refreshed; the CoW source is not (a copy is not reuse)."""
        return self._match(tokens, touch=True)

    def probe(self, tokens) -> Tuple[List[int], Optional[int]]:
        """Read-only :meth:`match` — same result, but never touches LRU
        order. For admission gating (``Engine.can_admit``): probing
        admissibility is not reuse, and the gate needs the page ids to know
        which evictable pages a real admission would pin."""
        return self._match(tokens, touch=False)

    def match_len(self, tokens) -> int:
        """Read-only full-key hit count in pages (the post-hit page need is
        ``initial_pages - match_len``)."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        return len(self._walk(toks, touch=False)[0])

    # ------------------------------------------------------------------
    def insert_stream(self, tokens, pages: List[int], allocator) -> int:
        """Index every *verifiable* full page of ``tokens``: page ``m`` is
        insertable iff the stream contains its lookahead token —
        ``(m+1)*page_size + 1 <= len(tokens)`` — which also guarantees the
        owning slot never writes it again (decode writes start past the
        prompt; committed entries are append-only). ``pages`` is the
        owning slot's page list; each newly indexed page gains one
        allocator ref. Full-key duplicates are LRU-refreshed, not
        re-inserted (first physical page wins). Returns pages inserted."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        n = min((toks.size - 1) // ps, len(pages))
        h = _ROOT
        inserted = 0
        for m in range(n):
            h = _h(h, self._page_bytes(toks, m))
            fk = _h(h, toks[(m + 1) * ps].tobytes())
            if fk in self._entries:
                self._entries.move_to_end(fk)
                continue
            allocator.incref([pages[m]])
            self._entries[fk] = _Entry(fk, h, pages[m])
            self._partial.setdefault(h, OrderedDict())[fk] = None
            inserted += 1
        self.stats["inserts"] += inserted
        return inserted

    # ------------------------------------------------------------------
    def _drop(self, fk: bytes) -> _Entry:
        e = self._entries.pop(fk)
        bucket = self._partial.get(e.partial_key)
        if bucket is not None:
            bucket.pop(fk, None)
            if not bucket:
                del self._partial[e.partial_key]
        return e

    def evictable(self, allocator, exclude=()) -> int:
        """Pages reclaimable right now: cache-only (allocator refcount 1).
        Pages a live slot still maps are pinned. ``exclude`` — page ids to
        leave out of the count (an admission gate passes the pages its own
        hit would pin, which therefore can't be evicted to fund it)."""
        skip = set(exclude)
        return sum(1 for e in self._entries.values()
                   if allocator.refcount(e.page) == 1
                   and e.page not in skip)

    def evict(self, need: int, allocator) -> int:
        """Free up to ``need`` cache-only pages, least-recently-used first;
        pinned pages (refcount > 1) are skipped, not stalled on. Returns
        pages actually freed to the pool."""
        freed = 0
        if need <= 0:
            return 0
        for fk in list(self._entries):         # oldest -> newest
            e = self._entries[fk]
            if allocator.refcount(e.page) != 1:
                continue
            self._drop(fk)
            allocator.free([e.page])
            freed += 1
            self.stats["evictions"] += 1
            if freed >= need:
                break
        return freed

    def flush(self, allocator) -> int:
        """Drop every entry (cache refs released; pages shared with live
        slots survive at their remaining count). Test/drain hook."""
        n = 0
        for fk in list(self._entries):
            e = self._drop(fk)
            allocator.free([e.page])
            n += 1
        return n

    # ------------------------------------------------------------------
    def note_admission(self, hit_tokens: int, cow: bool) -> None:
        """Record one admission's outcome (engine calls this whether or not
        the prompt hit)."""
        self.stats["admissions"] += 1
        if hit_tokens > 0:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += hit_tokens
        else:
            self.stats["misses"] += 1
        if cow:
            self.stats["cow_hits"] += 1

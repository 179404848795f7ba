"""Free-list page pool and copy-on-write prefix cache: host bookkeeping
of who owns which KV page.

The port's own copy of ``PagePool``, ``PartialHit``, ``_Entry`` and
``PrefixCache`` from ``paddle_tpu/models/kv_pool.py`` (:41-263). The
device arrays are a flat pool of pages; the serving engine grants pages
to a slot at admission, appends pages as decode crosses page boundaries,
and returns them at retirement. A page shared by several mappings carries
one reference per mapping.

The prefix cache keys each FULL prompt page by the chained hash of every
token up to and including it, so a lookup walks the chain page by page
and a hit maps the already-computed KV page read-only instead of
prefilling it again. Entries verify their tokens on a match (a hash
collision never maps foreign KV), hold one pool reference each (so shared
pages outlive their first owner), and are evicted LRU, leaves first, so
that the surviving chains stay walkable. Copy-on-write lives in the
engine: a match that ends mid-page maps the covering page's content into
a fresh private page by one device page copy.
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["PagePool", "PrefixCache", "PartialHit"]


class PagePool:
    """Refcounted free-list allocator over ``n_pages`` physical page ids.

    ``alloc(n)`` pops n pages (refcount 1 each) or returns ``None`` when
    the free list is short, and the caller decides what to do. ``decref``
    returns the page ids whose last reference dropped WITHOUT putting them
    back on the free list; the caller recycles them when it is safe
    (``recycle``).
    """

    __slots__ = ("n_pages", "_free", "_refs")

    def __init__(self, n_pages):
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages - 1, -1, -1))  # LIFO: pop()
        self._refs = np.zeros((self.n_pages,), np.int32)

    def available(self) -> int:
        return len(self._free)

    def allocated(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n) -> list | None:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, page):
        self._refs[page] += 1

    def decref(self, pages) -> list:
        """Drop one reference per page id; returns the ids that hit zero
        (not recycled)."""
        dead = []
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] <= 0:
                self._refs[p] = 0
                dead.append(p)
        return dead

    def recycle(self, pages):
        """Return zero-ref pages to the free list."""
        self._free.extend(pages)

    def refcount(self, page) -> int:
        return int(self._refs[page])


class PartialHit:
    """A cached page whose first ``r`` tokens match the tail of a lookup
    prompt (the match diverges mid-page): the engine may map its content
    through a copy-on-write page copy and skip recomputing those tokens."""

    __slots__ = ("page", "r")

    def __init__(self, page, r):
        self.page = int(page)
        self.r = int(r)


class _Entry:
    __slots__ = ("page", "tokens", "key", "parent", "children",
                 "last_used")

    def __init__(self, page, tokens, key, parent):
        self.page = int(page)
        self.tokens = tokens            # np.int32 copy, page_size long
        self.key = key
        self.parent = parent            # parent chain key (b"" at root)
        self.children: set = set()
        self.last_used = 0


class PrefixCache:
    """Chained page-granular prompt-prefix cache (see the module
    docstring). It never touches device memory: entries record the ids of
    pages whose KV a completed prefill wrote. Every pool reference it
    takes is released through ``recycle_cb``."""

    def __init__(self, pool: PagePool, page_size, recycle_cb):
        self.pool = pool
        self.page_size = int(page_size)
        self._recycle_cb = recycle_cb
        self._entries: dict = {}          # chain key -> _Entry
        self._roots: set = set()          # chain keys with parent b""
        self._clock = 0

    def __len__(self):
        return len(self._entries)

    @staticmethod
    def _chain(parent_key, tokens) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(parent_key)
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _children_of(self, parent_key):
        if parent_key == b"":
            return self._roots
        e = self._entries.get(parent_key)
        return e.children if e is not None else ()

    def match(self, prompt):
        """Longest cached prefix of ``prompt``: ``(pages, matched_tokens,
        partial)``, where ``pages`` are the matched FULL pages in order,
        ``matched_tokens == len(pages) * page_size``, and ``partial`` is
        a :class:`PartialHit` for the next page when a cached child's head
        matches part of the remaining tail (else None). Tokens are
        verified at every hop."""
        page = self.page_size
        prompt = np.ascontiguousarray(prompt, np.int32)
        pages, parent = [], b""
        for i in range(prompt.size // page):
            tok = prompt[i * page:(i + 1) * page]
            key = self._chain(parent, tok)
            e = self._entries.get(key)
            if e is None or not np.array_equal(e.tokens, tok):
                break
            e.last_used = self._tick()
            pages.append(e.page)
            parent = key
        matched = len(pages) * page
        # a mid-page divergence: the cached child sharing the longest head
        # with the remaining tail is copy-on-write material
        partial, rem = None, prompt[matched:]
        if rem.size:
            best_r = 0
            for ck in self._children_of(parent):
                e = self._entries.get(ck)
                if e is None:
                    continue
                n = min(rem.size, e.tokens.size)
                neq = np.nonzero(e.tokens[:n] != rem[:n])[0]
                r = int(neq[0]) if neq.size else n
                if r > best_r:
                    best_r, partial = r, PartialHit(e.page, r)
                    e.last_used = self._tick()
        return pages, matched, partial

    def insert(self, prompt, slot_pages):
        """Register the FULL pages of a completed prefill: page ``i`` of
        ``slot_pages`` holds the KV of tokens ``[i*page, (i+1)*page)``.
        An existing key keeps its page (the first writer wins); a new
        entry takes one pool reference."""
        page = self.page_size
        prompt = np.ascontiguousarray(prompt, np.int32)
        parent = b""
        for i in range(prompt.size // page):
            tok = prompt[i * page:(i + 1) * page]
            key = self._chain(parent, tok)
            e = self._entries.get(key)
            if e is None:
                e = _Entry(slot_pages[i], tok.copy(), key, parent)
                e.last_used = self._tick()
                self.pool.incref(e.page)
                self._entries[key] = e
                if parent == b"":
                    self._roots.add(key)
                else:
                    pe = self._entries.get(parent)
                    if pe is not None:
                        pe.children.add(key)
            else:
                e.last_used = self._tick()
            parent = key

    def evict(self, need_pages, exclude=()) -> int:
        """Release cache references until ``need_pages`` pages have
        returned to the pool, or no evictable entry is left: LRU over
        leaf entries whose page the cache alone holds (evicting a page a
        slot still maps frees nothing). ``exclude`` protects the pages an
        admission plan is about to map. Returns the pages recycled."""
        freed = 0
        exclude = set(exclude)
        while freed < need_pages:
            leaf, lru = None, None
            for e in self._entries.values():
                if (e.children or e.page in exclude
                        or self.pool.refcount(e.page) > 1):
                    continue
                if lru is None or e.last_used < lru:
                    leaf, lru = e, e.last_used
            if leaf is None:
                break
            self._entries.pop(leaf.key, None)
            if leaf.parent == b"":
                self._roots.discard(leaf.key)
            else:
                pe = self._entries.get(leaf.parent)
                if pe is not None:
                    pe.children.discard(leaf.key)
            dead = self.pool.decref([leaf.page])
            if dead:
                self._recycle_cb(dead)
                freed += len(dead)
        return freed

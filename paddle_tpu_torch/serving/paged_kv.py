"""Paged KV cache: block-pool allocator + prefix trie (port of
``paddle_tpu/serving/paged_kv.py``).

- one ``[num_pages, page_len, heads, dim]`` arena per layer
  (``PagedKVPool``) on the engine's device — the only device memory the KV
  cache holds;
- a free-list allocator (``PageAllocator``) hands out ref-counted pages; a
  request's KV is a page table, and ``cow()`` gives a writer its own copy
  of a shared page;
- a prefix cache (``PrefixCache``), a hash-trie keyed by ``(parent,
  token-block)`` chains, maps full prompt blocks to the pages already
  holding their K/V; eviction is LRU over leaves nobody else holds.

The allocator and the trie are pure Python, copied from the JAX package.
Page 0 is the scratch page: page-table rows of inactive slots (and
positions beyond a request's allocation) point at it, so the fixed-shape
window step always has somewhere harmless to write. The warm host tier and
page export/install wait for a later slice.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

__all__ = ["PoolExhausted", "PageAllocator", "PrefixCache", "PagedKVPool",
           "token_blocks"]


class PoolExhausted(RuntimeError):
    """The page pool cannot serve the allocation (even after eviction)."""


def token_blocks(tokens, page_len: int, limit: Optional[int] = None
                 ) -> List[Tuple[int, ...]]:
    """The FULL ``page_len``-sized token blocks of a prompt — the trie's
    key units. A trailing partial block is never a key (it would receive
    decode writes)."""
    n = len(tokens) // page_len
    if limit is not None:
        n = min(n, limit)
    return [tuple(int(t) for t in tokens[i * page_len:(i + 1) * page_len])
            for i in range(n)]


class PageAllocator:
    """Free-list page allocator with ref counts (pure control plane).

    Invariants (asserted by ``check()``):
    - page 0 is reserved (never allocated, refcount pinned);
    - every page is either on the free list (ref 0) or live (ref >= 1);
    - ``free_pages + live_pages == num_pages - 1``.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 scratch + 1 usable), "
                             f"got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(1, num_pages))
        self._ref = [0] * num_pages
        self._ref[0] = 1  # scratch page: pinned forever
        self.alloc_total = 0
        self.free_total = 0
        self.cow_total = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def usable_pages(self) -> int:
        """Pages a single request could ever hold (pool minus scratch)."""
        return self.num_pages - 1

    def ref(self, page: int) -> int:
        return self._ref[page]

    def alloc(self, n: int) -> List[int]:
        """n fresh pages at refcount 1, or ``PoolExhausted`` (all-or-
        nothing: a partial grab is never held across the raise)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({self.live_pages} live) of {self.usable_pages} usable "
                f"[pool={self.num_pages} incl. scratch, "
                f"alloc_total={self.alloc_total}, "
                f"free_total={self.free_total}]")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.alloc_total += n
        return pages

    def retain(self, page: int) -> None:
        if page == 0:
            return  # scratch is pinned; sharing it is a no-op
        if self._ref[page] <= 0:
            raise RuntimeError(f"retain of free page {page}")
        self._ref[page] += 1

    def release(self, page: int) -> None:
        if page == 0:
            return
        r = self._ref[page]
        if r <= 0:
            raise RuntimeError(f"double free of page {page}")
        self._ref[page] = r - 1
        if r == 1:
            self._free.append(page)
            self.free_total += 1

    def cow(self, page: int) -> Tuple[int, bool]:
        """Copy-on-write: the caller wants to WRITE ``page``. Exclusive
        pages (ref 1) are returned as-is; shared pages cost one fresh page
        (caller must copy the contents) and drop the shared ref. Returns
        ``(writable_page, copied)``."""
        if page != 0 and self._ref[page] == 1:
            return page, False
        new = self.alloc(1)[0]
        self.release(page)
        self.cow_total += 1
        return new, True

    def check(self) -> None:
        """Assert the allocator invariants (test hook)."""
        assert self._ref[0] >= 1, "scratch page unpinned"
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page on free list"
        assert 0 not in free, "scratch page on free list"
        for p in range(1, self.num_pages):
            if p in free:
                assert self._ref[p] == 0, (p, self._ref[p])
            else:
                assert self._ref[p] >= 1, (p, self._ref[p])
        assert self.free_pages + self.live_pages == self.num_pages - 1


class _TrieNode:
    __slots__ = ("key", "parent", "page", "children", "last_used")

    def __init__(self, key, parent, page, last_used):
        self.key = key
        self.parent = parent      # parent key (None for depth-0 blocks)
        self.page = page
        self.children = 0         # live child count (eviction is leaf-only)
        self.last_used = last_used


class PrefixCache:
    """Hash-trie over token-block chains -> KV pages.

    A node's key is ``(parent_key, block_tokens)`` — the full token
    context is encoded in the chain, so equal blocks under different
    prefixes never collide. The trie holds ONE allocator ref per adopted
    page; ``evict()`` walks least-recently-used *leaves* whose page has no
    other holder, so eviction can never free a page out from under a
    reader or orphan a reachable child.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[Any, _TrieNode] = {}
        self._tick = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserts = 0
        self.evictions = 0

    def match(self, blocks: Sequence[Tuple[int, ...]], page_len: int,
              allocator: Optional[PageAllocator] = None) -> List[int]:
        """Longest cached chain for ``blocks``; returns its pages. When an
        allocator is given each returned page is retained FOR THE CALLER
        (released by the caller when its request finishes)."""
        with self._lock:
            self._tick += 1
            self.lookups += 1
            self.lookup_tokens += len(blocks) * page_len
            pages: List[int] = []
            parent = None
            for block in blocks:
                node = self._nodes.get((parent, block))
                if node is None:
                    break
                node.last_used = self._tick
                pages.append(node.page)
                parent = node.key
            if pages:
                self.hits += 1
                self.hit_tokens += len(pages) * page_len
            if allocator is not None:
                for p in pages:
                    allocator.retain(p)
            return pages

    def match_len(self, blocks: Sequence[Tuple[int, ...]]) -> int:
        """Depth of the longest cached chain (no refs taken, no LRU
        bump)."""
        with self._lock:
            depth, parent = 0, None
            for block in blocks:
                node = self._nodes.get((parent, block))
                if node is None:
                    break
                depth += 1
                parent = node.key
            return depth

    def insert(self, blocks: Sequence[Tuple[int, ...]], pages: Sequence[int],
               allocator: PageAllocator) -> int:
        """Adopt ``pages[i]`` as the cached KV of chain ``blocks[:i+1]``.
        Existing nodes keep their page (first writer wins — both copies
        hold identical K/V); new nodes retain theirs. Returns the number
        of newly adopted pages."""
        if len(blocks) != len(pages):
            raise ValueError(f"{len(blocks)} blocks != {len(pages)} pages")
        adopted = 0
        with self._lock:
            self._tick += 1
            parent = None
            for block, page in zip(blocks, pages):
                key = (parent, block)
                node = self._nodes.get(key)
                if node is None:
                    node = _TrieNode(key, parent, page, self._tick)
                    self._nodes[key] = node
                    allocator.retain(page)
                    if parent is not None:
                        self._nodes[parent].children += 1
                    self.inserts += 1
                    adopted += 1
                else:
                    node.last_used = self._tick
                parent = key
        return adopted

    def evict(self, n_pages: int, allocator: PageAllocator) -> int:
        """Free up to ``n_pages`` pages by dropping LRU leaves whose page
        has no holder besides the trie (ref == 1). Returns pages freed."""
        freed = 0
        with self._lock:
            while freed < n_pages:
                victim = None
                for node in self._nodes.values():
                    if node.children:
                        continue
                    if allocator.ref(node.page) != 1:
                        continue  # someone is reading it right now
                    if victim is None or node.last_used < victim.last_used:
                        victim = node
                if victim is None:
                    break
                del self._nodes[victim.key]
                if victim.parent is not None:
                    self._nodes[victim.parent].children -= 1
                allocator.release(victim.page)
                self.evictions += 1
                freed += 1
        return freed

    def evictable(self, allocator: PageAllocator) -> int:
        """Pages only the trie holds: leaf-only eviction frees parents as
        it goes, so every one of them is ultimately reachable."""
        with self._lock:
            return sum(1 for node in self._nodes.values()
                       if allocator.ref(node.page) == 1)

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"nodes": len(self._nodes), "lookups": self.lookups,
                    "hits": self.hits, "hit_tokens": self.hit_tokens,
                    "lookup_tokens": self.lookup_tokens,
                    "inserts": self.inserts, "evictions": self.evictions,
                    "hit_rate": round(self.hit_tokens /
                                      max(self.lookup_tokens, 1), 4)}


class PagedKVPool:
    """The device half: per-layer K/V page arenas + the control plane.

    ``allocate(n)`` serves from the free list, evicting LRU prefix-cache
    entries when short. The arenas are ordinary tensors that the window
    step updates in place.
    """

    def __init__(self, num_layers: int, num_pages: int, page_len: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 prefix_cache: bool = True, device=None):
        dev = resolve_device(device)
        self.page_len = int(page_len)
        self.num_pages = int(num_pages)
        self.allocator = PageAllocator(num_pages)
        self.trie: Optional[PrefixCache] = PrefixCache() if prefix_cache \
            else None
        shape = (num_pages, page_len, num_heads, head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(num_layers)]

    def allocate(self, n: int) -> List[int]:
        """n pages, evicting cached prefixes if the free list is short."""
        short = n - self.allocator.free_pages
        if short > 0 and self.trie is not None:
            self.trie.evict(short, self.allocator)
        return self.allocator.alloc(n)

    def can_allocate(self, n: int) -> bool:
        free = self.allocator.free_pages
        if n <= free:
            return True
        if self.trie is None:
            return False
        return n <= free + self.trie.evictable(self.allocator)

    def ensure_writable(self, page: int) -> Tuple[int, bool]:
        """COW hook: give the caller a page it may write. When the page is
        shared, a fresh page is allocated and the K/V content is copied on
        the device before returning."""
        new, copied = self.allocator.cow(page)
        if copied:
            self._copy_page(page, new)
        return new, copied

    def _copy_page(self, src: int, dst: int) -> None:
        for a in self.k + self.v:
            a[dst].copy_(a[src])

    def bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.k + self.v)

    def stats(self) -> Dict[str, Any]:
        a = self.allocator
        out = {"pages_total": a.num_pages, "page_len": self.page_len,
               "pages_free": a.free_pages, "pages_live": a.live_pages,
               "pool_bytes": self.bytes(),
               "alloc_total": a.alloc_total, "cow_total": a.cow_total,
               "headroom": round(a.free_pages / max(a.usable_pages, 1), 4)}
        if self.trie is not None:
            out["prefix"] = self.trie.stats()
        return out

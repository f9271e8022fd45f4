"""Host-side paged KV cache management: allocator + prefix cache.

A copy of the JAX package's serve/llm/cache.py (which imports no JAX):
this package imports nothing of ray_tpu. The reference delegates this
to vLLM's BlockSpaceManager/prefix pool (no in-repo implementation; ref: llm/_internal/serve/deployments/llm/vllm/
vllm_engine.py wraps the external engine). Design here follows the same
contract: fixed pool of pages, per-sequence block tables, refcounted
sharing of FULL pages keyed by a rolling content hash, LRU eviction of
unreferenced cached pages. Only full pages are ever shared, so a sequence's
writable tail page is always exclusively owned.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


class OutOfPages(Exception):
    pass


class PageAllocator:
    """Page 0 is reserved as the dummy page (padding block-table slots).

    Page 0 is also where paged_write sends the writes of padding rows,
    so no sequence ever reads it. `shard_degree` only labels the byte
    accounting (surfaced in stats); this package serves on one device.
    """

    def __init__(self, num_pages: int, page_size: int,
                 shard_degree: int = 1):
        assert num_pages >= 2
        self.num_pages = num_pages
        self.page_size = page_size
        self.shard_degree = max(1, int(shard_degree))
        self._free: List[int] = list(range(1, num_pages))
        self._refcount: Dict[int, int] = {}
        # prefix cache: chain_hash -> page id; pages with refcount 0 that
        # remain cached sit in _evictable (LRU order) until reused/evicted
        self._hash_to_page: Dict[int, int] = {}
        self._page_to_hash: Dict[int, int] = {}
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # bumped whenever the set of cached hashes changes, so frontier
        # publishers (the cluster prefix registry) can skip unchanged
        # snapshots
        self._rev = 0
        self.stats = {"allocated": 0, "cache_hits": 0, "evictions": 0,
                      "prefix_token_lookups": 0, "prefix_token_hits": 0,
                      "shard_degree": self.shard_degree}

    # ------------------------------------------------------------ queries

    def num_free(self) -> int:
        return len(self._free) + len(self._evictable)

    @staticmethod
    def chain_hash(prev_hash: Optional[int],
                   tokens: Sequence[int]) -> int:
        """Content-chained page hash, stable ACROSS processes (blake2b,
        not the salted builtin hash): the cluster prefix registry matches
        router-computed hashes against replica-published frontiers, so
        every process must agree on the value for the same content."""
        h = hashlib.blake2b(digest_size=8)
        if prev_hash is None:
            h.update(b"\x00")
        else:
            h.update(b"\x01")
            h.update(prev_hash.to_bytes(8, "little"))
        for t in tokens:
            h.update(int(t).to_bytes(8, "little", signed=True))
        return int.from_bytes(h.digest(), "little")

    def frontier_snapshot(self) -> Dict[str, object]:
        """Snapshot of the cached chain-hash set for the cluster prefix
        registry. ``rev`` lets publishers/registries skip unchanged
        payloads (batched publication)."""
        return {"rev": self._rev, "hashes": list(self._hash_to_page)}

    def cached_prefix_pages(self, tokens: Sequence[int]) -> int:
        """Read-only probe: how many leading FULL pages of ``tokens`` are
        already in the prefix cache. No ref bumps — admission lookahead
        uses this to spot cheap (prefix-sharing) requests behind a
        page-hungry queue head without committing pages to them."""
        prev_hash: Optional[int] = None
        n = 0
        limit = (len(tokens) - 1) // self.page_size
        for i in range(limit):
            chunk = tokens[i * self.page_size:(i + 1) * self.page_size]
            h = self.chain_hash(prev_hash, chunk)
            if h not in self._hash_to_page:
                break
            prev_hash = h
            n += 1
        return n

    def reclaimable_pages(self, pages: Sequence[int]) -> int:
        """How many of ``pages`` would actually return capacity to the
        pool if released now (sole reference): a prefix page shared with
        another live sequence frees nothing, so preemption picks its
        victim by this count, not by page-list length."""
        return sum(1 for p in pages if self._refcount.get(p, 0) == 1)

    def note_prefix_lookup(self, n_tokens: int, n_hit: int) -> None:
        """Account one admitted request's prefix-cache outcome (token
        granularity — feeds the rtpu_kv_prefix_hit_rate gauge)."""
        self.stats["prefix_token_lookups"] += int(n_tokens)
        self.stats["prefix_token_hits"] += int(n_hit)

    def prefix_hit_rate(self) -> float:
        lookups = self.stats["prefix_token_lookups"]
        return self.stats["prefix_token_hits"] / lookups if lookups else 0.0

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens` in FULL pages. Returns
        (page_ids, n_cached_tokens); the pages are ref-bumped."""
        pages: List[int] = []
        prev_hash: Optional[int] = None
        n = 0
        # Never match the *entire* prompt: at least one token must be
        # computed so prefill has a query position to sample from.
        limit = (len(tokens) - 1) // self.page_size
        for i in range(limit):
            chunk = tokens[i * self.page_size:(i + 1) * self.page_size]
            h = self.chain_hash(prev_hash, chunk)
            page = self._hash_to_page.get(h)
            if page is None:
                break
            self._ref(page)
            pages.append(page)
            prev_hash = h
            n += self.page_size
        self.stats["cache_hits"] += len(pages)
        return pages, n

    # ---------------------------------------------------------- lifecycle

    def allocate(self, count: int) -> List[int]:
        if self.num_free() < count:
            raise OutOfPages(f"need {count} pages, {self.num_free()} free")
        out = []
        for _ in range(count):
            if self._free:
                page = self._free.pop()
            else:  # evict the LRU cached page
                page, _ = self._evictable.popitem(last=False)
                self._uncache(page)
                self.stats["evictions"] += 1
            self._refcount[page] = 1
            out.append(page)
        self.stats["allocated"] += count
        return out

    def _ref(self, page: int) -> None:
        if self._refcount.get(page, 0) == 0:
            self._evictable.pop(page, None)
        self._refcount[page] = self._refcount.get(page, 0) + 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page. Cached (hashed) pages become
        evictable; uncached pages return to the free list."""
        for page in pages:
            rc = self._refcount.get(page, 0) - 1
            if rc > 0:
                self._refcount[page] = rc
                continue
            self._refcount.pop(page, None)
            if page in self._page_to_hash:
                self._evictable[page] = None
                self._evictable.move_to_end(page)
            else:
                self._free.append(page)

    def register_full_page(self, page: int, prev_hash: Optional[int],
                           tokens: Sequence[int]) -> int:
        """Enter a now-full page into the prefix cache; returns its chain
        hash (feed into the next page's registration)."""
        assert len(tokens) == self.page_size
        h = self.chain_hash(prev_hash, tokens)
        existing = self._hash_to_page.get(h)
        if existing is not None and existing != page:
            # Duplicate content; keep the existing mapping (this page stays
            # uncached and will be freed on release).
            return h
        self._hash_to_page[h] = page
        self._page_to_hash[page] = h
        self._rev += 1
        return h

    def _uncache(self, page: int) -> None:
        h = self._page_to_hash.pop(page, None)
        if h is not None and self._hash_to_page.get(h) == page:
            del self._hash_to_page[h]
            self._rev += 1

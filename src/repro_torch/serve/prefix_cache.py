"""Block-hash prefix cache over the paged KV pool (port of
``repro/serve/prefix_cache.py``).

SPEED's throughput argument is *data reuse* — don't re-fetch (here: don't
recompute) operands you already hold.  Applied at the request level: a page
that holds the K/V of a full ``page_size``-token block is addressable by the
**hash chain** of the tokens that produced it, so any later request whose
prompt starts with the same token blocks adopts the pages read-only instead
of re-prefilling them.

    h_0 = H(salt)                 salt = (w_bits,) — K/V values depend on the
    h_i = H(h_{i-1} || block_i)   weight precision that computed them, so W4
                                  and W8 requests never share pages even in
                                  the same kv_bits pool.  kv_bits isolation
                                  is structural: one PrefixCache per pool.

Only *full* blocks are cacheable (a partial block's page will still be
written).  Lifecycle of a cached page:

  * **registered** while its owner still runs — other requests incref and
    share it immediately (the pool's refcount keeps it alive).
  * **retained** when the last reference drops: the pool's release hook hands
    it here instead of the free list, and it joins the LRU ring, still
    serving hits.
  * **evicted** when the pool runs dry: the reclaim hook pops the
    least-recently-used retained pages back to the free list and deletes
    their hash entries.  Referenced pages are never evicted.

``match`` returns the longest *contiguous* cached chain — a gap (evicted
block) ends the usable prefix even if later blocks survive, because block i's
K/V cannot be adopted without blocks < i materialized.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from repro_torch.serve.kv_cache import PagedKVCache


def block_hashes(tokens: np.ndarray, block: int, salt: tuple = ()) -> list[bytes]:
    """Hash chain over the full ``block``-token blocks of ``tokens``."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    h = hashlib.sha256(repr(salt).encode()).digest()
    out = []
    for i in range(len(tokens) // block):
        h = hashlib.sha256(h + tokens[i * block : (i + 1) * block].tobytes()).digest()
        out.append(h)
    return out


@dataclass
class PrefixCacheStats:
    """Accounted by the engine at *successful admission* (both sides of the
    ratio), so retries of a blocked request and matched-but-degraded chains
    skew neither numerator nor denominator."""

    lookups: int = 0  # admissions that consulted the cache
    lookup_tokens: int = 0  # full-block tokens those admissions asked for
    hit_tokens: int = 0  # tokens adopted into a table
    registered_blocks: int = 0
    evictions: int = 0
    forks: int = 0  # copy-on-write page forks at divergence points

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / max(self.lookup_tokens, 1)


class PrefixCache:
    """One per ``PagedKVCache`` pool; installs itself as the pool's
    release/reclaim layer."""

    def __init__(self, pool: PagedKVCache):
        self.pool = pool
        self.block = pool.page_size
        self._entries: dict[bytes, int] = {}  # block hash -> page id
        self._by_page: dict[int, bytes] = {}  # inverse (for hooks)
        self._lru: OrderedDict[bytes, None] = OrderedDict()  # retained, LRU->MRU
        self.stats = PrefixCacheStats()
        pool.release_hook = self._on_release
        pool.reclaim_hook = self._reclaim
        pool.reclaimable_fn = lambda: len(self._lru)

    # ----------------------------------------------------------------- hooks
    def _on_release(self, page: int) -> bool:
        """Pool hook: last reference to ``page`` dropped.  Retain it (True)
        if it still backs a hash entry, else let it return to the free list."""
        h = self._by_page.get(page)
        if h is None:
            return False
        self._lru[h] = None
        self._lru.move_to_end(h)
        return True

    def _reclaim(self, n: int) -> list[int]:
        """Pool hook: evict up to ``n`` least-recently-used retained pages."""
        pages = []
        while self._lru and len(pages) < n:
            h, _ = self._lru.popitem(last=False)
            page = self._entries[h]
            if self.pool.refcount(page) > 0:
                # revived by an adopter that hasn't called acquire_note yet:
                # live pages are never evicted, just un-retained
                continue
            del self._entries[h]
            del self._by_page[page]
            pages.append(page)
            self.stats.evictions += 1
        return pages

    # ----------------------------------------------------------------- reuse
    def match(self, hashes: list[bytes]) -> list[int]:
        """Pages backing the longest contiguous cached block chain.  Pure
        lookup, no stats — the caller increfs via
        ``pool.allocate(prefix_pages=...)`` (which revives retained pages)
        before anything can evict them, and accounts ``stats`` for what it
        actually adopts at admission."""
        pages = []
        for h in hashes:
            page = self._entries.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def acquire_note(self, pages: list[int]) -> None:
        """Un-retain pages the caller just incref'd (they are live again)."""
        for p in pages:
            h = self._by_page.get(p)
            if h is not None:
                self._lru.pop(h, None)

    def register(self, hashes: list[bytes], pages: list[int]) -> None:
        """Map each full block's hash to the (live, refcounted) page holding
        its K/V.  First writer wins: an already-registered hash keeps its
        existing page, so concurrent same-prefix requests converge on one
        physical copy as their tables drop references."""
        for h, p in zip(hashes, pages):
            if h in self._entries or p in self._by_page:
                continue
            self._entries[h] = p
            self._by_page[p] = h
            self.stats.registered_blocks += 1

    def forget_pages(self, pages: list[int]) -> None:
        """Drop the hash entries (and any LRU retention) for ``pages`` whose
        *content* is no longer the registered blocks' K/V — speculative
        rollback truncates tail pages that verify may have overwritten with
        rejected-token K/V, so they must stop serving prefix hits before the
        pool reclaims them.  Unregistered pages are ignored."""
        for p in pages:
            h = self._by_page.pop(p, None)
            if h is None:
                continue
            del self._entries[h]
            retained = h in self._lru
            if retained:
                del self._lru[h]
            # a retained page (refcount 0) was held out of the free list by
            # the release hook; with its entry gone nothing will ever free
            # it, so hand it back to the pool now
            if retained and self.pool.refcount(p) == 0:
                self.pool.release_retained(p)

    # ----------------------------------------------------------------- admin
    @property
    def num_entries(self) -> int:
        return len(self._entries)

    @property
    def num_retained(self) -> int:
        return len(self._lru)

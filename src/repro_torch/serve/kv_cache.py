"""Paged KV cache: a fixed pool of fixed-size pages + per-request page tables.

Port of ``repro/serve/kv_cache.py``.  The pool is one tensor per payload with
a leading layer dim, the sequence axis cut into pages:

    k: [L, P, page_size, Hkv, D]       (int8 payload, or the model dtype)
    k_scale: [L, P, page_size, Hkv, 1] f32, only when kv_bits < 16

int4 pools pack two nibbles per byte along the head dim, so the payload
trailing dim is D//2.  A request owns an ordered list of page ids (its page
table); page ``i`` of the table holds positions ``[i*ps, (i+1)*ps)``.  The
free list is LIFO.  Every allocated page carries a refcount so the prefix
cache can map one page into many tables: ``allocate(prefix_pages=...)``
adopts pages read-only, ``fork_page`` copies a shared page before a request
writes into it, and ``free`` recycles a page when its last reference drops.
``release_hook(page) -> bool`` may retain a dead page for future reuse and
``reclaim_hook(n) -> list[page]`` surrenders retained pages when the free list
runs dry.

Book-keeping is host-side Python.  The payload tensors live on the engine's
device and are updated *in place*: the decode and prefill steps scatter new
tokens into them with ``index_put_``, ``write_prompt`` scatters a one-shot
prefill's contiguous rows into a request's pages with ``index_copy_``, and
``fork_page`` copies one page over another.  (The JAX package updates its pools functionally and donates the
old buffers; here there is nothing to donate.)

With ``mesh`` (a meshed engine's, under the tensor-parallel mapping) the
pool holds this rank's kv heads, ``Hkv / M`` of them on an M-wide model
axis, wherever the model axis divides the kv heads
(``sharding.model_splits``, the rule of the attention's split); elsewhere
it holds them all.  Page ids, tables, refcounts and the prefix cache's
hashes are host state, the same on every rank: every rank runs the same
scheduler on the same tokens.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import torch_dtype


class PagedKVCache:
    def __init__(
        self,
        cfg: ArchConfig,
        *,
        num_pages: int,
        page_size: int,
        kv_bits: int = 8,
        device,
        mesh=None,
    ):
        if kv_bits not in (4, 8, 16):
            raise ValueError(f"kv_bits must be 4, 8 or 16, got {kv_bits}")
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_bits = kv_bits
        self.quantized = kv_bits < 16
        self.device = torch.device(device)
        n_layers, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        if mesh is not None:
            with sharding.use_mesh(mesh):
                if sharding.model_splits(hkv):
                    hkv //= sharding.model_size()
        self.kv_heads = hkv
        if kv_bits == 4 and hd % 2:
            raise ValueError(f"kv4 packs nibble pairs along head_dim; hd={hd} is odd")
        payload = torch.int8 if self.quantized else torch_dtype(cfg.dtype)
        dk = hd // 2 if kv_bits == 4 else hd  # packed payload trailing dim
        shape = (n_layers, num_pages, page_size, hkv, dk)
        self.k = torch.zeros(shape, dtype=payload, device=self.device)
        self.v = torch.zeros(shape, dtype=payload, device=self.device)
        if self.quantized:
            sshape = (n_layers, num_pages, page_size, hkv, 1)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32, device=self.device)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32, device=self.device)
        else:
            self.k_scale = None
            self.v_scale = None
        self._free: list[int] = list(range(num_pages - 1, -1, -1))  # LIFO
        self._tables: dict[int, list[int]] = {}
        self._refcount: dict[int, int] = {}  # pages not on the free list
        # prefix-cache hooks (see module docstring); None = plain pool
        self.release_hook: Optional[Callable[[int], bool]] = None
        self.reclaim_hook: Optional[Callable[[int], list[int]]] = None
        self.reclaimable_fn: Optional[Callable[[], int]] = None

    # ------------------------------------------------------------ bookkeeping
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_reclaimable(self) -> int:
        """Pages retained by the cache layer that eviction could free."""
        return self.reclaimable_fn() if self.reclaimable_fn else 0

    @property
    def num_allocatable(self) -> int:
        return len(self._free) + self.num_reclaimable

    def can_allocate(self, n_pages: int) -> bool:
        return self.num_allocatable >= n_pages

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)

    def _pop_pages(self, n_pages: int) -> list[int]:
        """Take n fresh pages, evicting retained cache pages if needed."""
        if len(self._free) < n_pages and self.reclaim_hook:
            self._free.extend(self.reclaim_hook(n_pages - len(self._free)))
        if len(self._free) < n_pages:
            raise MemoryError(
                f"need {n_pages} pages, {len(self._free)} free of {self.num_pages}"
            )
        pages = [self._free.pop() for _ in range(n_pages)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def allocate(
        self, rid: int, n_pages: int, *, prefix_pages: tuple[int, ...] = ()
    ) -> list[int]:
        """Build rid's table: ``prefix_pages`` adopted shared (incref'd, must
        already be live or cache-retained), the remainder fresh from the pool.
        ``n_pages`` is the *total* table length."""
        if rid in self._tables:
            raise KeyError(f"request {rid} already holds pages")
        if len(prefix_pages) > n_pages:
            raise ValueError("prefix_pages longer than the requested table")
        # incref the adopted pages FIRST so a reclaim for the fresh remainder
        # can never evict them out from under this request
        for p in prefix_pages:
            self.incref(p)
        try:
            fresh = self._pop_pages(n_pages - len(prefix_pages))
        except MemoryError:
            for p in prefix_pages:
                self.decref(p)
            raise
        self._tables[rid] = list(prefix_pages) + fresh
        return self._tables[rid]

    def extend(self, rid: int, n_pages: int = 1) -> list[int]:
        pages = self._pop_pages(n_pages)
        self._tables[rid].extend(pages)
        return pages

    def release_retained(self, page: int) -> None:
        """Return a cache-retained page (refcount 0) to the free list."""
        if self.refcount(page) != 0:
            raise ValueError(f"page {page} is still referenced")
        self._free.append(page)

    def incref(self, page: int) -> None:
        """Add a reference to a live or cache-retained page (retained pages
        revive to refcount 1; the cache layer un-tracks them on its side)."""
        self._refcount[page] = self._refcount.get(page, 0) + 1

    def decref(self, page: int) -> None:
        n = self._refcount.get(page, 0) - 1
        if n < 0:
            raise ValueError(f"page {page} refcount underflow")
        if n > 0:
            self._refcount[page] = n
            return
        del self._refcount[page]
        # last reference gone: the cache layer may retain the page for
        # future prefix hits; otherwise it returns to the free list
        if self.release_hook is not None and self.release_hook(page):
            return
        self._free.append(page)

    def free(self, rid: int) -> None:
        for page in reversed(self._tables.pop(rid)):
            self.decref(page)

    def truncate(self, rid: int, n_tokens: int) -> list[int]:
        """Shrink rid's table to the pages covering its first ``n_tokens``
        positions, dropping the reference to every tail page.  Returns the
        dropped page ids."""
        if n_tokens < 0:
            raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
        table = self._tables[rid]
        keep = self.pages_for(n_tokens)
        if keep >= len(table):
            return []
        dropped = table[keep:]
        # replace rather than mutate: callers may hold an alias of the table
        self._tables[rid] = table[:keep]
        for page in reversed(dropped):
            self.decref(page)
        return dropped

    def fork_page(self, rid: int, idx: int) -> int:
        """Copy-on-write: replace slot ``idx`` of rid's table with a private
        copy of the page (payload and scales copied on the device, in place),
        dropping the reference to the shared original.  Returns the new id."""
        old = self._tables[rid][idx]
        (new,) = self._pop_pages(1)
        for pool in (self.k, self.v, self.k_scale, self.v_scale):
            if pool is not None:
                pool[:, new] = pool[:, old]
        self._tables[rid][idx] = new
        self.decref(old)
        return new

    def write_prompt(self, rid: int, k, v, k_scale=None, v_scale=None) -> None:
        """Scatter a prefilled contiguous cache row into rid's pages, in
        place: k / v are [L, S_pad, Hkv, Dk] (scales [L, S_pad, Hkv, 1]) with
        S_pad == len(table) * page_size.  The pools keep their storage (the
        JAX package rebinds its pools; here a captured step reads them by
        address, so a new tensor would leave it reading stale memory)."""
        table = self._tables[rid]
        n, ps = len(table), self.page_size
        if k.shape[1] != n * ps:
            raise ValueError(f"prompt cache len {k.shape[1]} != {n}*{ps}")
        pages = torch.tensor(table, dtype=torch.int64, device=self.device)
        rows = [(self.k, k), (self.v, v)]
        if self.quantized:
            rows += [(self.k_scale, k_scale), (self.v_scale, v_scale)]
        for pool, row in rows:
            paged = row.reshape(row.shape[0], n, ps, *row.shape[2:])
            pool.index_copy_(1, pages, paged.to(pool.dtype))

    def table(self, rid: int) -> list[int]:
        return list(self._tables[rid])

    def capacity_tokens(self, rid: int) -> int:
        """Cache positions currently addressable by rid's page table."""
        return len(self._tables[rid]) * self.page_size

    def table_array(self, rids: list[int], width: int) -> np.ndarray:
        """[B, width] int32 page-table matrix, zero-padded (padded entries
        point at page 0; the kernels never read past a row's length)."""
        out = np.zeros((len(rids), width), np.int32)
        for i, rid in enumerate(rids):
            t = self._tables[rid]
            out[i, : len(t)] = t
        return out

    @property
    def pools(self):
        """(k, v, k_scale, v_scale); scales None when kv_bits == 16."""
        return self.k, self.v, self.k_scale, self.v_scale

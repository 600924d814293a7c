"""Host-side page-table management for the paged KV cache.

The device side (:class:`repro_torch.models.attention.PagedKVCache`, the
gather reference path, the flash-decode kernel) only ever *consumes* page
tables; deciding which pool rows a request owns is a host concern, and it
lives here: a free-list :class:`PagePool` plus the :class:`SlotPager` that
turns "admit this request with this token capacity" into per-slot table rows
(and back into free pages on eviction).

Allocation happens ON ADMIT for the request's full capacity (prompt +
max_new tokens, rounded up to whole pages) — decode never allocates, and a
request that cannot get its pages waits in the queue until completions
reclaim some (:meth:`SlotPager.admit` returns ``False``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def plan_admissions(free_pages: int, free_slots: int,
                    demands) -> tuple[list[int], list[int]]:
    """FIFO admission plan with cascading reservations (starvation-free).

    ``demands[i]`` is the page count request ``i`` needs, oldest first.
    Returns ``(admit, blocked)`` — indices into ``demands``.  A blocked
    older request *reserves* every page a younger request would otherwise
    grab: request ``i`` may only draw from the surplus beyond the sum of all
    older blocked requests' reservations (a page-blocked request reserves
    every usable page, so in practice nothing leapfrogs it).  Freed pages
    therefore accrue to the oldest waiter first, and a large request at the
    queue head admits as soon as enough completions reclaim pages — a
    stream of small younger requests can never starve it.

    ``blocked`` lists only page-limited requests (considered while a slot
    was still free); requests past the slot limit are neither admitted nor
    blocked — they were never candidates this cycle.
    """
    admit: list[int] = []
    blocked: list[int] = []
    avail = int(free_pages)
    reserved = 0
    for i, need in enumerate(demands):
        if len(admit) >= free_slots:
            break
        usable = avail - reserved
        if int(need) <= usable:
            admit.append(i)
            avail -= int(need)
        else:
            blocked.append(i)
            reserved += min(int(need), usable)
    return admit, blocked


def pages_for(cap_tokens: int, page_size: int) -> int:
    """Pages needed to cache ``cap_tokens`` tokens (ceil division) — the ONE
    place the rounding lives; the driver's pool sizing and the allocator
    must agree on it."""
    return -(-int(cap_tokens) // int(page_size))


class PagePool:
    """Free-list allocator over one page pool."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def pressure(self) -> float:
        """Fraction of the pool in use (0..1) — the adaptive-precision
        programs' paged-KV watermark signal."""
        return self.used_pages / max(self.n_pages, 1)

    def alloc(self, n: int) -> list[int] | None:
        """n pool rows, or None (allocate-all-or-nothing) when exhausted."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(f"freeing page {p} outside pool "
                                 f"[0, {self.n_pages})")
        self._free.extend(int(p) for p in pages)


@dataclasses.dataclass
class SlotPager:
    """Per-slot page tables over a shared pool (host mirror of the device
    ``page_table`` array).

    ``n_slots`` decode slots, each with up to ``n_pmax`` logical pages of
    ``page_size`` tokens.  ``table`` is the (n_slots, n_pmax) int32 array the
    driver pushes to the device after every admit/evict; unallocated entries
    are -1, so an overflowing or evicted slot's writes drop instead of
    landing on a reclaimed page.
    """

    n_slots: int
    n_pmax: int
    page_size: int
    pool: PagePool

    def __post_init__(self):
        self.table = np.full((self.n_slots, self.n_pmax), -1, np.int32)

    @classmethod
    def build(cls, n_slots: int, s_max: int, page_size: int,
              pool_pages: int) -> "SlotPager":
        if s_max % page_size:
            raise ValueError(f"page_size={page_size} must divide "
                             f"s_max={s_max}")
        return cls(n_slots=n_slots, n_pmax=s_max // page_size,
                   page_size=page_size, pool=PagePool(pool_pages))

    def pages_for(self, cap_tokens: int) -> int:
        return pages_for(cap_tokens, self.page_size)

    def slot_capacity(self, slot: int) -> int:
        """Tokens slot can cache = allocated pages x page size."""
        return int((self.table[slot] >= 0).sum()) * self.page_size

    def admit(self, slot: int, cap_tokens: int) -> bool:
        """Allocate ``ceil(cap_tokens / page)`` pages into ``slot``'s row.

        Returns False (row untouched) when the pool cannot satisfy the
        request — the caller defers admission until eviction reclaims pages.
        """
        if self.table[slot].max(initial=-1) >= 0:
            raise ValueError(f"slot {slot} already holds pages; evict first")
        n = self.pages_for(cap_tokens)
        if n > self.n_pmax:
            raise ValueError(
                f"capacity {cap_tokens} tokens needs {n} pages > n_pmax="
                f"{self.n_pmax} (s_max); clamp the request first")
        pages = self.pool.alloc(n)
        if pages is None:
            if self.pool.n_pages < n:
                raise ValueError(
                    f"page pool ({self.pool.n_pages} pages) can never fit a "
                    f"{n}-page request; raise pool_pages")
            return False
        self.table[slot, :n] = pages
        return True

    def evict(self, slot: int) -> int:
        """Reclaim ``slot``'s pages; returns how many were freed."""
        row = self.table[slot]
        pages = row[row >= 0]
        self.pool.free(pages.tolist())
        row[:] = -1
        return int(pages.size)


def set_page_tables(caches, table: np.ndarray, rows: slice | None = None,
                    model_shard: int | None = None, tp: int = 1):
    """Push a host page table into every :class:`PagedKVCache` of a cache
    tree (one cache, or a hybrid's dict of caches).

    ``table``: (B, n_pmax) int32 — copied to the device and broadcast over
    each cache's layer-stack dim (every layer's pool is indexed by the same
    logical table).  ``rows``: the slots of one data shard's caches (shard
    ``c`` of a ``Dx1`` mesh owns ``slice(c * b, (c + 1) * b)``); its page
    ids, from the one pager over every slot, index the shard's own pool.
    ``model_shard``: the model index of a sequence-parallel cache on ``tp``
    model shards, whose global table is ``(B, tp * n_loc)`` (the
    reference's table split over the model axis): shard t takes columns
    ``[t * n_loc, (t + 1) * n_loc)``, page ids of its own pool; a table of
    another width raises.  Without it the table is taken whole (one device,
    or the KV-sharded layout, where every model shard indexes the whole
    table).  Other caches pass through.
    """
    from repro_torch.models.attention import PagedKVCache

    if isinstance(caches, dict):
        return {k: set_page_tables(c, table, rows, model_shard, tp)
                for k, c in caches.items()}
    if not isinstance(caches, PagedKVCache):
        return caches
    table = np.asarray(table, np.int32)
    if rows is not None:
        table = table[rows]
    if model_shard is not None:
        n_loc = caches.page_table.shape[-1]
        if table.shape[1] != tp * n_loc:
            raise ValueError(f"a sequence-parallel page table over {tp} model shards of "
                             f"{n_loc} pages wants {tp * n_loc} columns, not {table.shape[1]}")
        table = table[:, model_shard * n_loc:(model_shard + 1) * n_loc]
    pt = torch.as_tensor(table).to(caches.page_table.device)
    return caches._replace(page_table=pt[None].expand(caches.page_table.shape))


def kv_cache_bytes(caches) -> int:
    """Bytes resident in the K/V storage of a cache, or of a hybrid's dict
    of caches (slabs or pools).

    Counts only per-token-growing state (self-attention K/V); page tables,
    lengths and SSM states are excluded so the paged-vs-contiguous
    comparison isolates exactly what paging changes.  Works on ``meta``
    tensors (shapes only).
    """
    from repro_torch.models.attention import KVCache, PagedKVCache

    if isinstance(caches, PagedKVCache):
        return (caches.k_pages.numel() * caches.k_pages.element_size()
                + caches.v_pages.numel() * caches.v_pages.element_size())
    if isinstance(caches, KVCache):
        return (caches.k.numel() * caches.k.element_size()
                + caches.v.numel() * caches.v.element_size())
    if isinstance(caches, dict):
        return sum(kv_cache_bytes(c) for c in caches.values())
    return 0

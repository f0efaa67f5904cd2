"""Host-side page allocator and the device-side page moves (counterpart of
the KV part of ``repro/serving/pages.py``).

Page id 0 is the **null page**: block-table padding and idle decode rows
point at it, so their scatters land in a sacrificial page instead of live
data.  ``PagePool`` holds no tensors — only the free list and refcounts.
A page may have several owners (prompts that hit the same prefix chain,
or the siblings of a forked request); each owner drops exactly its own
references, and the last ``deref`` decides between the free list and the
prefix cache's parking lot (``PagePool.revive`` brings a parked page
back).

``copy_page`` and ``scatter_prefill_pages`` move page bytes on the
device, in place, on the stacked pool tree (leaves (L, n_pages, ps, ...),
the per-tensor ``k_sx``/``v_sx`` of rank 1 stay pool-global).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.layers import _last_writer

NULL_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def live_pages(table_row) -> list[int]:
    """The real (non-null) page ids of one block-table row."""
    return [int(p) for p in table_row if int(p) != NULL_PAGE]


@dataclasses.dataclass
class PagePool:
    """Free list + per-page refcounts; page 0 (null) is never handed out.
    ``deref`` returns True when a page's count reaches zero; the caller
    then ``release``s it to the free list or parks it in the prefix
    cache."""

    n_pages: int

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("need at least the null page + one real page")
        self.free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self.refcount = np.zeros(self.n_pages, np.int32)
        self.peak = 0  # high-water mark of used(): only alloc() raises it

    def available(self) -> int:
        return len(self.free)

    def alloc(self) -> int | None:
        """Pop a free page with refcount 1, or None when dry."""
        if not self.free:
            return None
        pid = self.free.pop()
        self.refcount[pid] = 1
        self.peak = max(self.peak, self.used())
        return pid

    def ref(self, pid: int) -> None:
        if pid == NULL_PAGE or self.refcount[pid] <= 0:
            raise ValueError(f"ref of unowned page {pid}")
        self.refcount[pid] += 1

    def revive(self, pid: int) -> None:
        """Re-activate a parked page (refcount 0, outside the free list)
        without touching its contents."""
        if pid == NULL_PAGE or self.refcount[pid] != 0 or pid in self.free:
            raise ValueError(f"revive of a page that is not parked: {pid}")
        self.refcount[pid] = 1

    def deref(self, pid: int) -> bool:
        if pid == NULL_PAGE or self.refcount[pid] <= 0:
            raise ValueError(f"deref of unowned page {pid}")
        self.refcount[pid] -= 1
        return self.refcount[pid] == 0

    def release(self, pid: int) -> None:
        """Return a refcount-0 page to the free list."""
        if pid == NULL_PAGE or self.refcount[pid] != 0:
            raise ValueError(f"release of live page {pid}")
        self.free.append(pid)

    def used(self) -> int:
        return self.n_pages - 1 - len(self.free)

    def used_by_kind(self) -> dict[str, int]:
        """Live (allocated or parked) pages per kind, the reference's kinds:
        the port's pool holds KV pages only."""
        return {"kv": self.used(), "state": 0, "shared_ro": 0}


# ------------------------------------------------------- device page moves
def scatter_prefill_pages(pool: dict, cache1: dict, page_ids: torch.Tensor) -> dict:
    """Copy a one-request prefill cache into pool pages, IN PLACE.

    pool: stacked pool tree, leaves (L, P, ps, ...); cache1: the prefill's
    cache, leaves (L, 1, S, ...) with S == len(page_ids)·ps; page_ids:
    (MAXP,) destination page of each prompt chunk — NULL_PAGE entries
    (prefix hits, padding past the prompt) all land in the null page,
    resolved last chunk wins as the reference's scatter resolves them
    (``layers._last_writer``)."""
    ids = page_ids.long()
    win = _last_writer(ids)
    for n, leaf in pool.items():
        if leaf.ndim < 3:  # per-tensor scales are pool-global
            continue
        src = cache1[n]
        ps, lead, s = leaf.shape[2], src.shape[0], src.shape[2]
        pages = src.reshape((lead, s // ps, ps) + tuple(src.shape[3:]))
        leaf[:, ids] = pages[:, win].to(leaf.dtype)
    return pool


def copy_page(pool: dict, src: int, dst: int) -> dict:
    """Copy-on-write: duplicate page ``src`` into ``dst`` across layers,
    IN PLACE — every leaf of rank ≥ 3, the per-page scale and selector
    bytes included."""
    for leaf in pool.values():
        if leaf.ndim >= 3:
            leaf[:, dst] = leaf[:, src]
    return pool

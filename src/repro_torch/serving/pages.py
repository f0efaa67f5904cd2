"""Host-side page allocator (counterpart of the KV part of
``repro/serving/pages.py``).

Page id 0 is the **null page**: block-table padding and idle decode rows
point at it, so their scatters land in a sacrificial page instead of live
data.  ``PagePool`` holds no tensors — only the free list and refcounts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

NULL_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


@dataclasses.dataclass
class PagePool:
    """Free list + per-page refcounts; page 0 (null) is never handed out.
    ``deref`` returns True when a page's count reaches zero; the caller
    then ``release``s it to the free list."""

    n_pages: int

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("need at least the null page + one real page")
        self.free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self.refcount = np.zeros(self.n_pages, np.int32)

    def available(self) -> int:
        return len(self.free)

    def alloc(self) -> int | None:
        """Pop a free page with refcount 1, or None when dry."""
        if not self.free:
            return None
        pid = self.free.pop()
        self.refcount[pid] = 1
        return pid

    def ref(self, pid: int) -> None:
        if pid == NULL_PAGE or self.refcount[pid] <= 0:
            raise ValueError(f"ref of unowned page {pid}")
        self.refcount[pid] += 1

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

"""Prefix caching: share immutable full KV pages across requests
(counterpart of ``repro/serving/prefix.py``).

A prompt is cut into full pages; each is keyed by the **chain hash** of
every token up to and including it, so a page is reused only when the
whole prefix matches (RoPE positions and causal attention make a page's
K/V a function of everything before it).  The page writers quantize per
token with the pool-global ``k_sx``/``v_sx``, so two prompts with the
same prefix write the same page bytes: sharing is exact.

Lifecycle: a freshly written full page is *registered* and owned by its
request.  A later request that hits it takes a reference instead of
recomputing it.  When its last owner lets go, the page is *reclaimable*:
it keeps its bytes and its registration, parked in an LRU, and is either
revived by a later hit or evicted (least recently parked first) when the
allocator runs dry.  Shared pages are never written; a forked sibling
copies its shared tail page before its first write (``pages.copy_page``).

With the host tier on, an evicted parked page's bytes move to host RAM
and its hash is re-homed onto the tier's handle (``host_register``); a
later hit claims the handle and streams the page back into a fresh pid.
A hash resolves to an HBM pid or a host handle, never both.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np

from repro_torch.serving.pages import NULL_PAGE

# chain root for the empty prefix (the first chunk hashes against it)
EMPTY_PREFIX = b""


def chain_hash(prev: bytes, chunk: Iterable[int]) -> bytes:
    """blake2b (16-byte digest) of a chunk's tokens as little-endian
    int64, keyed by ``prev``, the digest of everything before it (or
    ``EMPTY_PREFIX``).  Stable across processes and byte orders."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray([int(t) for t in chunk], dtype="<i8").tobytes())
    return h.digest()


def chunk_hashes(prompt, page_size: int) -> list[bytes]:
    """Chain hashes of every FULL page-sized chunk of ``prompt``."""
    out, h = [], EMPTY_PREFIX
    for c in range(len(prompt) // page_size):
        h = chain_hash(h, prompt[c * page_size : (c + 1) * page_size])
        out.append(h)
    return out


class PrefixCache:
    """chain hash → page id, with an LRU of reclaimable (parked) pages."""

    def __init__(self):
        self.by_hash: dict[bytes, int] = {}
        self.hash_of: dict[int, bytes] = {}
        self.reclaimable: OrderedDict[int, None] = OrderedDict()
        # the second tier: chain hash ↔ ``HostPageTier`` handle of parked
        # pages demoted to host RAM, disjoint from ``by_hash``
        self.host_by_hash: dict[bytes, int] = {}
        self.hash_of_handle: dict[int, bytes] = {}
        self.host_hits = 0

    def peek(self, h: bytes) -> Optional[int]:
        """The page holding this chunk, or None; moves nothing (admission
        planning)."""
        return self.by_hash.get(h)

    def lookup(self, h: bytes) -> Optional[int]:
        """The page holding this chunk, or None; a parked page leaves the
        LRU (the caller takes its reference through ``PagePool.revive`` or
        ``PagePool.ref``).  Call only when committing to the page."""
        pid = self.by_hash.get(h)
        if pid is not None:
            self.reclaimable.pop(pid, None)
        return pid

    def register(self, h: bytes, pid: int) -> None:
        """Key page ``pid`` by ``h``.  A second page with a known hash (two
        prompts racing on one prefix, or a recomputed chunk whose first page
        was demoted to host RAM) stays private: the first is kept, in either
        tier."""
        if pid == NULL_PAGE:
            raise ValueError("the null page is never registered")
        if h not in self.by_hash and h not in self.host_by_hash and pid not in self.hash_of:
            self.by_hash[h] = pid
            self.hash_of[pid] = h

    def knows(self, pid: int) -> bool:
        return pid in self.hash_of

    def mark_reclaimable(self, pid: int) -> None:
        """The page's refcount reached zero: park it at the MRU end."""
        if pid not in self.hash_of:
            raise ValueError(f"page {pid} is not registered")
        self.reclaimable[pid] = None
        self.reclaimable.move_to_end(pid)

    def pop_lru(self) -> Optional[tuple[bytes, int]]:
        """Forget the least recently parked page and return ``(hash,
        pid)``; the caller returns the pid to the free list."""
        if not self.reclaimable:
            return None
        pid, _ = self.reclaimable.popitem(last=False)
        h = self.hash_of.get(pid)
        self.forget(pid)
        return h, pid

    # ------------------------------------------------------- host tier
    def host_register(self, h: bytes, handle: int) -> None:
        """Re-home an evicted parked page's hash onto its host handle."""
        if h in self.by_hash or h in self.host_by_hash:
            raise ValueError("a chain hash lives in one tier only")
        self.host_by_hash[h] = handle
        self.hash_of_handle[handle] = h

    def host_peek(self, h: bytes) -> Optional[int]:
        """The host handle caching this chunk, or None; moves nothing."""
        return self.host_by_hash.get(h)

    def host_claim(self, h: bytes) -> Optional[int]:
        """Claim a host-resident chunk for a swap-in: the mapping goes (the
        caller registers the fresh pid once the page is restored) and a
        host hit is counted."""
        handle = self.host_by_hash.pop(h, None)
        if handle is not None:
            del self.hash_of_handle[handle]
            self.host_hits += 1
        return handle

    def host_forget(self, handle: int) -> None:
        """Drop a handle's registration (tier eviction, a refused or corrupt
        entry): the chunk is cached nowhere now."""
        h = self.hash_of_handle.pop(handle, None)
        if h is not None:
            self.host_by_hash.pop(h, None)

    def host_count(self) -> int:
        return len(self.host_by_hash)

    def forget(self, pid: int) -> None:
        """Remove a page's registration."""
        h = self.hash_of.pop(pid, None)
        if h is not None:
            self.by_hash.pop(h, None)
        self.reclaimable.pop(pid, None)

    def reclaimable_count(self) -> int:
        return len(self.reclaimable)

    def snapshot(self) -> dict:
        """The telemetry gauges' values."""
        return {"registered_pages": len(self.by_hash),
                "reclaimable_pages": len(self.reclaimable),
                "host_pages": len(self.host_by_hash)}

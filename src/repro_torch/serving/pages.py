"""Host-side page allocator, the device-side page moves and the host-RAM
page tier (counterpart of ``repro/serving/pages.py``).

Page id 0 is the **null page**: block-table padding and idle decode rows
point at it, so their scatters land in a sacrificial page instead of live
data.  ``PagePool`` holds no tensors — only the free list and refcounts.
A page may have several owners (prompts that hit the same prefix chain,
or the siblings of a forked request); each owner drops exactly its own
references, and the last ``deref`` decides between the free list and the
prefix cache's parking lot (``PagePool.revive`` brings a parked page
back).  Every page carries a kind (``PAGE_KINDS``): ``kv`` pages of the
block-table layout, ``state`` pages that checkpoint a recurrent
family's whole per-sequence state, ``shared_ro`` pages that hold an
enc-dec model's encoder output for every request over the same input —
one budget across kinds.

``copy_page`` and ``scatter_prefill_pages`` move page bytes on the
device, in place, on the stacked pool tree (leaves (L, n_pages, ps, ...),
the per-tensor ``k_sx``/``v_sx`` of rank 1 stay pool-global).

**State pages** (the ``state_*`` tree ops): a state page holds one
sequence's whole cache tree (whatever the family's ``live_cache_init``
builds for batch 1) at a page-aligned position.  They are generic over
the tree: each leaf's batch axis is found by comparing the tree's shapes
at batch 1 and 3 (``state_batch_axes``, on the ``meta`` device), and a
leaf whose shape does not depend on the batch is ``REPLICATED``: stored
once, carried through untouched.  The live tree and the state pool are
written in place (a captured decode graph keeps their addresses).

**The host tier** (``HostPageTier``, docs/ROBUSTNESS.md "Memory tiers"):
a bounded host-RAM pool that parked prefix pages and preemption victims'
pages swap out to and stream back in from, each entry stamped with a
blake2b digest at ``put`` and verified at ``take``.  ``kv_page_fetch`` /
``kv_page_insert`` (``state_page_fetch`` / ``state_page_insert`` for a
state page) move one page across, and ``kv_page_recompress`` is the
cold-page ladder.  On the card every copy goes on the current (compute)
stream, so the stream orders it against the launches around it:

* swap-out: the page's per-page slices are gathered into ONE device
  buffer and copied to page-locked host memory in ONE transfer enqueued
  after every launch already in flight (a depth-2 decode launch
  included); the host waits on that copy's event before it reads the
  bytes, the reference's ``device_get``;
* swap-in: the entry's page-locked buffer goes to the device in ONE
  transfer, then the slices are written into the pool leaves in place
  (``copy_``; a captured decode graph keeps the leaves' addresses), all
  ahead of the next prefill launch or graph replay; the buffer comes from
  the caching host allocator, which keeps it until the copy has landed.

Two meanings of "pinned" meet here: a tier entry that is ``pinned`` is a
preemption carry that LRU eviction may not drop (the reference's word);
the host memory that a copy reads or writes is *page-locked*.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.models.layers import _last_writer

NULL_PAGE = 0
# typed page kinds (see the module docstring)
KIND_KV = "kv"
KIND_STATE = "state"
KIND_SHARED_RO = "shared_ro"
PAGE_KINDS = (KIND_KV, KIND_STATE, KIND_SHARED_RO)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def live_pages(table_row) -> list[int]:
    """The real (non-null) page ids of one block-table row."""
    return [int(p) for p in table_row if int(p) != NULL_PAGE]


@dataclasses.dataclass
class PagePool:
    """Free list + per-page refcounts and kinds; page 0 (null) is never
    handed out.  ``deref`` returns True when a page's count reaches zero;
    the caller then ``release``s it to the free list or parks it in the
    prefix cache.  A parked page keeps its kind, so ``revive`` hands back
    the typed content it parked."""

    n_pages: int

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("need at least the null page + one real page")
        self.free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self.refcount = np.zeros(self.n_pages, np.int32)
        self.kind: list[str | None] = [None] * self.n_pages  # None: null or free
        self.peak = 0  # high-water mark of used(): only alloc() raises it

    def available(self) -> int:
        return len(self.free)

    def alloc(self, kind: str = KIND_KV) -> int | None:
        """Pop a free page of ``kind`` with refcount 1, or None when dry."""
        if kind not in PAGE_KINDS:
            raise ValueError(f"unknown page kind {kind!r}")
        if not self.free:
            return None
        pid = self.free.pop()
        self.refcount[pid] = 1
        self.kind[pid] = kind
        self.peak = max(self.peak, self.used())
        return pid

    def kind_of(self, pid: int) -> str | None:
        return self.kind[pid]

    def ref(self, pid: int) -> None:
        if pid == NULL_PAGE or self.refcount[pid] <= 0:
            raise ValueError(f"ref of unowned page {pid}")
        self.refcount[pid] += 1

    def revive(self, pid: int, kind: str | None = None) -> None:
        """Re-activate a parked page (refcount 0, outside the free list)
        without touching its contents or its kind.  With ``kind``, the
        parked page must be of that kind (a shared_ro hit never revives a
        parked page of another kind)."""
        if pid == NULL_PAGE or self.refcount[pid] != 0 or pid in self.free:
            raise ValueError(f"revive of a page that is not parked: {pid}")
        if kind is not None and self.kind[pid] != kind:
            raise ValueError(f"revive kind mismatch: page {pid} is {self.kind[pid]!r}, "
                             f"expected {kind!r}")
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
        self.kind[pid] = None
        self.free.append(pid)

    def used(self) -> int:
        return self.n_pages - 1 - len(self.free)

    def used_by_kind(self) -> dict[str, int]:
        """Live (allocated or parked) pages per kind; the counts sum to
        ``used()``."""
        counts = {k: 0 for k in PAGE_KINDS}
        in_free = set(self.free)
        for pid in range(1, self.n_pages):
            k = self.kind[pid]
            if k is not None and pid not in in_free:
                counts[k] += 1
        return counts


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


# ----------------------------------------------------- state-page tree ops
REPLICATED = -1  # the batch axis of a leaf whose shape does not depend on the batch


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in sorted-key order, the order
    ``jax.tree.leaves`` gives the reference's dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def state_batch_axes(cache_init_fn):
    """The batch axis of each leaf of ``cache_init_fn(batch)``: the first
    axis whose extent differs between batch 1 and batch 3, ``REPLICATED``
    where none does.  Pass a ``cache_init_fn`` that builds on the ``meta``
    device: nothing is allocated."""

    def axis(a, b):
        if a.ndim != b.ndim:
            raise ValueError(f"leaf rank depends on the batch: {tuple(a.shape)} vs {tuple(b.shape)}")
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                if (x, y) != (1, 3):
                    raise ValueError(f"batch axis must scale 1:1 with the batch, got "
                                     f"{tuple(a.shape)} vs {tuple(b.shape)} at axis {i}")
                return i
        return REPLICATED

    return _tree_map(axis, cache_init_fn(1), cache_init_fn(3))


def state_pool_init(cache_init_fn, axes, n_pages: int):
    """The state pool: each leaf of ``cache_init_fn(1)`` with its batch axis
    moved to the front and widened to ``n_pages`` (the page id indexes it),
    zeros; a ``REPLICATED`` leaf is stored once, as batch 1 builds it."""

    def build(leaf, ax):
        if ax == REPLICATED:
            return leaf
        shape = (n_pages,) + tuple(leaf.shape[:ax]) + tuple(leaf.shape[ax + 1:])
        return torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)

    return _tree_map(build, cache_init_fn(1), axes)


def state_checkpoint_rows(pool, live, axes, dsts: torch.Tensor):
    """Scatter every live row's state into its destination page, IN PLACE.
    ``live``: the engine's batch-B cache tree; ``dsts``: (B,) page id per
    row.  Rows sent to ``NULL_PAGE`` (idle slots, rows not checkpointing)
    all land in the sacrificial null page, resolved last row wins as the
    reference's scatter resolves them (``layers._last_writer``:
    ``index_put_`` on CUDA promises no order among duplicates)."""
    ids = dsts.long()
    win = _last_writer(ids)

    def scat(pl, lv, ax):
        if ax != REPLICATED:
            pl[ids] = torch.movedim(lv, ax, 0)[win].to(pl.dtype)

    _tree_map(scat, pool, live, axes)
    return pool


def state_restore_row(live, pool, axes, row: int, pid: int):
    """Write page ``pid``'s checkpoint into row ``row`` of the live tree, IN
    PLACE."""

    def rest(lv, pl, ax):
        if ax != REPLICATED:
            lv.select(ax, row).copy_(pl[pid].to(lv.dtype))

    _tree_map(rest, live, pool, axes)
    return live


def state_extract_row(live, axes, row: int):
    """Row ``row`` of the live tree as a batch-1 tree of its own."""
    return _tree_map(lambda lv, ax: lv if ax == REPLICATED else lv.narrow(ax, row, 1).clone(),
                     live, axes)


def state_insert_row(live, one, axes, row: int):
    """Write a batch-1 tree into row ``row`` of the live tree, IN PLACE."""

    def ins(lv, on, ax):
        if ax != REPLICATED:
            lv.narrow(ax, row, 1).copy_(on.to(lv.dtype))

    _tree_map(ins, live, one, axes)
    return live


def state_copy_row(live, axes, src: int, dst: int):
    """Duplicate live row ``src`` into row ``dst`` (fork siblings), IN PLACE."""

    def cp(lv, ax):
        if ax != REPLICATED:
            lv.select(ax, dst).copy_(lv.select(ax, src))

    _tree_map(cp, live, axes)
    return live


# ------------------------------------------------------------ host page tier
#
# A page swapped out leaves its pid: the pid goes back to the free list and
# a swap-in allocates a fresh one.  A host-resident page is keyed by an
# opaque integer handle (and a prefix page by its chain hash as well,
# ``PrefixCache.host_register``), never by a pid, so a chain hash resolves
# to an HBM pid OR a host handle, never both, and handles never appear in
# block tables.

# far outside any pid range: a handle that leaked into a block table shows
# up as an out-of-range page id
_HANDLE_BASE = 1 << 40


class PageCorruptionError(Exception):
    """A swapped-in page failed its integrity check.  Typed so that the
    engine quarantines only the owning request."""

    def __init__(self, handle: int, kind: str | None, detail: str = ""):
        self.handle = handle
        self.kind = kind
        super().__init__(f"host page {handle} ({kind}) failed integrity verification"
                         + (f": {detail}" if detail else ""))


def _dtype_name(a) -> str:
    """numpy's name of an array's dtype; a torch tensor's by the same name
    (``"bfloat16"`` as ml_dtypes names the reference's bf16 arrays)."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return str(a.dtype)


def _raw(a):
    """The array's bytes as a contiguous buffer (a bf16 tensor through a
    byte view: numpy has no bfloat16)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def page_digest(arrays) -> bytes:
    """Order-, dtype- and shape-sensitive blake2b (16 bytes) over a page's
    arrays: per array its dtype's name, its shape as little-endian int64
    and its raw bytes — the reference's digest of the same bytes."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(_dtype_name(a).encode())
        h.update(np.asarray(tuple(a.shape), "<i8").tobytes())
        h.update(_raw(a))
    return h.digest()


def _layout(arrays) -> tuple[list[int], int]:
    """Byte offsets of ``arrays`` laid back to back in one buffer (each
    16-byte aligned, so a slice views as any dtype) and the total size."""
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.numel() * a.element_size() // 16) * 16
    return offs, n


def _views(flat: torch.Tensor, offs, like) -> list:
    """Typed views of ``flat`` (uint8) at ``offs``, shaped as ``like``."""
    return [flat[o:o + a.numel() * a.element_size()].view(a.dtype).view(a.shape)
            for o, a in zip(offs, like)]


@dataclasses.dataclass
class _HostEntry:
    kind: str
    arrays: list  # host tensors, views of ``flat``: the per-page pool slices
    digest: bytes
    nbytes: int
    pinned: bool  # a queued preemption carry: LRU eviction may not drop it
    meta: dict
    flat: torch.Tensor  # the one uint8 buffer behind ``arrays`` (a swap-in's source)


class HostPageTier:
    """Bounded host-RAM pool of swapped-out pages, LRU over unpinned
    entries.  ``put`` copies a page's host arrays (``kv_page_fetch``) into
    one buffer of its own and stamps a digest; ``take`` verifies and
    CONSUMES the entry (the page becomes HBM-resident again: one tier per
    page).  ``pinned`` entries are preemption carries held by a queued
    request and go only when dropped; unpinned (prefix) entries may be
    LRU-evicted (``evict_lru``) when the tier is full.  Where a card is
    present the entries' buffers are page-locked host memory (the caching
    host allocator's), so a swap-in copies straight from them."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("a host tier needs a positive capacity")
        self.capacity = int(capacity)
        self.page_locked = torch.cuda.is_available()
        self.entries: OrderedDict[int, _HostEntry] = OrderedDict()
        self._next = _HANDLE_BASE + 1
        self.bytes_resident = 0

    def used(self) -> int:
        return len(self.entries)

    def full(self) -> bool:
        return len(self.entries) >= self.capacity

    def has(self, handle: int) -> bool:
        return handle in self.entries

    def kind_of(self, handle: int) -> str | None:
        e = self.entries.get(handle)
        return e.kind if e is not None else None

    def put(self, arrays, kind: str, pinned: bool = False, meta: dict | None = None) -> int:
        """Store one page's host arrays (tensors or numpy arrays); returns
        its handle.  The arrays are copied: the entry must not alias the
        caller's buffer, and the fault seam flips its bytes."""
        if self.full():
            raise AssertionError("caller must evict_lru() or fall back")
        arrays = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
                  for a in arrays]
        offs, total = _layout(arrays)
        flat = torch.empty(total, dtype=torch.uint8, pin_memory=self.page_locked)
        views = _views(flat, offs, arrays)
        for v, a in zip(views, arrays):
            v.copy_(a)
        nbytes = sum(a.numel() * a.element_size() for a in arrays)
        handle = self._next
        self._next += 1
        self.entries[handle] = _HostEntry(kind=kind, arrays=views, digest=page_digest(views),
                                          nbytes=nbytes, pinned=pinned, meta=dict(meta or {}),
                                          flat=flat)
        self.bytes_resident += nbytes
        return handle

    def take(self, handle: int, expect_kind: str | None = None) -> _HostEntry:
        """Verify and consume an entry (swap-in).  A digest or kind mismatch
        raises ``PageCorruptionError``, the entry gone either way (recompute
        is the fallback)."""
        e = self.entries.pop(handle)
        self.bytes_resident -= e.nbytes
        if expect_kind is not None and e.kind != expect_kind:
            raise PageCorruptionError(handle, e.kind, f"expected kind {expect_kind!r}")
        if page_digest(e.arrays) != e.digest:
            raise PageCorruptionError(handle, e.kind, "digest mismatch")
        return e

    def drop(self, handle: int) -> None:
        e = self.entries.pop(handle, None)
        if e is not None:
            self.bytes_resident -= e.nbytes

    def pin(self, handle: int, pinned: bool = True) -> None:
        self.entries[handle].pinned = pinned

    def evict_lru(self) -> tuple[int, dict] | None:
        """Drop the least recently put UNPINNED entry; (handle, meta) so the
        caller can unregister its chain hash, or None if all are pinned."""
        for handle, e in self.entries.items():
            if not e.pinned:
                del self.entries[handle]
                self.bytes_resident -= e.nbytes
                return handle, e.meta
        return None

    def corrupt(self, handle: int, byte: int = 0) -> None:
        """Flip one stored byte (the ``swap_corrupt`` seam and tests): the
        next ``take`` of this handle raises ``PageCorruptionError``."""
        for a in self.entries[handle].arrays:
            if a.numel():
                flat = a.view(-1).view(torch.uint8)
                flat[byte % flat.numel()] ^= 0xFF
                return

    def snapshot(self) -> dict:
        return {"used": self.used(), "capacity": self.capacity,
                "bytes_resident": self.bytes_resident,
                "pinned": sum(1 for e in self.entries.values() if e.pinned)}


# ------------------------------------------------ device <-> host page moves
def _page_leaves(pool: dict) -> list:
    """The per-page leaves (rank ≥ 3, page id on axis 1) in sorted-key
    order — the order ``jax.tree.leaves`` gives the reference's dict, so
    the fetched arrays and their digests match its own."""
    return [pool[n] for n in sorted(pool) if pool[n].ndim >= 3]


def _to_host(sel: list) -> list:
    """Device slices on the host.  On the card: gathered into one device
    buffer, copied to page-locked host memory in ONE transfer on the
    current stream (after every launch in flight), and waited for; the
    arrays are views of that buffer."""
    if sel[0].device.type != "cuda":
        return [a.clone() for a in sel]
    offs, total = _layout(sel)
    stage = torch.empty(total, dtype=torch.uint8, device=sel[0].device)
    for v, a in zip(_views(stage, offs, sel), sel):
        v.copy_(a)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host.copy_(stage, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return _views(host, offs, sel)


def _from_host(dsts: list, arrays, flat: torch.Tensor | None) -> None:
    """Write host arrays into the device slices ``dsts`` IN PLACE
    (``copy_``: the leaves keep their addresses).  ``flat``: the one buffer
    the arrays are views of, as ``HostPageTier.put`` lays them out; on the
    card it crosses in ONE transfer on the current stream."""
    arrays = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
              for a in arrays]
    if flat is not None and dsts[0].device.type == "cuda":
        offs, total = _layout(arrays)
        dev = torch.empty(total, dtype=torch.uint8, device=dsts[0].device)
        dev.copy_(flat[:total], non_blocking=True)
        arrays = _views(dev, offs, arrays)
    for dst, a in zip(dsts, arrays):
        dst.copy_(a.to(dst.dtype))


def kv_page_fetch(pool: dict, pid: int) -> list:
    """Page ``pid``'s slice of every per-page pool leaf, on the host
    (``_to_host``: one transfer on the card)."""
    return _to_host([leaf[:, pid] for leaf in _page_leaves(pool)])


def kv_page_insert(pool: dict, arrays, pid: int, flat: torch.Tensor | None = None) -> dict:
    """Write host arrays back into pool page ``pid`` IN PLACE
    (``_from_host``)."""
    _from_host([leaf[:, pid] for leaf in _page_leaves(pool)], arrays, flat)
    return pool


def _state_slices(spool, axes, pid: int) -> list:
    """Page ``pid``'s slice of every per-page state-pool leaf, in the
    reference's leaf order (``REPLICATED`` leaves are pool-global)."""
    return [pl[pid] for pl, ax in zip(tree_leaves(spool), tree_leaves(axes)) if ax != REPLICATED]


def state_page_fetch(spool, axes, pid: int) -> list:
    """One state page (a checkpointed row) on the host (``_to_host``)."""
    return _to_host(_state_slices(spool, axes, pid))


def state_page_insert(spool, axes, arrays, pid: int, flat: torch.Tensor | None = None):
    """Write host arrays back into state page ``pid`` IN PLACE
    (``_from_host``)."""
    _from_host(_state_slices(spool, axes, pid), arrays, flat)
    return spool


# ------------------------------------------------- cold-page recompression
#
# An opt-in ladder for COLD (parked, LRU-tail) pages under sustained pool
# pressure: native → int8 → bcq4 *value precision*.  The page keeps its
# pool layout, so a stage is a fake-quant round trip applied in place to
# the page's floating-point leaves; integer leaves (already-quantized
# payloads, every per-page leaf of a bcq4 pool) pass through untouched.
# Swapped pages are never recompressed in flight: a swap stays bitwise.

RECOMPRESS_STAGES = ("native", "int8", "bcq4")
# symmetric uniform levels per stage; int8 round-trips any integer-valued
# payload |x| <= 127 exactly
_STAGE_LEVELS = {"int8": 127, "bcq4": 7}


def _fake_quant(x: torch.Tensor, levels: int) -> torch.Tensor:
    """One amax over the whole slice (every layer of the page at once),
    scale amax / levels — a division, as the reference divides — rounded
    half to even and clipped; an integer-valued payload within ±levels
    keeps scale 1 (lossless there).  Cast back to ``x``'s dtype."""
    xf = x.float()
    amax = xf.abs().max()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    lv = torch.full((), float(levels), dtype=torch.float32, device=x.device)
    exact = (xf == torch.round(xf)).all() & (amax <= lv)
    scale = torch.where(exact, one, torch.where(amax > 0, amax / lv, one))
    q = torch.clamp(torch.round(xf / scale), -levels, levels)
    return (q * scale).to(x.dtype)


def kv_page_recompress(pool: dict, pid: int, stage: str) -> dict:
    """Requantize page ``pid``'s floating-point leaves in place to
    ``stage``'s value precision; ``native`` is the identity."""
    if stage == "native":
        return pool
    levels = _STAGE_LEVELS[stage]
    for leaf in _page_leaves(pool):
        if leaf.is_floating_point():
            leaf[:, pid].copy_(_fake_quant(leaf[:, pid], levels))
    return pool

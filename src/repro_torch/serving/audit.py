"""Invariant auditor for the paged serving engines (counterpart of
``repro/serving/audit.py``).

The allocator, the prefix cache and the engine's page references (block
tables in the kv layout; slot checkpoint and encoder pages, and those
queued requests carry, in the state layout) are three views of one
ownership story; a page leak or a double free is a
disagreement between the views, so it can be checked mechanically.
``audit_engine`` walks all three and checks the laws the serving design
rests on:

* **refcount ≡ table references** — every non-null page's refcount
  equals the number of active block-table rows holding it (a row carries
  one reference per page: prefix claims, fork references and
  copy-on-write replacements all keep this), so a page no table reaches
  but whose refcount is positive is a leak, named; in the state layout
  the references are each slot's checkpoint page (a ``state`` page) and
  encoder page (a ``shared_ro`` page, enc-dec) and each queued request's
  carried ones, and a checkpoint never covers more tokens than its row
  (``ckpt_pos ≤ pos``); a parked encoder page is in the prefix LRU like
  any parked page;
* **partition** — every non-null page is exactly one of: free (refcount
  0), referenced (refcount > 0), or parked reclaimable in the prefix LRU
  (refcount 0, contents kept);
* **no dangling references** — no live slot references a freed page,
  empty slots hold all-NULL rows, sibling reservations point at live
  parents;
* **prefix-chain consistency** — hash ↔ page registration is a
  bijection, registered refcount-0 pages are parked, no free page stays
  registered;
* **slot geometry** — a slot's live pages are a contiguous prefix of its
  row covering its position (one more for a freshly ensured tail page);
* **cross-tier partition** (host tier on) — a chain hash resolves to an
  HBM pid or a host handle, never both; the tier is within its capacity
  and ``bytes_resident`` is its entries' sum; each pinned entry is a
  preemption carry held by exactly one queued request, each unpinned one
  a registered prefix chunk (host registration a bijection onto them);
  every entry has its 16-byte digest and a handle above ``_HANDLE_BASE``
  (never a pid); no free page keeps a recompression stage.

``AuditReport`` collects every violation; ``engine.audit(strict=True)``
(or an engine built with ``strict=True``) raises ``AuditError`` on a
dirty report.  The walk reads host-side numpy and dicts only, no device
work, so ``audit_every=N`` can ride production ticks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.pages import (
    _HANDLE_BASE,
    KIND_SHARED_RO,
    KIND_STATE,
    NULL_PAGE,
    pages_needed,
)


class AuditError(RuntimeError):
    """The engine's page-ownership invariants do not hold.  The message
    carries every violation found."""


@dataclasses.dataclass
class AuditReport:
    """Outcome of one invariant sweep."""

    ok: bool
    violations: list
    pages_checked: int
    slots_checked: int
    tick: int

    def raise_if_dirty(self) -> "AuditReport":
        if not self.ok:
            raise AuditError(
                f"{len(self.violations)} invariant violation(s) at tick {self.tick}: "
                + "; ".join(self.violations))
        return self

    def to_dict(self) -> dict:
        return {"ok": self.ok, "violations": list(self.violations),
                "pages_checked": self.pages_checked, "slots_checked": self.slots_checked,
                "tick": self.tick}


def pool_refcount(engine, pid: int) -> int:
    return int(engine.pool_mgr.refcount[pid])


def _gather_kv_refs(engine, free_set, bad) -> dict:
    """References = live block-table entries, plus the contiguous-prefix
    geometry check (live pages exactly cover pos)."""
    table_refs: dict[int, int] = {}
    for i, slot in enumerate(engine.slots):
        row = engine.tables[i]
        live = [int(p) for p in row if int(p) != NULL_PAGE]
        if slot.req is None:
            if live:
                bad.append(f"empty slot {i} still references pages {live[:4]}")
            if slot.reserved_by is not None and engine.slots[slot.reserved_by].req is None:
                bad.append(f"slot {i} reserved by empty slot {slot.reserved_by} "
                           "(abandoned fork reservation)")
            continue
        for pid in live:
            table_refs[pid] = table_refs.get(pid, 0) + 1
            if pid in free_set:
                bad.append(f"slot {i} references FREED page {pid}")
            if pool_refcount(engine, pid) <= 0:
                bad.append(f"slot {i} references page {pid} with refcount "
                           f"{pool_refcount(engine, pid)}")
        n_live = len(live)
        if any(int(p) != NULL_PAGE for p in row[n_live:]):
            bad.append(f"slot {i} block-table row has a NULL hole before a live page")
        need = pages_needed(slot.pos, engine.ps)
        if n_live not in (need, need + 1):
            bad.append(f"slot {i} holds {n_live} pages for pos={slot.pos} "
                       f"(expected {need} or {need + 1})")
    return table_refs


def _gather_state_refs(engine, free_set, bad) -> dict:
    """References = each slot's checkpoint and encoder pages plus those a
    preempted, requeued request carries; each must be a live page of its
    kind (``state``, ``shared_ro``), and a checkpoint covers at most the
    tokens its row holds."""
    pool = engine.pool_mgr
    refs: dict[int, int] = {}

    def take(pid, want, where):
        refs[pid] = refs.get(pid, 0) + 1
        if pid in free_set:
            bad.append(f"{where} references FREED page {pid}")
        elif pool_refcount(engine, pid) <= 0:
            bad.append(f"{where} references page {pid} with refcount {pool_refcount(engine, pid)}")
        elif pool.kind_of(pid) != want:
            bad.append(f"{where} expects a {want!r} page but {pid} is tagged "
                       f"{pool.kind_of(pid)!r}")

    for i, slot in enumerate(engine.slots):
        if slot.req is None:
            if slot.ckpt_page is not None or slot.enc_page is not None:
                bad.append(f"empty slot {i} still references pages (checkpoint "
                           f"{slot.ckpt_page}, encoder {slot.enc_page})")
            continue
        if slot.ckpt_page is not None:
            take(int(slot.ckpt_page), KIND_STATE, f"slot {i} checkpoint")
            if not 0 <= slot.ckpt_pos <= slot.pos:
                bad.append(f"slot {i} checkpoint covers {slot.ckpt_pos} tokens but the row holds "
                           f"{slot.pos} (ckpt_pos must be ≤ pos)")
        if slot.enc_page is not None:
            take(int(slot.enc_page), KIND_SHARED_RO, f"slot {i} encoder page")
    for k, req in enumerate(engine.queue):
        if req._state_resume is not None:
            take(int(req._state_resume[0]), KIND_STATE, f"queued request #{k} (rid={req.rid})")
        enc = getattr(req, "_enc_page", None)  # the reference's requests set it only when carried
        if enc is not None:
            take(int(enc), KIND_SHARED_RO, f"queued request #{k} (rid={req.rid}) encoder page")
    return refs


def _audit_host_tier(engine, prefix, bad) -> None:
    """The cross-tier partition of the KV layout (see the module's list)."""
    tier = getattr(engine, "host_tier", None)
    if tier is None:
        if prefix.host_by_hash or prefix.hash_of_handle:
            bad.append(f"host tier disabled but {len(prefix.host_by_hash)} prefix hashes "
                       "resolve to host handles")
        return
    if tier.used() > tier.capacity:
        bad.append(f"host tier over capacity: {tier.used()} > {tier.capacity}")
    nbytes = sum(e.nbytes for e in tier.entries.values())
    if nbytes != tier.bytes_resident:
        bad.append(f"host tier bytes_resident {tier.bytes_resident} != {nbytes} summed entry "
                   "bytes")
    carried: dict[int, int] = {}
    for req in engine.queue:
        for h in (req._host_resume[0] if req._host_resume is not None else ()):
            carried[h] = carried.get(h, 0) + 1
        if req._host_state_resume is not None:
            h = req._host_state_resume[0]
            carried[h] = carried.get(h, 0) + 1
    for handle, n in carried.items():
        if n != 1:
            bad.append(f"host handle {handle} carried by {n} requests")
        e = tier.entries.get(handle)
        if e is None:
            bad.append(f"queued request carries dangling host handle {handle}")
        elif not e.pinned:
            bad.append(f"carried host handle {handle} is not pinned")
        if handle in prefix.hash_of_handle:
            bad.append(f"host handle {handle} is both a preemption carry and a registered "
                       "prefix chunk")
    if len(prefix.host_by_hash) != len(prefix.hash_of_handle):
        bad.append(f"host prefix registration not a bijection: {len(prefix.host_by_hash)} "
                   f"hashes vs {len(prefix.hash_of_handle)} handles")
    for h, handle in prefix.host_by_hash.items():
        if prefix.hash_of_handle.get(handle) != h:
            bad.append(f"host prefix maps disagree on handle {handle}")
        if not tier.has(handle):
            bad.append(f"prefix hash registered on dangling host handle {handle}")
        if h in prefix.by_hash:
            bad.append(f"hash resolves to BOTH HBM page {prefix.by_hash[h]} and host handle "
                       f"{handle} (one tier per page)")
    for handle, e in tier.entries.items():
        if handle <= _HANDLE_BASE:
            bad.append(f"host handle {handle} at/below the handle base (collides with HBM "
                       "page ids)")
        if len(e.digest) != 16:
            bad.append(f"host handle {handle} has no integrity digest")
        if e.kind != engine.HOST_SWAP_KIND:
            bad.append(f"host handle {handle} holds a {e.kind!r} page but this layout swaps "
                       f"{engine.HOST_SWAP_KIND!r}")
        if e.pinned:
            if carried.get(handle, 0) == 0:
                bad.append(f"pinned host handle {handle} carried by no queued request "
                           "(host-tier leak)")
        elif handle not in prefix.hash_of_handle:
            bad.append(f"unpinned host handle {handle} has no prefix registration "
                       "(unreachable host entry)")


def audit_engine(engine) -> AuditReport:
    """One full consistency sweep over the PagePool, the PrefixCache and
    the engine's page references (block tables, or state checkpoints)."""
    pool, prefix = engine.pool_mgr, engine.prefix
    bad: list[str] = []
    free = list(pool.free)
    free_set = set(free)
    parked = set(prefix.reclaimable)
    if len(free) != len(free_set):
        bad.append("free list contains duplicate page ids")
    if NULL_PAGE in free_set:
        bad.append("null page on the free list")
    if pool.refcount[NULL_PAGE] != 0:
        bad.append(f"null page refcount {int(pool.refcount[NULL_PAGE])} != 0")

    if getattr(engine, "PAGE_LAYOUT", "kv") == "state":
        table_refs = _gather_state_refs(engine, free_set, bad)
    else:
        table_refs = _gather_kv_refs(engine, free_set, bad)

    # per-page conservation
    for pid in range(1, pool.n_pages):
        rc = int(pool.refcount[pid])
        refs = table_refs.get(pid, 0)
        if rc < 0:
            bad.append(f"page {pid} refcount {rc} < 0")
        if rc != refs:
            bad.append(f"page {pid} refcount {rc} != {refs} block-table references")
        is_free, is_parked = pid in free_set, pid in parked
        states = int(is_free) + int(is_parked) + int(rc > 0)
        if states == 0:
            bad.append(f"page {pid} LEAKED: refcount 0, not free, not parked reclaimable")
        elif states > 1:
            bad.append(f"page {pid} in {states} states at once "
                       f"(free={is_free}, parked={is_parked}, refcount={rc})")

    # prefix-cache registration chain
    if len(prefix.by_hash) != len(prefix.hash_of):
        bad.append(f"prefix registration not a bijection: {len(prefix.by_hash)} "
                   f"hashes vs {len(prefix.hash_of)} pages")
    for h, pid in prefix.by_hash.items():
        if prefix.hash_of.get(pid) != h:
            bad.append(f"prefix hash↔page maps disagree on page {pid}")
    for pid in prefix.hash_of:
        if pid in free_set:
            bad.append(f"free page {pid} still registered in the prefix cache")
        if pool.refcount[pid] == 0 and pid not in parked:
            bad.append(f"registered page {pid} at refcount 0 is not parked reclaimable "
                       "(unevictable orphan)")
    for pid in parked:
        if pid not in prefix.hash_of:
            bad.append(f"parked page {pid} has no prefix registration")

    _audit_host_tier(engine, prefix, bad)
    for pid in getattr(engine, "_recompress_stage", {}):
        if pid in free_set:
            bad.append(f"free page {pid} still has a recompress stage marker")

    return AuditReport(ok=not bad, violations=bad, pages_checked=pool.n_pages - 1,
                       slots_checked=len(engine.slots), tick=getattr(engine, "_tick", 0))

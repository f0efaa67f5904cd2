"""StatePagedEngine: paged serving for O(1)-state families and enc-dec
over typed pages (counterpart of ``repro/serving/state_engine.py``).

The KV engine (``serving/engine.py``) maps token positions to (page, slot)
through block tables — meaningless for a family whose decode state is a
fixed-size recurrence (Mamba-2's ssm and conv states; the hybrid's LRU and
conv states and its window-sized KV ring with the ring's ``pos_buf``) or a
decoder slab that cross-attends to a shared encoder output (enc-dec: the
decoder's self caches up to ``max_len``).  This engine keeps
the KV engine's request lifecycle, admission control, preemption,
pipelined tick, fault containment and telemetry (it subclasses
PagedEngine's layout-independent core) and swaps the storage layout:

* **the live tree** — ONE resident batch-``n_slots`` cache tree
  (``api.live_cache_init``); slot i owns row i.  Decode is one fused
  per-row launch over the whole tree (``api.state_decode_fn`` with a (B,)
  position vector); the tree is updated in place.  An idle row is not
  cleared: it decodes its stale token at position 0 every tick, as the
  reference's does, since under W4A4 every row enters each linear's
  per-launch activation scale.
* **state pages** (kind ``state``) — at every page-aligned position
  ((pos+1) % page_size == 0) a slot checkpoints its row verbatim into its
  state page: ``pages.state_checkpoint_rows`` rides the decode launch,
  one extra device write every page_size ticks (two decode graphs: with
  and without the scatter).  Admission checkpoints too.  A preemption
  hands the page to the requeued request: re-admission restores it and
  replays the tokens past it one at a time at batch 1 — at most
  page_size — instead of the whole prompt.  With ``quant_mode="none"``
  the resumed tokens equal a never-preempted run's (the logits may part
  in the last bits: a batch-1 GEMM may sum in another order); under W4A4
  a batch-1 replay launch has its own activation scale, and since every
  launch shares one scale over its rows, tokens of every request may
  part from the first resumed launch on.  A checkpoint that cannot allocate (pool
  dry, the ``alloc`` seam) is skipped: the replay bound degrades,
  correctness does not.
* **shared_ro pages** (enc-dec) — the encoder output (each decoder
  layer's cross K/V) depends only on the audio, so it is keyed by the
  frames' blake2b digest in the prefix cache and published once into a
  read-only page of the encoder pool (``enc_pool``).  A later request
  over the same frames takes a reference and prefills the decoder alone
  (no encoder launch); the packed row's column 4 names each row's page,
  which the decode gathers.  The last owner's release parks the page in
  the prefix LRU, as a KV prefix page is parked: a later hit revives it,
  a dry allocator evicts it (it is never moved to the host tier: it can
  be encoded again).  A preemption carries the page to the requeued
  request, so a resume encodes nothing.
* **forks** — a best-of-n request copies its live row to each sibling's
  row (``state_copy_row``) and shares the checkpoint page (and the
  encoder page) by refcount; a sibling's first boundary checkpoint takes
  a private page instead of overwriting the shared one.
* **the host tier** (``host_pages > 0``) — a preemption also snapshots
  the victim's LIVE row (not its up-to-page_size-stale checkpoint) into
  a pinned host entry with its blake2b digest, staged through a state
  page; re-admission restores it verified at the exact preemption point
  and replays nothing.  A refused or failed swap-in falls back to the
  checkpoint replay; a corrupt one quarantines only its owner.

Scope: a prompt must fit ``max_len`` (one exact-length prefill launch,
no chunked prefill).  The encodes, prefills and replays run eagerly; the
decode tick is a CUDA graph replay on the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.engine import (
    PagedEngine,
    PagePoolExhaustedError,
    PromptTooLongError,
    _host_row_stats,
    _row_stats,
)
from repro_torch.serving.generate import Request
from repro_torch.serving.graphs import DecodeGraphs
from repro_torch.serving.pages import (
    KIND_SHARED_RO,
    KIND_STATE,
    NULL_PAGE,
    PageCorruptionError,
    PagePool,
    state_batch_axes,
    state_checkpoint_rows,
    state_copy_row,
    state_insert_row,
    state_page_fetch,
    state_page_insert,
    state_pool_init,
    state_restore_row,
)

STATE_STAT_KEYS = ("state_checkpoints", "state_restores", "replay_tokens", "ckpt_skips",
                   "encoder_launches")


def fused_state_decode(decode_fn, params, live, spool, axes, packed, chain_tok, ckpt: bool,
                       enc_pool=None):
    """The state layout's decode tick in one launch (the reference's
    ``_make_fused_state_decode``): the consumed token (the host's where
    ``use_host`` is 1, else the previous launch's ``chain_tok``), the
    per-row decode over the live tree (in place; with ``enc_pool``, each
    row cross-attending to its encoder page), each row's greedy token,
    finite mask and margin, and with ``ckpt`` the scatter of the UPDATED
    rows into their checkpoint pages.  ``packed`` (B, 5) int32: next
    token, ``use_host``, position, checkpoint page (``NULL_PAGE``: none),
    encoder page (``NULL_PAGE``: none, or an idle row)."""
    tok = torch.where(packed[:, 1] == 1, packed[:, 0], chain_tok)
    shared = None if enc_pool is None else (enc_pool, packed[:, 4])
    logits, _ = decode_fn(params, live, tok[:, None], packed[:, 2], shared)
    if ckpt:
        state_checkpoint_rows(spool, live, axes, packed[:, 3])
    return (logits, *_row_stats(logits))


@dataclasses.dataclass
class _StateSlot:
    req: Optional[Request] = None
    pos: int = 0  # tokens the row's state covers
    admit_seq: int = 0
    ckpt_page: Optional[int] = None  # its state page (None: alloc-starved)
    ckpt_pos: int = 0  # tokens the checkpoint covers
    enc_page: Optional[int] = None  # its shared_ro encoder page (enc-dec)
    # the shared ``_admit`` / fork read it; admission here is one launch, so
    # no slot is ever held for a fork's siblings (a class constant, no field)
    reserved_by = None


class StatePagedEngine(PagedEngine):
    """Continuous batching for state-checkpoint families over typed pages:
    PagedEngine's layout-independent core (submit, the lifecycle guard,
    shedding, degraded mode, the pipelined sync loop, quarantine, health,
    telemetry) over a live cache tree and ``state`` pages instead of block
    tables."""

    PAGE_LAYOUT = "state"
    HOST_SWAP_KIND = KIND_STATE

    def __init__(self, api, params, n_slots: int, max_len: int, page_size: int = 16,
                 eos_id: int = -1, prefix_caching: bool = True, profile_sync: bool = False,
                 pipeline_depth: int = 1, cuda_graphs: Optional[bool] = None, device="cuda",
                 fault_injector=None, strict: bool = False, nan_guard: bool = True,
                 audit_every: int = 0, max_queue: Optional[int] = None, shed_stuck: bool = True,
                 degrade_after: Optional[int] = None, recover_after: int = 16,
                 host_pages: int = 0, telemetry=None):
        """The KV engine's arguments less those of block tables (the page
        count, the watermark, chunked prefill, the degraded mode's prefix
        target, the recompression ladder); ``prefix_caching`` registers an
        enc-dec model's encoder pages for later requests over the same
        frames.  The pool holds the null page, a checkpoint page and a fork
        sibling's private page per slot (and an encoder page per slot for
        enc-dec), and 4 more; the admission watermark is 0: a tick never
        needs a page (a checkpoint that cannot allocate is skipped)."""
        spec = getattr(api, "page_spec", None)
        if spec is None or spec.layout != "state_checkpoint":
            from repro_torch.models.zoo import UnsupportedModelError

            cfg = getattr(api, "cfg", None)
            raise UnsupportedModelError(
                getattr(cfg, "name", "?"), getattr(cfg, "family", "?"),
                reason="StatePagedEngine serves state_checkpoint layouts; kv_paged families "
                       "serve through serving.engine.PagedEngine.")
        if getattr(api.rt, "quant_probe", None) is not None:
            raise ValueError("the state-checkpoint families have no quant-probe sites")
        self._init_shared(api, params, n_slots, max_len, page_size, eos_id, prefix_caching,
                          profile_sync, pipeline_depth, cuda_graphs, device, fault_injector,
                          strict, nan_guard, audit_every, max_queue, shed_stuck, degrade_after,
                          recover_after, 0, host_pages, telemetry)
        self.spec = spec
        self.shared_enc = bool(spec.shared_encoder)
        self.watermark = 0
        n_pages = 1 + (3 if self.shared_enc else 2) * n_slots + 4
        self.pool_mgr = PagePool(n_pages)
        self.slots = [_StateSlot() for _ in range(n_slots)]
        init = api.live_cache_init
        self.live = init(n_slots, max_len, device=self.device)
        self.axes = state_batch_axes(lambda b: init(b, max_len, device="meta"))
        self.spool = state_pool_init(lambda b: init(b, max_len, device=self.device), self.axes,
                                     n_pages)
        # the shared_ro encoder pages (enc-dec), written in place
        self.enc_pool = api.enc_pool_init(n_pages) if self.shared_enc else None
        self._packed = np.zeros((n_slots, 5), np.int32)
        # this tick's checkpoint page per slot (``NULL_PAGE``: none), which
        # ``step`` fills and ``_pack_decode`` reads
        self._dsts = np.full((n_slots,), NULL_PAGE, np.int32)
        reg = self.telemetry.registry
        self._cs = {k: reg.counter(k) for k in STATE_STAT_KEYS}
        if self._use_graphs:
            self._graphs = DecodeGraphs(self._decode_step, self._chain_tok, self._count_capture)

    # ------------------------------------------------------ layout hooks
    def _seq_capacity(self) -> int:
        return self.max_len

    def _fetch_page_arrays(self, pid: int) -> list:
        return state_page_fetch(self.spool, self.axes, pid)

    def _insert_page_arrays(self, pid: int, entry) -> None:
        state_page_insert(self.spool, self.axes, entry.arrays, pid, flat=entry.flat)

    def _free_slot(self, i: int):
        """Release slot i's checkpoint and encoder page references (an
        encoder page's last one parks it).  Its live row is left as it is
        (the reference's idle rows keep theirs)."""
        s = self.slots[i]
        for pid in (s.ckpt_page, s.enc_page):
            if pid is not None:
                self._drop_page(pid)
        self.slots[i] = _StateSlot()
        self._chained[i] = False  # any in-flight row of slot i is now dead

    def _fork_shared_pages(self, i: int) -> list:
        s = self.slots[i]
        return [pid for pid in (s.ckpt_page, s.enc_page) if pid is not None]

    def _fork_sibling(self, i: int, j: int, child: Request, shared: list) -> None:
        """Slot j becomes fork sibling ``child`` of slot i: a copy of row i
        of the live tree and a reference on its checkpoint page and its
        encoder page (no state recompute, no page copy, no encode)."""
        state_copy_row(self.live, self.axes, i, j)
        for pid in shared:
            self.pool_mgr.ref(pid)
        s = self.slots[i]
        self.slots[j] = _StateSlot(req=child, pos=s.pos, admit_seq=self._admit_counter,
                                   ckpt_page=s.ckpt_page, ckpt_pos=s.ckpt_pos,
                                   enc_page=s.enc_page)

    def _checkpoint_row(self, i: int, pid: int) -> None:
        """Scatter live row i into state page ``pid`` (every other row to the
        null page), outside a decode launch."""
        dsts = np.full((self.n_slots,), NULL_PAGE, np.int32)
        dsts[i] = pid
        state_checkpoint_rows(self.spool, self.live, self.axes, self._to_device(dsts))

    # --------------------------------------------------------- preemption
    def _preempt_one(self, exclude: Optional[int]) -> Optional[int]:
        """The KV engine's preemption after draining the launches in flight:
        the requeued prompt folds every launched token in, and a
        checkpoint never covers a token the prompt lacks."""
        if self._inflight:
            self.drain()
        return super()._preempt_one(exclude)

    def _host_carry_state(self, i: int, resumed: Request) -> bool:
        """Snapshot victim slot i's LIVE row to a pinned host-tier entry,
        staged through a state page: re-admission restores the exact
        preemption-point state and replays nothing.  A refusal (no tier, a
        forking victim, the ``swap_out`` seam, a tier full of carries, no
        page to stage through) returns False; the checkpoint carry still
        bounds the replay."""
        tier, slot = self.host_tier, self.slots[i]
        if (tier is None or slot.pos <= 0 or resumed.n_samples > 1
                or slot.pos != len(resumed.prompt) - 1):
            return False
        if self.faults is not None and self.faults.swap_out_fails(self._tick, key=int(resumed.rid)):
            self._cs_swap["swap_skips"].inc()
            return False
        while tier.full():
            ev = tier.evict_lru()
            if ev is None:
                self._cs_swap["swap_skips"].inc()
                return False  # every entry a carry
            self.prefix.host_forget(ev[0])
        # a private checkpoint page is overwritten in place (its ckpt_pos
        # advances with it); a fork-shared one must survive for the
        # siblings, so the row goes through a page of its own
        if slot.ckpt_page is not None and self.pool_mgr.refcount[slot.ckpt_page] == 1:
            stage, transient = slot.ckpt_page, False
        else:
            stage = self._alloc_page(KIND_STATE)
            if stage is None:
                self._cs_swap["swap_skips"].inc()
                return False
            transient = True
        self._checkpoint_row(i, stage)
        if not transient:
            slot.ckpt_pos = slot.pos
        arrays = self._fetch_page_arrays(stage)
        if transient:
            self._drop_page(stage)
        handle = tier.put(arrays, KIND_STATE, pinned=True, meta={"rid": int(resumed.rid)})
        resumed._host_state_resume = (handle, slot.pos)
        self._cs_swap["swap_outs"].inc()
        self._cs_swap["swap_bytes"].inc(tier.entries[handle].nbytes)
        self.telemetry.instant("swap_out_preempt", rid=int(resumed.rid), pages=1)
        return True

    def _carry_resume_state(self, i: int, resumed: Request) -> None:
        """Move victim slot i's checkpoint and encoder page references onto
        the requeued request before the teardown drops them (re-admission
        then replays at most page_size tokens and encodes nothing), after
        the host tier's snapshot of its live row (re-admission then
        replays none; the checkpoint stays the fallback of a refused
        swap-in)."""
        self._host_carry_state(i, resumed)
        slot = self.slots[i]
        if slot.ckpt_page is not None:
            resumed._state_resume = (slot.ckpt_page, slot.ckpt_pos)
            slot.ckpt_page = None  # the reference travels with the queued request
        if slot.enc_page is not None:
            resumed._enc_page = slot.enc_page
            slot.enc_page = None

    def _drop_host_state_handle(self, req: Request) -> None:
        if req._host_state_resume is not None:
            if self.host_tier is not None:
                self.host_tier.drop(req._host_state_resume[0])
            req._host_state_resume = None

    def _release_carried(self, req: Request) -> None:
        """Drop what a queued request carries: its host snapshot, its
        checkpoint and its encoder page references."""
        self._drop_host_state_handle(req)
        if req._state_resume is not None:
            self._drop_page(int(req._state_resume[0]))
            req._state_resume = None
        if req._enc_page is not None:
            self._drop_page(int(req._enc_page))
            req._enc_page = None

    # ------------------------------------------------------ encoder pages
    @staticmethod
    def _frames_hash(req: Request) -> bytes:
        """blake2b (16-byte digest) of the frames' shape as little-endian
        int64, then their float32 bytes: the reference's key, memoized on
        the request."""
        if req._frames_digest is None:
            f = np.ascontiguousarray(np.asarray(req.frames, np.float32))
            d = hashlib.blake2b(digest_size=16)
            d.update(np.asarray(f.shape, "<i8").tobytes())
            d.update(f.tobytes())
            req._frames_digest = d.digest()
        return req._frames_digest

    def _claim_enc_page(self, req: Request, acquired: list) -> int:
        """The request's shared_ro encoder page: the one a preemption
        carried, a registered page of its frames (a hit: a reference, or a
        parked page revived — no encoder launch), or on a miss a fresh page
        the encode publishes into (registered for later requests with
        prefix caching on).  A hit the ``prefix_claim`` seam drops encodes
        again.  Appends each reference taken to ``acquired``, for the
        caller's rollback."""
        if req._enc_page is not None:
            pid, req._enc_page = int(req._enc_page), None  # the slot owns it now
            acquired.append(pid)
            return pid
        h = self._frames_hash(req)
        pid = self.prefix.peek(h)
        if (pid is not None and self.faults is not None
                and self.faults.drop_prefix_claim(self._tick, key=int(req.rid))):
            pid = None  # an injected racing eviction: encode again
        if pid is not None:
            self.prefix.lookup(h)
            if self.pool_mgr.refcount[pid] == 0:
                self.pool_mgr.revive(pid, KIND_SHARED_RO)
            else:
                self.pool_mgr.ref(pid)
            acquired.append(pid)
            self._c["prefix_hits"].inc()
            # the encoder work skipped: every frame
            self._c["prefill_tokens_skipped"].inc(int(np.shape(req.frames)[0]))
            return pid
        pid = self._alloc_page(KIND_SHARED_RO)
        if pid is None:
            raise PagePoolExhaustedError("allocator dry claiming a shared_ro encoder page")
        acquired.append(pid)
        frames = torch.from_numpy(np.asarray(req.frames, np.float32))[None].to(self.device)
        self.api.enc_store_fn(self.enc_pool, self.api.encode_xkv_fn(self.params, frames), pid)
        self._cs["encoder_launches"].inc()
        self._c["prefix_misses"].inc()
        if self.prefix_caching:
            self.prefix.register(h, pid)
        return pid

    # ----------------------------------------------------------- admission
    def _try_resume_from_host_state(self, req: Request, slot_idx: int, hsr: tuple):
        """Re-admit a preemption victim from its host snapshot: one verified
        restore at the exact preemption position, no replay.  True
        (admitted), False (waits for a page; the entry stays pinned), or
        None (fell back, the handle dropped: the carried checkpoint, if
        any, still bounds the replay)."""
        handle, pos = hsr
        tier, plen = self.host_tier, len(req.prompt)
        if (tier is None or not tier.has(handle)
                # the recompute path raises the typed too-long error
                or plen >= self.max_len or pos != plen - 1
                # the encoder carry lost: admission claims a page again
                or (self.shared_enc and req._enc_page is None)):
            self._drop_host_state_handle(req)
            return None
        if self.faults is not None and self.faults.swap_in_fails(self._tick, key=int(req.rid)):
            self._cs_swap["swap_skips"].inc()
            self._drop_host_state_handle(req)
            return None
        if self._available_pages() < 1 + self.watermark:
            return False
        pid = self._alloc_page(KIND_STATE)
        if pid is None:  # an allocation flake: nothing consumed, the replay stays exact
            self._cs_swap["swap_skips"].inc()
            self._drop_host_state_handle(req)
            return None
        if self.faults is not None and self.faults.swap_corrupts(self._tick, key=int(req.rid)):
            tier.corrupt(handle)
        self._cs_swap["swap_ins"].inc()
        try:
            entry = tier.take(handle, expect_kind=KIND_STATE)
        except PageCorruptionError:
            self._drop_page(pid)  # fresh, nothing restored
            req._host_state_resume = None  # take consumed the entry
            self._cs_swap["corrupt_swapins"].inc()
            self.telemetry.instant("swap_corrupt", rid=int(req.rid))
            self._release_carried(req)
            raise  # _admit quarantines only this request
        self._cs_swap["verified_swapins"].inc()
        self._cs_swap["swap_bytes"].inc(entry.nbytes)
        req._host_state_resume = None
        self._insert_page_arrays(pid, entry)
        state_restore_row(self.live, self.spool, self.axes, slot_idx, pid)
        self._cs["state_restores"].inc()
        # the restored page is a checkpoint at ``pos``: the carried one is moot
        if req._state_resume is not None:
            self._drop_page(int(req._state_resume[0]))
            req._state_resume = None
        enc_page, req._enc_page = req._enc_page, None  # the slot owns it now
        self.telemetry.on_admit(req, time.perf_counter())
        self.slots[slot_idx] = _StateSlot(req=req, pos=pos, admit_seq=self._admit_counter,
                                          ckpt_page=pid, ckpt_pos=pos, enc_page=enc_page)
        self._admit_counter += 1
        # the row covers ``pos`` tokens; the next launch consumes the
        # resumed prompt's last one
        self._next_tok[slot_idx] = int(req.prompt[-1])
        self._chained[slot_idx] = False
        req._progress_tick = self._tick
        self.telemetry.instant("swap_resume", rid=int(req.rid), pages=1, pos=int(pos))
        self._finish_if_budget_spent(slot_idx)
        return True

    def _replay(self, pid: int, cpos: int, prompt: np.ndarray, enc_page=None):
        """Restore checkpoint page ``pid`` into a batch-1 tree and run the
        prompt's tokens from ``cpos`` on through the per-row decode, one at
        a time (cross-attending to encoder page ``enc_page``, enc-dec).
        Returns (the last logits, the tree)."""
        one = self.api.live_cache_init(1, self.max_len, device=self.device)
        state_restore_row(one, self.spool, self.axes, 0, pid)
        shared = None
        if self.shared_enc:
            shared = (self.enc_pool, torch.full((1,), enc_page, dtype=torch.int32,
                                                device=self.device))
        logits = None
        for k in range(cpos, len(prompt)):
            tok = torch.from_numpy(prompt[k:k + 1].astype(np.int32))[None].to(self.device)
            pos = torch.full((1,), k, dtype=torch.int32, device=self.device)
            logits, one = self.api.state_decode_fn(self.params, one, tok, pos, shared)
        if logits is None:
            raise RuntimeError(f"a checkpoint at {cpos} tokens for a {len(prompt)}-token prompt")
        return logits, one

    def _try_admit(self, req: Request, slot_idx: int) -> bool:
        """Admit into slot i: a host snapshot restored (no replay), or a
        carried checkpoint restored and the tokens past it replayed, or
        one exact-length prefill launch and the admission checkpoint.  An
        enc-dec request first claims its encoder page (``_claim_enc_page``),
        and its prefill is the decoder's alone, against that page."""
        if req._host_state_resume is not None:
            res = self._try_resume_from_host_state(req, slot_idx, req._host_state_resume)
            if res is not None:
                return res
        prompt = np.asarray(req.prompt, np.int64)
        plen = len(prompt)
        if plen >= self.max_len:
            raise PromptTooLongError(self._too_long_msg(plen))
        resume = req._state_resume
        need = 0 if resume is not None else 1  # the admission checkpoint
        if self.shared_enc and req._enc_page is None:
            if req.frames is None:
                raise ValueError(f"request {req.rid}: a shared-encoder family needs "
                                 "Request.frames")
            if self.prefix.peek(self._frames_hash(req)) is None:
                need += 1  # the encoder page of a miss
        if self._available_pages() < need + self.watermark:
            return False  # admission control: the pages wait

        acquired: list[int] = []
        try:
            enc_page = self._claim_enc_page(req, acquired) if self.shared_enc else None
            if self.faults is not None:
                self.faults.delay_launch(self._tick, key=0)
            t0 = time.perf_counter()
            self.telemetry.on_admit(req, t0)
            if resume is not None:
                pid, cpos = int(resume[0]), int(resume[1])
                self._cs["state_restores"].inc()
                logits, one = self._replay(pid, cpos, prompt, enc_page)
                n_run = plen - cpos
                self._cs["replay_tokens"].inc(n_run)
                ckpt_page, ckpt_pos = pid, cpos
                req._state_resume = None  # the slot owns the reference now
                acquired.append(pid)
            else:
                tokens = torch.from_numpy(prompt.astype(np.int32))[None].to(self.device)
                if self.shared_enc:  # the decoder against the page's cross K/V
                    xkv = tuple(leaf[enc_page][:, None] for leaf in self.enc_pool)
                    logits, caches = self.api.prefill_with_xkv_fn(
                        self.params, {"tokens": tokens}, self.max_len, xkv)
                    one = {"self": caches}
                else:
                    logits, one = self.api.prefill_fn(self.params, {"tokens": tokens},
                                                      self.max_len)
                n_run = plen
                ckpt_page, ckpt_pos = None, 0
            nxt, fin, margin = _host_row_stats(logits)
            self._c_syncs.inc()
            t1 = time.perf_counter()
            self._c["t_prefill_s"].inc(t1 - t0)
            self._c["prefill_launches"].inc()
            self._c["prefill_tokens"].inc(n_run)
            self.telemetry.prefill_launch(t0, t1, slots=1, tokens=n_run)
            self.telemetry.on_chunk(req, t0, t1, n_run)
            launch = self._next_launch()
            state_insert_row(self.live, one, self.axes, slot_idx)
            if ckpt_page is None:
                # the admission checkpoint bounds the replay of a preemption
                # before the first page boundary; a dry allocator skips it
                ckpt_page = self._alloc_page(KIND_STATE)
                if ckpt_page is not None:
                    acquired.append(ckpt_page)
                    self._checkpoint_row(slot_idx, ckpt_page)
                    self._cs["state_checkpoints"].inc()
                    ckpt_pos = plen
                else:
                    self._cs["ckpt_skips"].inc()
        except BaseException:
            for pid in acquired:
                self._drop_page(pid)
            raise

        self.slots[slot_idx] = _StateSlot(req=req, pos=plen, admit_seq=self._admit_counter,
                                          ckpt_page=ckpt_page, ckpt_pos=ckpt_pos,
                                          enc_page=enc_page)
        self._admit_counter += 1
        try:
            self._start_decode(slot_idx, logits[0, -1], int(nxt[0]), bool(fin[0]), float(margin[0]),
                               launch)
        except Exception as exc:  # admitted: the slot is torn down, not rolled back
            if self.strict:
                raise
            self._quarantine(slot_idx, exc)
        return True

    # --------------------------------------------------------- checkpoints
    def _ensure_private_ckpt(self, i: int) -> int:
        """Slot i checkpoints in this tick's launch: the page it writes, its
        own (a fork-shared page must not be overwritten: the siblings
        restore from it), or ``NULL_PAGE`` to skip when none can be had."""
        s = self.slots[i]
        if s.ckpt_page is not None and self.pool_mgr.refcount[s.ckpt_page] == 1:
            pid = s.ckpt_page
        else:
            pid = self._alloc_page(KIND_STATE)
            if pid is None:
                self._cs["ckpt_skips"].inc()
                return NULL_PAGE
            if s.ckpt_page is not None:
                self._drop_page(s.ckpt_page)  # shared: the siblings keep it
            s.ckpt_page = pid
        s.ckpt_pos = s.pos + 1  # the launch consumes token ``pos`` first
        self._cs["state_checkpoints"].inc()
        return pid

    # --------------------------------------------------------------- ticks
    def _decode_step(self, ckpt: bool, packed: torch.Tensor, chain_tok: torch.Tensor):
        """``fused_state_decode`` on this engine's model, live tree and state
        pool (what a graph captures; bucket ``ckpt`` is the variant)."""
        return fused_state_decode(self.api.state_decode_fn, self.params, self.live, self.spool,
                                  self.axes, packed, chain_tok, ckpt, self.enc_pool)

    def _pack_decode(self, active: list):
        """The packed (n_slots, 5) row — next token, ``use_host``, position,
        checkpoint page (``self._dsts``), encoder page — and its bucket key,
        whether any row checkpoints.  An idle row decodes its stale token
        at position 0 with no checkpoint against the null encoder page
        (zeros), as the reference stages it."""
        dsts = self._dsts
        pk = self._packed
        pk[:, 0] = self._next_tok
        pk[:, 1] = ~self._chained
        pk[:, 2] = 0
        pk[:, 3] = NULL_PAGE
        pk[:, 4] = NULL_PAGE
        for i in active:
            s = self.slots[i]
            pk[i, 2] = s.pos
            pk[i, 3] = dsts[i]
            if s.enc_page is not None:
                pk[i, 4] = s.enc_page
        return pk, bool((dsts != NULL_PAGE).any())

    def step(self) -> int:
        """Admit, then ONE fused per-row decode launch over the live tree for
        every decoding slot; a row at a page boundary ((pos+1) % page_size
        == 0) rides its checkpoint scatter in the same launch.  The
        pipelining (depth 1 and 2 bit-equal, ``_retire_early``, speculative
        EOS rows, the drain on a tick without decode) is the KV engine's.
        Returns the slots served."""
        self._tick += 1
        self._enforce_lifecycle()
        self._update_pressure()
        admitted = self._admit()
        dsts = self._dsts
        dsts[:] = NULL_PAGE
        active = []
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            if (s.pos + 1) % self.ps == 0:
                dsts[i] = self._ensure_private_ckpt(i)
            active.append(i)
        if active:
            self._quiet = admitted == 0
            t0 = self._launch_decode(active)
            while len(self._inflight) >= self.pipeline_depth:
                self._sync_one(t0 if len(self._inflight) == 1 else None)
            if self._inflight:
                self._retire_early()
        else:
            self.drain()
        if self.audit_every and self._tick % self.audit_every == 0:
            self.audit()
        return len(active)

    def health(self) -> dict:
        h = super().health()
        h["state_counters"] = {k: c.value for k, c in self._cs.items()}
        h["pages_by_kind"] = self.pool_mgr.used_by_kind()
        return h

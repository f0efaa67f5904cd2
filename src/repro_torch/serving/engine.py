"""PagedEngine: continuous batching over a paged, quantized KV pool with
chunked prefill (counterpart of ``repro/serving/engine.PagedEngine`` at
``pipeline_depth=1``, ``chunked_prefill=True``, ``prefix_caching=False``).

Each ``step()``: admit queued requests into free slots (plan only — the
pages a prompt needs, kept above a free-page watermark); advance EVERY
prefilling slot by one ``prefill_chunk`` in ONE ``prefill_from_pages``
launch; then ONE fused decode launch over all ``n_slots`` rows, with the
greedy argmax in the launch.

The launches are staged exactly as the reference stages them, because
the per-tensor activation scale of every W4A4 linear is one reduction
over the whole launch batch — a different batch gives different tokens:

* the decode launch always has ``n_slots`` rows; idle and prefilling rows
  carry their stale last token at length 0 with an all-NULL table, so
  they all write (and read back) null-page slot 0 — resolved last row
  wins (``layers.paged_token_write``);
* the prefill launch pads the batch and chunk axes to powers of two with
  zero rows and columns (``_pow2_bucket``, ``_chunk_bucket``); block
  tables grow by doubling.

Left out (ROADMAP queue A): prefix caching, forking, preemption, the
depth-2 pipelined tick, fault injection, audits, telemetry and the host
tier.  The pool is sized so that preemption never triggers
(``1 + n_slots · max_len/page_size`` pages); where the reference would
preempt, this engine raises ``PagePoolExhaustedError``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models.zoo import resolve_device
from repro_torch.serving.generate import Request, sequence_finished
from repro_torch.serving.pages import NULL_PAGE, PagePool, pages_needed


class PagePoolExhaustedError(RuntimeError):
    """The page pool cannot serve the pending work (the reference would
    preempt a sequence here; the port does not, so it refuses)."""


class NonFiniteLogitsError(RuntimeError):
    """A request's last-position logits came back NaN/Inf."""


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two ≥ n, capped."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _row_stats(logits: torch.Tensor):
    """Greedy token, finiteness and top-1 minus top-2 margin of each row's
    last-position logits, computed in the launch (one host fetch)."""
    row = logits[:, -1, :].float()
    top2 = torch.topk(row, 2, dim=-1).values
    return (
        torch.argmax(row, dim=-1).to(torch.int32),
        torch.isfinite(row).all(dim=-1),
        top2[:, 0] - top2[:, 1],
    )


@dataclasses.dataclass
class _PagedSlot:
    req: Optional[Request] = None
    pos: int = 0  # tokens currently in cache (next write position)
    mode: str = "decode"  # 'decode' | 'prefill'
    pending: Optional[np.ndarray] = None  # full prompt while prefilling


class PagedEngine:
    """Fixed-slot continuous batching over a shared paged KV pool."""

    def __init__(self, api, params, n_slots: int, max_len: int, page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 16, device="cuda"):
        self.device = resolve_device(device)
        if api.device != self.device:
            raise ValueError(f"model built for {api.device}, engine asked for {self.device}")
        if max_len % page_size or prefill_chunk % page_size:
            raise ValueError("page_size must divide max_len and prefill_chunk")
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.ps = page_size
        self.prefill_chunk = prefill_chunk
        self.maxp = max_len // page_size
        self.watermark = n_slots  # decode headroom kept free at admission
        if n_pages is None:
            n_pages = 1 + n_slots * self.maxp  # null page + worst case
        self.pool_mgr = PagePool(n_pages)
        self.pool = api.pool_init(n_pages, page_size)
        self.slots = [_PagedSlot() for _ in range(n_slots)]
        self.tables = np.full((n_slots, self.maxp), NULL_PAGE, np.int32)
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._next_tok = np.zeros((n_slots,), np.int32)
        self._launches = 0  # prefill + decode launches so far
        # t_prefill_s / t_decode_s: host clock around each launch up to its
        # results (the prefill launch syncs the device for this; the decode
        # launch syncs anyway to fetch its tokens)
        self.stats = {"decode_ticks": 0, "prefill_launches": 0, "prefill_tokens": 0,
                      "t_prefill_s": 0.0, "t_decode_s": 0.0}

    # ------------------------------------------------------------ intake
    def submit(self, req: Request):
        if not req.sampling.greedy:
            raise NotImplementedError("the port serves greedy decoding only")
        self.queue.append(req)

    # ------------------------------------------------------------ pages
    def _alloc_page(self) -> int:
        pid = self.pool_mgr.alloc()
        if pid is None:
            raise PagePoolExhaustedError(
                f"page pool dry ({self.pool_mgr.n_pages} pages); the reference "
                "would preempt here, which the port does not implement"
            )
        return pid

    def _free_slot(self, i: int):
        for pid in self.tables[i]:
            pid = int(pid)
            if pid != NULL_PAGE and self.pool_mgr.deref(pid):
                self.pool_mgr.release(pid)
        self.tables[i] = NULL_PAGE
        self.slots[i] = _PagedSlot()

    def _grow_tables(self, n_seq_pages: int):
        """Widen every block table to ≥ n_seq_pages columns, doubling."""
        width = self.tables.shape[1]
        if n_seq_pages <= width:
            return
        while width < n_seq_pages:
            width *= 2
        self.tables = np.pad(
            self.tables, ((0, 0), (0, width - self.tables.shape[1])),
            constant_values=NULL_PAGE,
        )

    def _seq_capacity(self) -> int:
        return self.tables.shape[1] * self.ps

    # -------------------------------------------------------- admission
    def _admit(self):
        """Plan-only admission: a request takes a free slot in ``prefill``
        mode when the pool can hold its prompt above the watermark."""
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s.req is None]
            if not free:
                break
            req = self.queue[0]
            prompt = np.asarray(req.prompt, np.int64)
            need = pages_needed(len(prompt), self.ps)
            if self.pool_mgr.available() < need + self.watermark:
                break  # head-of-line waits for pages
            self._grow_tables(pages_needed(len(prompt) + req.max_new + 1, self.ps))
            self.queue.popleft()
            self.slots[free[0]] = _PagedSlot(req=req, pos=0, mode="prefill", pending=prompt)

    def _start_decode(self, i: int, tok: int, finite: bool, margin: float, launch: int):
        """The prompt of slot i is done: emit its first token."""
        req = self.slots[i].req
        if not finite:
            raise NonFiniteLogitsError(f"non-finite logits at prefill end (rid={req.rid})")
        req.out.append(tok)
        req.margins.append(margin)
        req.launch_ids.append(launch)
        self._next_tok[i] = tok
        if len(req.out) >= req.max_new + 1:
            req.done = True
            self.finished.append(req)
            self._free_slot(i)

    # --------------------------------------------------- chunked prefill
    def _chunk_bucket(self, c: int) -> int:
        if c >= self.prefill_chunk:
            return self.prefill_chunk
        return _pow2_bucket(c, self.prefill_chunk)

    def _prefill_tick_all(self) -> int:
        """Advance every prefilling slot by one chunk in ONE launch."""
        plans = {}
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.mode != "prefill":
                continue
            start = slot.pos  # page-aligned: chunks are page multiples
            c = min(self.prefill_chunk, len(slot.pending) - start)
            ids = np.full((pages_needed(c, self.ps),), NULL_PAGE, np.int32)
            for k in range(len(ids)):
                ids[k] = self._alloc_page()
                self.tables[i][start // self.ps + k] = ids[k]
            plans[i] = (start, c, ids)
        if not plans:
            return 0
        batch = list(plans)
        c_bucket = self._chunk_bucket(max(plans[i][1] for i in batch))
        n_cp = pages_needed(c_bucket, self.ps)
        bb = _pow2_bucket(len(batch), self.n_slots)
        w = self.tables.shape[1]
        # one staging array → one host→device copy (NULL_PAGE == 0, so the
        # zero fill doubles as id/table padding); padded rows and columns
        # are zeros, exactly as the reference pads them
        packed = np.zeros((bb, c_bucket + 2 + n_cp + w), np.int32)
        for r, i in enumerate(batch):
            start, c, ids = plans[i]
            packed[r, :c] = self.slots[i].pending[start : start + c]
            packed[r, c_bucket] = start
            packed[r, c_bucket + 1 : c_bucket + 1 + len(ids)] = ids
            packed[r, c_bucket + 1 + n_cp] = c
            packed[r, c_bucket + 2 + n_cp :] = self.tables[i]
        t0 = time.perf_counter()
        dev = torch.from_numpy(packed).to(self.device)
        logits, self.pool = self.api.prefill_from_pages_fn(
            self.params, dev[:, :c_bucket], self.pool, dev[:, c_bucket + 2 + n_cp :],
            dev[:, c_bucket], dev[:, c_bucket + 1 : c_bucket + 1 + n_cp],
            chunk_len=dev[:, c_bucket + 1 + n_cp],
        )
        done = [i for i in batch if plans[i][0] + plans[i][1] == len(self.slots[i].pending)]
        if done:
            nxt, fin, margin = (t.cpu().numpy() for t in _row_stats(logits))
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["t_prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_launches"] += 1
        launch, self._launches = self._launches, self._launches + 1
        for r, i in enumerate(batch):
            start, c, _ = plans[i]
            slot = self.slots[i]
            slot.pos = start + c
            self.stats["prefill_tokens"] += c
            if i in done:
                slot.mode, slot.pending = "decode", None
                self._start_decode(i, int(nxt[r]), bool(fin[r]), float(margin[r]), launch)
        return len(batch)

    # ------------------------------------------------------------- ticks
    def _active(self):
        return [i for i, s in enumerate(self.slots) if s.req is not None]

    def _ensure_tail_page(self, i: int):
        """Give slot i's next write position a page."""
        slot = self.slots[i]
        pi = slot.pos // self.ps
        if slot.pos % self.ps == 0 and self.tables[i][pi] == NULL_PAGE:
            self.tables[i][pi] = self._alloc_page()

    def _decode_tick(self, active: list):
        """ONE fused decode launch over all n_slots rows, then book tokens.
        Rows not in ``active`` ride along at length 0 with NULL tables and
        their stale token, exactly as the reference stages them."""
        w = self.tables.shape[1]
        pk = np.zeros((self.n_slots, 2 + w), np.int32)
        pk[:, 0] = self._next_tok
        for i in active:
            pk[i, 1] = self.slots[i].pos
            pk[i, 2:] = self.tables[i]
        t0 = time.perf_counter()
        dev = torch.from_numpy(pk).to(self.device)
        logits, self.pool = self.api.paged_decode_fn(
            self.params, self.pool, dev[:, :1], dev[:, 2:], dev[:, 1]
        )
        nxt, fin, margin = (t.cpu().numpy() for t in _row_stats(logits))
        self.stats["t_decode_s"] += time.perf_counter() - t0
        self.stats["decode_ticks"] += 1
        launch, self._launches = self._launches, self._launches + 1
        cap = self._seq_capacity()
        for i in active:
            slot = self.slots[i]
            req = slot.req
            slot.pos += 1
            if not fin[i]:
                raise NonFiniteLogitsError(f"non-finite decode logits (rid={req.rid}, slot={i})")
            tok = int(nxt[i])
            req.out.append(tok)
            req.margins.append(float(margin[i]))
            req.launch_ids.append(launch)
            if sequence_finished(len(req.out), req.max_new, slot.pos, cap):
                req.done = True
                self.finished.append(req)
                self._free_slot(i)
            else:
                self._next_tok[i] = tok

    def step(self) -> int:
        """Admit, ONE chunk launch for every prefilling slot, ONE decode
        launch for every decoding slot.  Returns the slots served."""
        self._admit()
        served = self._prefill_tick_all()
        active = [i for i, s in enumerate(self.slots) if s.req is not None and s.mode == "decode"]
        for i in active:
            self._ensure_tail_page(i)
        if active:
            self._decode_tick(active)
        return served + len(active)

    def run_to_completion(self, max_ticks: int = 10_000):
        """Tick until the queue and the slots drain.  A head-of-line request
        the pool can never admit raises PagePoolExhaustedError."""
        ticks = 0
        while (self.queue or self._active()) and ticks < max_ticks:
            served = self.step()
            ticks += 1
            if served == 0 and self.queue and not self._active():
                raise PagePoolExhaustedError(
                    f"pool too small to admit a {len(self.queue[0].prompt)}-token prompt "
                    f"(free={self.pool_mgr.available()}, watermark={self.watermark})"
                )
        return self.finished, ticks

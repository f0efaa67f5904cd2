"""Continuous batching over a shared contiguous cache (counterpart of
``repro/launch/batching.py``).

The batcher keeps a fixed decode batch of ``n_slots`` over the model's
contiguous caches (``api.cache_init``, leaves (L, n_slots, max_len, ...));
requests stream in with different prompt and generation lengths.  Each
``step``:

* admits a queued request into every free slot: a prefill of its prompt
  alone (batch 1) over a ``max_len`` cache, copied into the slot's rows;
* decodes every active slot.  The model's contiguous decode takes one
  position for the whole batch, so the slots are grouped by position and
  each group takes one decode launch over ALL slots, keeping the cache
  writes and tokens of the group's rows only (a W4A4 launch's activation
  scale spans every slot's row, as the reference's);
* retires a slot on EOS, on its budget or when its cache is full, and the
  next ``step`` refills it.

Requests with seeded ``SamplingParams`` sample their tokens here too, with
the position-keyed streams of the paged engine.  Forking (``n_samples >
1``) is a paged-engine feature: the contiguous cache shares nothing, so
such a request is refused at submit, as in the reference.  Each token
also gets its ``margins`` and ``launch_ids`` entries (prefill launches and
decode launches share one counter), so two runs can be compared under
``serving.generate.greedy_agreement``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.engine import _host_row_stats
from repro_torch.serving.generate import (  # noqa: F401  (Request re-exported)
    Request,
    RequestError,
    pick_token,
    sequence_finished,
)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0  # absolute position of the next token


class ContinuousBatcher:
    """Fixed-slot continuous batching over a shared stacked contiguous cache."""

    def __init__(self, api, params, n_slots: int, max_len: int, eos_id: int = -1):
        if getattr(api, "cache_init", None) is None:
            raise ValueError(f"family {api.cfg.family!r} has no contiguous KV cache to batch over")
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_id
        self.device = api.device
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.caches = api.cache_init(n_slots, max_len)
        self._next_tok = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        self.finished: list[Request] = []
        self.launches = 0

    # ------------------------------------------------------------ intake
    def submit(self, req: Request):
        if req.n_samples != 1:
            # forking is a paged-engine feature (page sharing by refcount);
            # refuse rather than serve one sample as if it were n
            req.error = RequestError(
                "invalid", f"n_samples={req.n_samples}: sequence forking needs the paged "
                           "engine (serving.engine.PagedEngine)")
            req.done = True
            self.finished.append(req)
            return
        self.queue.append(req)

    def _book(self, slot: _Slot, row, greedy_tok, greedy_margin, pos: int, launch: int) -> int:
        req = slot.req
        tok, margin = pick_token(row, int(greedy_tok), float(greedy_margin), req, pos)
        req.out.append(tok)
        req.margins.append(margin)
        req.launch_ids.append(launch)
        return tok

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot.req is not None or not self.queue:
                continue
            req = self.queue.popleft()
            # the prompt alone over a max_len cache, copied into slot i
            tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                     device=self.device)[None]
            logits, c1 = self.api.prefill_fn(self.params, {"tokens": tokens}, self.max_len)
            for n, big in self.caches.items():
                if big.ndim >= 2 and c1[n].shape[1] == 1:
                    big[:, i:i + 1] = c1[n].to(big.dtype)
            nxt, _, margin = _host_row_stats(logits)
            slot.req, slot.pos = req, len(req.prompt)
            first = self._book(slot, None if req.sampling.greedy else logits[0, -1],
                               nxt[0], margin[0], slot.pos, self.launches)
            self.launches += 1
            self._next_tok[i, 0] = first

    # ------------------------------------------------------------- ticks
    def _active(self):
        return [i for i, s in enumerate(self.slots) if s.req is not None]

    def step(self) -> int:
        """Admit, then one decode launch per position group.  Returns the
        number of active slots."""
        self._admit()
        active = self._active()
        if not active:
            return 0
        by_pos: dict[int, list[int]] = {}
        for i in active:
            by_pos.setdefault(self.slots[i].pos, []).append(i)
        for pos, idxs in sorted(by_pos.items()):
            # the decode writes column ``pos`` of every slot in place: keep
            # the other slots' entries there and put them back after
            others = torch.tensor([i for i in range(self.n_slots) if i not in idxs],
                                  dtype=torch.long, device=self.device)
            kept = {n: leaf[:, others, pos].clone() for n, leaf in self.caches.items()
                    if leaf.ndim >= 3}
            logits, _ = self.api.decode_fn(self.params, self.caches, self._next_tok, pos)
            for n, col in kept.items():
                self.caches[n][:, others, pos] = col
            nxt, _, margin = _host_row_stats(logits)
            launch, self.launches = self.launches, self.launches + 1
            for i in idxs:
                slot = self.slots[i]
                row = None if slot.req.sampling.greedy else logits[i, -1]
                # keyed by the sampled token's absolute index (pos + 1)
                tok = self._book(slot, row, nxt[i], margin[i], slot.pos + 1, launch)
                slot.pos += 1
                if sequence_finished(tok, len(slot.req.out), slot.req.max_new, slot.pos,
                                     self.max_len, self.eos):
                    slot.req.done = True
                    self.finished.append(slot.req)
                    self.slots[i] = _Slot()
                else:
                    self._next_tok[i, 0] = tok
        return len(active)

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or self._active()) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished, ticks

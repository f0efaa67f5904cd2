"""Deterministic synthetic LM data: training batches behind a prefetch
thread, and the held-out evaluation stream.

Counterpart of ``repro/data/pipeline.py`` (``DataConfig``,
``_markov_params``, ``synth_tokens``, ``batch_at``, ``Prefetcher``,
``eval_stream``).  The token source is a Zipf-distributed order-2 Markov
chain with repeating n-gram structure, so a language model has something
learnable and perplexity deltas under quantization mean something.  Every
batch is a pure numpy function of (seed, step, host), so the port's
tokens are byte for byte the reference's, and a resumed job regenerates
exactly the batches it would have seen.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


def _markov_params(vocab: int, seed: int):
    """Fixed random Zipf unigram + sparse bigram boost."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab + 1) ** 1.1
    base /= base.sum()
    perm = rng.permutation(vocab)
    succ = rng.integers(0, vocab, size=(vocab, 4))  # preferred successors
    return base[perm], succ


def synth_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """(host_batch, seq_len+1) int32 tokens for this host at this step."""
    base, succ = _markov_params(cfg.vocab, cfg.seed)
    out = np.empty((cfg.host_batch, cfg.seq_len + 1), np.int32)
    for i in range(cfg.host_batch):
        g = cfg.host_id * cfg.host_batch + i
        rng = np.random.default_rng((cfg.seed, step, g))
        toks = rng.choice(cfg.vocab, size=cfg.seq_len + 1, p=base)
        # with p=.75 follow a preferred successor of the previous token
        follow = rng.random(cfg.seq_len + 1) < 0.75
        pick = rng.integers(0, 4, cfg.seq_len + 1)
        for t in range(1, cfg.seq_len + 1):
            if follow[t]:
                toks[t] = succ[toks[t - 1], pick[t]]
        out[i] = toks
    return out


def batch_at(cfg: DataConfig, step: int, device="cuda") -> dict:
    """{'tokens', 'labels'} (host_batch, seq_len) int64 tensors on
    ``device``: labels are the tokens shifted by one."""
    toks = torch.from_numpy(synth_tokens(cfg, step)).long()
    return {"tokens": toks[:, :-1].contiguous().to(device),
            "labels": toks[:, 1:].contiguous().to(device)}


class Prefetcher:
    """Bounded-queue background producer of training batches: iterating
    yields (step, batch) from ``start_step`` on, a batch holding the
    reference's ``batch_at`` bytes (int32 tokens and labels) as CPU
    tensors (page-locked with ``pin``, so the train loop's copy to the card
    can be asynchronous).
    The consumer moves each batch to its device; ``close`` stops the
    thread."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2, pin: bool = False):
        self.cfg = cfg
        self.pin = pin
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _batch(self, step: int) -> dict:
        toks = torch.from_numpy(synth_tokens(self.cfg, step))
        out = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        return {k: v.pin_memory() for k, v in out.items()} if self.pin else out

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            item = (step, self._batch(step))
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def eval_stream(cfg: DataConfig, n_batches: int, offset: int = 1_000_000,
                device="cuda") -> Iterator[dict]:
    """Held-out batches (a step range disjoint from training's)."""
    for i in range(n_batches):
        yield batch_at(cfg, offset + i, device)

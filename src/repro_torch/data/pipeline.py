"""Deterministic synthetic LM data: the held-out evaluation stream.

Counterpart of ``repro/data/pipeline.py`` (``DataConfig``,
``_markov_params``, ``synth_tokens``, ``batch_at``, ``eval_stream``).  The
token source is a Zipf-distributed order-2 Markov chain with repeating
n-gram structure, so a language model has something learnable and
perplexity deltas under quantization mean something.  Every batch is a
pure numpy function of (seed, step, host), so the port's tokens are byte
for byte the reference's.  The reference's background ``Prefetcher``
(training) is not ported.
"""
from __future__ import annotations

import dataclasses
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


def eval_stream(cfg: DataConfig, n_batches: int, offset: int = 1_000_000,
                device="cuda") -> Iterator[dict]:
    """Held-out batches (a step range disjoint from training's)."""
    for i in range(n_batches):
        yield batch_at(cfg, offset + i, device)

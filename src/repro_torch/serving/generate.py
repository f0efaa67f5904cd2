"""Requests, the greedy stop rule, and the margin rule for comparing two
greedy runs (counterpart of the greedy part of ``repro/serving/generate.py``).

The port serves greedy decoding only; seeded sampling (``jax.random``
keys in the reference) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy.  Only ``temperature == 0`` (exact greedy
    argmax) is served by the port; the engine refuses anything else."""

    temperature: float = 0.0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    """One serving request.  ``out`` collects the generated tokens (the
    prefill's token, then ``max_new`` decode tokens).  For each ``out[i]``
    the engine records ``margins[i]``, the top-1 minus top-2 logit of the
    step that chose it, and ``launch_ids[i]``, the index of the engine
    launch (prefill or decode) that produced it — what the margin rule
    needs to judge a differing token between two runs."""

    rid: int
    prompt: np.ndarray  # (S,) int
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    margins: list = dataclasses.field(default_factory=list)
    launch_ids: list = dataclasses.field(default_factory=list)
    done: bool = False
    sampling: SamplingParams = GREEDY


def sequence_finished(n_out: int, max_new: int, pos: int, max_len: int) -> bool:
    """Stop rule: generation budget (prefill token + max_new decode tokens)
    or cache exhaustion.  (The reference also stops at an EOS id; the port
    serves without one so far.)"""
    return n_out >= max_new + 1 or pos >= max_len - 1


def greedy_agreement(ref: dict, got: dict, tol: float) -> dict:
    """Compare two greedy runs of the same schedule under the margin rule.

    ``ref`` / ``got``: rid → Request (or any object with ``out``,
    ``margins``, ``launch_ids``).  The W4A4 activation scale of every
    linear is one reduction over the whole launch, so once any row's
    token differs, every later launch sees other inputs for ALL rows and
    the runs stop being comparable token by token.  Hence: every token
    produced before the first launch with a difference must be equal; in
    that launch each differing token must be a flip that a logit error of
    at most ``tol`` explains (the two runs' margins sum to at most
    ``2·tol``); later tokens are not compared.  Returns counts and the
    rids that fail."""
    first = float("inf")
    for rid, r in ref.items():
        g = got[rid]
        if r.launch_ids != g.launch_ids:
            return {"equal_tokens": 0, "tie_flips": 0, "failures": [rid], "ok": False,
                    "first_diff_launch": None}
        for a, b, lid in zip(r.out, g.out, r.launch_ids):
            if a != b:
                first = min(first, lid)
                break
    equal = flips = 0
    failures = []
    for rid, r in ref.items():
        g = got[rid]
        for p, lid in enumerate(r.launch_ids):
            if lid > first:
                break
            if r.out[p] == g.out[p]:
                equal += 1
            elif r.margins[p] + g.margins[p] <= 2 * tol:
                flips += 1
            else:
                failures.append(rid)
    return {"equal_tokens": equal, "tie_flips": flips, "failures": failures,
            "ok": not failures, "first_diff_launch": None if first == float("inf") else first}

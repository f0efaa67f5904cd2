"""Requests, the stop rule, seeded sampling, the contiguous greedy loop,
and the margin rule for comparing two runs (counterpart of
``repro/serving/generate.py``).

**Sampling determinism** (``SamplingParams`` + ``sample_row``): the key of
a sampled token depends only on ``(seed, sample_idx, absolute
position)`` — the number of tokens (prompt + generated) before it — never
on the batch, the slot or the tick.  So a sampled stream is the same
whether its row decodes alone or with others, and a request that is
preempted and recomputed resamples each position with the key that drew
it the first time.  The generator is the reference's own threefry2x32
(``serving/prng.py``), so the port's sampled tokens can be held to the
reference's token for token.  ``temperature == 0`` takes the argmax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.zoo import resolve_device
from repro_torch.serving import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy (frozen: forked siblings share it).
    ``temperature == 0`` is exact greedy argmax; ``top_k == 0`` samples
    the whole vocabulary."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


class RequestError(str):
    """Typed terminal error of a Request: a ``str`` (the message) with a
    ``kind``:

    * ``"invalid"``     — rejected at submit (``n_samples`` outside
                          [1, n_slots]);
    * ``"too_long"``    — the slab prefill cannot hold the prompt;
    * ``"cancelled"``   — ``Request.cancel()`` honoured by the engine;
    * ``"expired"``     — ``deadline_s`` exceeded, or no token for more
                          than ``max_output_stall_ticks`` ticks;
    * ``"shed"``        — dropped by load shedding (a full admission
                          queue, a head-of-line request the pool can never
                          admit, or a fork refused in degraded mode);
    * ``"quarantined"`` — a fault (non-finite logits, a raising sampler, a
                          failing admission) contained to this request."""

    __slots__ = ("kind",)

    def __new__(cls, kind: str, msg: str):
        obj = super().__new__(cls, msg)
        obj.kind = kind
        return obj

    def __repr__(self):
        return f"RequestError({self.kind!r}, {str(self)!r})"


@dataclasses.dataclass
class Request:
    """One serving request.  ``out`` collects the generated tokens (the
    prefill's token, then up to ``max_new`` decode tokens).  For each
    ``out[i]`` the engine records ``launch_ids[i]``, the engine launch
    (prefill or decode) that produced it, and ``margins[i]``, how far the
    logits would have to move to change it: the top-1 minus top-2 logit
    for a greedy token, the smallest logit change that could alter the
    draw for a sampled one (``sample_row``) — what the margin rule needs
    to judge a differing token between two runs.

    ``n_samples > 1`` asks the engine to fork the request after its
    prefill into that many siblings sharing every prompt page; each is
    finished as its own Request with this ``rid`` and its own
    ``sample_idx``, the submitted object being sibling 0.  ``error`` marks
    a request the engine finished without serving it.

    **Lifecycle guard.**  ``deadline_s`` bounds the time from the ORIGINAL
    submit to the finish on the monotonic ``time.perf_counter`` clock; the
    anchor is stamped once at ``submit()`` and carried through every
    preemption, so a resumed request spends the same budget.
    ``max_output_stall_ticks`` bounds the engine ticks without a token
    from this request.  ``cancel()`` asks for a teardown at the next tick
    boundary.  A request over either bound, or cancelled, is torn down
    wherever it is (queued, prefilling, decoding) and finished with a
    typed error."""

    rid: int
    prompt: np.ndarray  # (S,) int
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    margins: list = dataclasses.field(default_factory=list)
    launch_ids: list = dataclasses.field(default_factory=list)
    done: bool = False
    sampling: SamplingParams = GREEDY
    n_samples: int = 1
    sample_idx: int = 0
    error: Optional[RequestError] = None
    # the conditioning of a shared-encoder family (enc-dec): stub frame
    # embeddings (T_enc, D).  The state engine keys its read-only encoder
    # page on their bytes, so requests over the same frames share one
    # encode; forks and preemption carry them as they are
    frames: Optional[np.ndarray] = dataclasses.field(default=None, repr=False, compare=False)
    deadline_s: Optional[float] = None  # None: unbounded
    max_output_stall_ticks: Optional[int] = None
    cancelled: bool = False
    # the telemetry timeline (serving.telemetry.RequestTimeline): attached at
    # submit, carried through preemption (a resumed request keeps its
    # original submit, so TTFT spans the preemption); None at the
    # "counters" level
    timeline: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    # engine-private: (page_size, chunk_hashes(prompt)) — a request held at
    # the admission watermark is re-planned every tick without re-hashing
    _hash_cache: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    # length of the prompt the caller submitted; a preemption folds the
    # output into the prompt, and a second one must append only what was
    # generated since (None: nothing folded yet)
    _orig_plen: Optional[int] = dataclasses.field(default=None, repr=False, compare=False)
    # engine-private: (host-tier handles, cache position) of the pages a
    # preemption carried to host RAM; re-admission streams them back
    _host_resume: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    # engine-private, state layout: (checkpoint page, tokens it covers) a
    # preemption handed over — re-admission restores it and replays the
    # rest — and (host-tier handle, position) of the live row it snapshot
    # to host RAM, which re-admission restores with no replay
    _state_resume: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    _host_state_resume: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                            compare=False)
    # engine-private, shared-encoder families: the shared_ro encoder page a
    # preemption handed over (re-admission takes it, encoding nothing), and
    # the memoized digest of ``frames``
    _enc_page: Optional[int] = dataclasses.field(default=None, repr=False, compare=False)
    _frames_digest: Optional[bytes] = dataclasses.field(default=None, repr=False, compare=False)
    # the Request a preemption requeued this one as (``cancel`` follows it)
    _resumed_as: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    # engine-private lifecycle anchors: the submit time on the monotonic
    # clock (kept through preemption) and the tick of the last token
    _t_submit: Optional[float] = dataclasses.field(default=None, repr=False, compare=False)
    _progress_tick: int = dataclasses.field(default=0, repr=False, compare=False)
    # failed admissions so far (a transient failure is retried three times)
    _admit_retries: int = dataclasses.field(default=0, repr=False, compare=False)

    def cancel(self) -> None:
        """Ask the engine to tear this request down at the next tick
        boundary (every page reference and fork reservation released,
        ``error.kind == "cancelled"``).  Follows the preemption chain, so
        the handle the caller submitted keeps working after a requeue.  A
        request cancelled before ``submit()`` is rejected there."""
        r = self
        while r is not None:
            r.cancelled = True
            r = r._resumed_as


def sequence_finished(tok: int, n_out: int, max_new: int, pos: int, max_len: int,
                      eos_id: int = -1) -> bool:
    """Stop rule: EOS, generation budget (prefill token + max_new decode
    tokens), or cache exhaustion."""
    return tok == eos_id or n_out >= max_new + 1 or pos >= max_len - 1


# -------------------------------------------------------------- sampling
def sampling_key(sp: SamplingParams, sample_idx: int, pos: int, device="cpu") -> torch.Tensor:
    """The key of one token: (sample_idx, position) folded into the seed."""
    return sampling_keys(torch.tensor([[sp.seed, sample_idx, pos]], dtype=torch.int64,
                                      device=device))[0]


def sampling_keys(rows: torch.Tensor) -> torch.Tensor:
    """Batched ``sampling_key``: rows (R, 3) int64 of (seed, sample_idx,
    pos) → keys (R, 2)."""
    return prng.fold_in(prng.fold_in(prng.prng_key(rows[:, 0]), rows[:, 1]), rows[:, 2])


def sample_row(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
               top_k: torch.Tensor, k_max: Optional[int] = None):
    """Seeded temperature / top-k samples of R rows at once (counterpart
    of the reference's ``_sample_row``, batched).

    logits (R, V); keys (R, 2); temperature (R,) f32 — a tensor, so the
    logits are divided, never multiplied by a reciprocal; top_k (R,)
    int64, 0 for the whole vocabulary; ``k_max``, its largest value when
    the caller knows it on the host (else it is fetched).  Values below a
    row's k-th largest are masked to −inf (ties at the k-th survive), and
    the token is ``prng.categorical``'s draw, ``argmax(gumbel + x)``.

    Returns (tokens (R,) int64, margins (R,) f32).  The margin is the
    smallest logit change that could alter the draw, T times the least of:
    the top-1 minus top-2 perturbed score; with top-k, how far the chosen
    token sits above the k-th value, and how far below it sits every
    masked token whose perturbed score would win if it were let in."""
    x = logits.float() / temperature[:, None]
    k = top_k.clamp(max=x.shape[-1])
    k_max = min(int(k.max()) if k_max is None else k_max, x.shape[-1])
    xm = x
    if k_max:
        top = torch.topk(x, k_max, dim=-1).values
        kth = top.gather(-1, (k - 1).clamp(min=0)[:, None])
        kth = torch.where(k[:, None] > 0, kth, torch.full_like(kth, -torch.inf))
        xm = torch.where(x < kth, torch.full_like(x, -torch.inf), x)
    tok, noise = prng.categorical(keys, xm)
    scores = noise + xm
    top2 = torch.topk(scores, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    if k_max:
        inf = torch.full_like(x, torch.inf)
        shut_out = (x < kth) & (noise + x > top2[:, :1])
        margin = torch.minimum(margin, torch.where(shut_out, kth - x, inf).amin(-1))
        chosen = x.gather(-1, tok[:, None])[:, 0] - kth[:, 0]
        margin = torch.minimum(margin, torch.where(k > 0, chosen, inf[:, 0]))
    return tok, margin * temperature


def sample_token(logits_row: torch.Tensor, sp: SamplingParams, sample_idx: int, pos: int):
    """Seeded sample of ONE sequence's next token: (token, margin)."""
    if sp.greedy:
        raise ValueError("greedy requests take the argmax path")
    dev = logits_row.device
    tok, margin = sample_row(
        logits_row[None], sampling_key(sp, sample_idx, pos, dev)[None],
        torch.tensor([sp.temperature], dtype=torch.float32, device=dev),
        torch.tensor([sp.top_k], dtype=torch.int64, device=dev), k_max=sp.top_k,
    )
    return int(tok[0]), float(margin[0])


def pick_token(logits_row, greedy_tok: int, greedy_margin: float, req: Request, pos: int):
    """The token choice of every serving path: the argmax (passed through
    untouched) for a greedy request, a seeded sample otherwise.  Returns
    (token, margin)."""
    if req.sampling.greedy:
        return greedy_tok, greedy_margin
    return sample_token(logits_row, req.sampling, req.sample_idx, pos)


# ------------------------------------------------------ contiguous greedy
def next_greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits → (B,) greedy next token at the last position."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def greedy_generate(api, params, prompts, gen_len: int, max_len: int, device="cuda",
                    batch=None):
    """Batched greedy decoding over contiguous caches: prefill the prompt
    batch (B, S), then ``gen_len - 1`` decode steps.  Returns (B, gen_len)
    int32 tokens.  Runs on ``device`` (the card unless asked for the
    CPU), which must be the one ``api`` was built for.  ``batch``: further
    prefill inputs on ``device`` (a VLM's ``patch_embeds``).

    Each decode step reads only the written prefix of the cache, which no
    bucket of the reference's ``kv_bucket`` exceeds, so the port needs no
    such bound: its tokens are the bucketed and the whole-cache read's."""
    device = resolve_device(device)
    if api.device != device:
        raise ValueError(f"model built for {api.device}, generation asked for {device}")
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(device)
    s = prompts.shape[1]
    logits, caches = api.prefill_fn(params, {"tokens": prompts, **(batch or {})}, max_len)
    out = [next_greedy_tokens(logits)]
    for t in range(gen_len - 1):
        logits, caches = api.decode_fn(params, caches, out[-1][:, None], s + t)
        out.append(next_greedy_tokens(logits))
    return torch.stack(out, 1)


# ------------------------------------------------------------ margin rule
def greedy_agreement(ref: dict, got: dict, tol: float) -> dict:
    """Compare two runs of the same schedule under the margin rule.

    ``ref`` / ``got``: key → Request (or any object with ``out``,
    ``margins``, ``launch_ids``); forked siblings share a rid, so key
    them by ``(rid, sample_idx)``.  The W4A4 activation scale of every
    linear is one reduction over the whole launch, so once any row's
    token differs, every later launch sees other inputs for ALL rows — and
    an EOS, a freed page or a preemption may then change the schedule
    too.  Hence: the two schedules (which launch produced each token)
    must agree up to and including the first launch with a differing
    token; every token produced before that launch must be equal; in that
    launch each differing token must be a flip that a logit error of at
    most ``tol`` explains (the two runs' margins sum to at most
    ``2·tol``); later tokens are not compared.  Returns counts and the
    keys that fail."""
    inf = float("inf")
    first = sched = inf  # first launch with a differing token / schedule
    for key, r in ref.items():
        g = got.get(key)
        if g is None:
            sched = -1
            break
        for p in range(max(len(r.out), len(g.out))):
            if p >= len(r.out) or p >= len(g.out):
                sched = min(sched, (r if p < len(r.out) else g).launch_ids[p])
                break
            if r.launch_ids[p] != g.launch_ids[p]:
                sched = min(sched, r.launch_ids[p], g.launch_ids[p])
                break
            if r.out[p] != g.out[p]:
                first = min(first, r.launch_ids[p])
                break
    if set(got) - set(ref):
        sched = -1
    if sched < inf and sched <= first:
        return {"equal_tokens": 0, "tie_flips": 0, "ok": False, "first_diff_launch": None,
                "failures": ["schedule differs before the first differing token"]}
    equal = flips = 0
    failures = []
    for key, r in ref.items():
        g = got[key]
        for p, lid in enumerate(r.launch_ids):
            if lid > first:
                break
            if r.out[p] == g.out[p]:
                equal += 1
            elif r.margins[p] + g.margins[p] <= 2 * tol:
                flips += 1
            else:
                failures.append(key)
    return {"equal_tokens": equal, "tie_flips": flips, "failures": failures,
            "ok": not failures, "first_diff_launch": None if first == inf else first}

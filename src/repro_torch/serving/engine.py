"""PagedEngine: continuous batching over a paged, quantized KV pool
(counterpart of ``repro/serving/engine.PagedEngine``).

The engine is a layout-independent core (``_init_shared``: the request
lifecycle, containment, telemetry, the host tier, the pipelined tick)
and the KV layout (block tables over ``kv`` pages).  The layout hooks —
``PAGE_LAYOUT``, ``HOST_SWAP_KIND``, ``_alloc_page(kind)``,
``_pack_decode``, ``_fork_shared_pages`` / ``_fork_sibling``,
``_carry_resume_state``, ``_release_carried``, ``_fetch_page_arrays`` /
``_insert_page_arrays``, ``_free_slot``, ``_try_admit`` — are what
``serving/state_engine.StatePagedEngine`` overrides for the
state-checkpoint layout.

Each ``step()``: admit queued requests into free slots; advance EVERY
prefilling slot by one ``prefill_chunk`` in ONE ``prefill_from_pages``
launch; then ONE fused decode launch over all ``n_slots`` rows.

* **Admission.**  ``chunked_prefill=True`` only *plans*: it claims the
  longest chain of prefix-hit pages and marks the slot ``prefill``; the
  chunk ticks then run the rest of the prompt.  ``chunked_prefill=False``
  (the reference's default) runs the whole prompt in one slab
  ``prefill_fn`` over a ``max_len`` contiguous cache and scatters the
  pages that missed the prefix cache into the pool
  (``pages.scatter_prefill_pages``).  Either way the pool must hold the
  prompt above a free-page ``watermark``.
* **Prefix caching** (``prefix_caching=True``): every full prompt page a
  prefill writes is registered under its chain hash (``prefix.py``);
  a later prompt with the same prefix takes a reference instead of
  recomputing it.  A registered page whose last owner finishes is parked,
  and the allocator evicts parked pages least recently parked first.
* **Forking** (``Request(n_samples=n)``): when the prompt is done the slot
  forks into n siblings that share every prompt page by refcount; the
  first token write on the shared tail page copies it
  (``pages.copy_page``, copy-on-write).
* **Preemption by eviction**: when the pool runs dry the youngest slot
  gives back its pages and is requeued at the head of the queue as
  prompt + output, which recomputes it exactly — greedy by argmax,
  sampled because a token's key is (seed, sample_idx, position).
* **Sampling and EOS**: a sampled row's token is drawn on the device and
  overlaid on the launch's greedy vector (``generate.sample_row``, keyed
  at ``pos + 1``); a decoded ``eos_id`` ends a request.

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

**The fused decode launch** (``fused_decode``, the reference's
``_make_fused_decode``): ONE ``(n_slots, 3+W)`` int32 host→device row per
tick — next token, a ``use_host`` flag, the kv length, the block table
(rows of slots not decoding masked to ``NULL_PAGE``) — and in the same
step the token select ``where(use_host, host_tok, chain_tok)``, the
forward, and each row's argmax, finite mask and top-1 − top-2 margin.  A
sampled row's draw is overlaid after it on the same stream
(``_overlay_samples``).  On a CUDA device the step is one CUDA graph per
block-table width (``serving/graphs.py``; ``cuda_graphs=False`` runs it
eagerly); the chunk and slab prefills run eagerly (``trace_counts``).

**The pipelined tick** (``pipeline_depth=2``, the serving CLI's
default): ``step()`` launches tick t, THEN syncs tick t−1, so the host's
bookkeeping for the next tick overlaps the device's work on this one.
What keeps every depth bit-equal to depth 1 (and to ``profile_sync``,
which forces depth 1):

* the consumed token chains launch to launch on the device (the
  ``_chain_tok`` vector; ``_chained[i]`` says slot i's token lives there),
  so no host round trip sits between two decode launches;
* a launch's record (``_InFlight``) keeps its rows as (slot, request,
  position after the launch) and its own copies of the token, finite
  mask and margin; the position advances at launch, the tokens are booked
  at sync with the launch's index and margin, and rows whose slot was
  retired or re-assigned since are skipped (a row launched after an EOS);
* a slot whose in-flight row is certain to retire it — budget or
  capacity, which do not depend on the token (``_retire_pending``) — is
  freed at the end of the step that launched it, exactly when depth 1
  frees it, and its request is finished when that row is synced; so
  admission, page reuse and the idle rows' tokens (which enter every
  linear's per-launch activation scale) follow depth 1's schedule;
* preemption, a tick without a decode launch and ``run_to_completion``'s
  exit drain the in-flight launches first (``drain()``), so a requeued
  prompt and the final outputs hold every launched token.

Only an EOS is speculative: the row launched after it is dropped at
sync.  With ``eos_id`` set, depth 2 may therefore launch rows that depth
1 does not and free the slot a step later, and since a launch's rows
share each linear's activation scale, the launches after an EOS may
differ from depth 1's in tokens as well as in counters and pages.

**Fault containment** (the reference's): one poisoned, expired,
cancelled or shed request ends as a finished request with a typed
``RequestError`` while the tick completes for everyone else.

* *lifecycle guard* — ``Request.deadline_s`` / ``max_output_stall_ticks``
  / ``cancel()`` are enforced at every tick boundary, tearing the request
  down (pages, fork reservations, queue entry) wherever it lives; a slot
  with a launch in flight is drained first, so the teardown sees what
  depth 1 sees;
* *quarantine* — a non-finite row (at prefill end or at a decode sync),
  a raising sampler and a failing admission (after three retries of a
  transient failure) finish only the offending request with
  ``"quarantined"``; ``strict=True`` re-raises, ``nan_guard=False`` reads
  no finite flag at all;
* *audits* — ``audit()`` (``serving/audit.py``), every ``audit_every``
  ticks if asked; ``health()`` sums it all up, the robustness counters
  in ``health()["counters"]`` (``stats`` keeps the reference's pinned
  keys);
* *degradation* — a bounded queue (``max_queue``) sheds the request with
  the least deadline slack; ``degrade_after`` pressured ticks enter a
  degraded mode (forks refused at submit, parked prefix pages shrunk to
  ``degraded_prefix_target``), ``recover_after`` relieved ticks leave it;
  a head-of-line request the pool can never admit is shed
  (``shed_stuck``; False raises ``PagePoolExhaustedError``);
* *fault injection* — a ``serving.faults.FaultInjector`` behind the
  allocator, prefix-claim, launch, logits and sampler seams, keyed as the
  reference keys them.  A decode row's ``logits`` and ``sampler`` faults
  are rolled for the launch's tick: at its sync at depth 1 (the
  reference's order), at its launch deeper, where a row certain to be
  quarantined frees its slot at the end of the step that launched it, as
  ``_retire_early`` does for a budget stop — so depth 2 demotes the same
  requests as depth 1 and stays bit-equal to it.  A real non-finite row
  is known only at sync: deeper, its slot is freed a tick later (with
  W4A4 every row of such a launch is non-finite anyway, since each
  linear's activation scale is one amax over the launch).  The logits
  seam flips the host copy of a row's finite flag; the decode graph does
  not change, and an engine without an injector or audits adds no device
  work to a tick.

**Telemetry** (the reference's, ``serving/telemetry.py``): a
``Telemetry`` (``telemetry=``, ``"default"`` level unless given) holds
the metrics registry — every engine counter, ``stats`` being a read-only
``StatsView`` over the pinned ``ENGINE_STAT_KEYS``, the robustness and
(zero) swap counters, ``device_syncs`` — the TTFT / ITL / queue / launch
histograms, the request timelines and the Chrome-trace journal, fed by
the reference's hooks at the reference's points.  Every timestamp is
taken where the engine already reads the clock or syncs, so the default
level adds no device work and no sync to a tick: ``device_syncs`` counts
one per prefill launch that waits for its results (all of them on the
card, where ``t_prefill_s`` is synced; those that finish a prompt or run
under ``profile_sync`` on the CPU, as the reference) and one per decode
sync, at either level.  ``snapshot()`` dumps it all.  With a
``QuantProbeRecorder`` in ``Runtime.quant_probe`` every launch's probe
rows are fetched with its results and fed to the sink after its sync,
launches in their order, at every depth.

**The host tier** (``host_pages > 0``, the reference's, docs/ROBUSTNESS.md
"Memory tiers"): a bounded host-RAM pool (``pages.HostPageTier``) behind
the prefix LRU and preemption.  An evicted parked prefix page's bytes
move to host RAM under its chain hash, and a later hit streams them back
into a fresh pid; a decoding preemption victim's pages are carried there
(pinned entries) and its re-admission streams them back and rejoins decode
at the carried position, with no prefill.  Every swap-in verifies the
page's digest; a mismatch quarantines only its owner.  Any refusal (the
``swap_out`` / ``swap_in`` seams, a tier full of carries, a dry
allocator) falls back to recompute.  The copies ride the compute stream
(``pages.py``): a swap-out waits for every launch in flight before it
reads the page, a swap-in lands before the next launch reads it, and the
pool is written in place, so a captured decode graph reads the new bytes.
``recompress_after > 0`` arms the cold-page ladder
(``pages.kv_page_recompress``): after that many pressured ticks the
coldest parked pages are requantized one stage down, in place.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ptq import decode_scales
from repro_torch.models.zoo import resolve_device
from repro_torch.serving.audit import AuditReport, audit_engine
from repro_torch.serving.generate import (
    Request,
    RequestError,
    pick_token,
    sample_row,
    sampling_keys,
    sequence_finished,
)
from repro_torch.serving import pages as pages_lib
from repro_torch.serving.pages import (
    NULL_PAGE,
    PagePool,
    copy_page,
    live_pages,
    pages_needed,
    scatter_prefill_pages,
)
from repro_torch.serving.graphs import DecodeGraphs
from repro_torch.serving.prefix import PrefixCache, chunk_hashes
from repro_torch.serving.telemetry import (
    ENGINE_STAT_KEYS,
    ROBUSTNESS_STAT_KEYS,
    SWAP_STAT_KEYS,
    StatsView,
    Telemetry,
)


class PromptTooLongError(ValueError):
    """The slab prefill cannot hold the prompt (plen >= max_len)."""


class PagePoolExhaustedError(RuntimeError):
    """The page pool cannot serve the pending request even with every
    parked prefix page evicted and every other sequence preempted."""


class NonFiniteLogitsError(RuntimeError):
    """A request's last-position logits came back NaN/Inf.  The NaN guard
    quarantines the request; ``strict=True`` re-raises."""


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two ≥ n, capped."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _row_stats(logits: torch.Tensor):
    """Greedy token, finiteness and top-1 minus top-2 margin of each row's
    last-position logits, on the device."""
    row = logits[:, -1, :].float()
    top2 = torch.topk(row, 2, dim=-1).values
    return (
        torch.argmax(row, dim=-1).to(torch.int32),
        torch.isfinite(row).all(dim=-1),
        top2[:, 0] - top2[:, 1],
    )


def _host_row_stats(logits: torch.Tensor):
    """``_row_stats`` on the host in ONE device→host fetch: (greedy token,
    finite flag, margin) numpy vectors."""
    nxt, fin, margin = _row_stats(logits)
    host = torch.stack([nxt, fin.to(torch.int32), margin.view(torch.int32)]).cpu().numpy()
    return host[0], host[1].astype(bool), host[2].view(np.float32)


def fused_decode(decode_fn, params, pool, packed, chain_tok):
    """The decode step with everything the tick needs in one launch
    (a CUDA graph on the card): ``packed`` (B, 3+W) int32 is the next
    host token, the ``use_host`` flag, the kv length and the block table;
    the consumed token is the host's where ``use_host`` is 1, else the
    previous launch's ``chain_tok`` on the device.  Returns (logits,
    greedy token, finite mask, top-1 − top-2 margin) of each row's last
    position; the pool is written in place."""
    tok = torch.where(packed[:, 1] == 1, packed[:, 0], chain_tok)
    logits, _ = decode_fn(params, pool, tok[:, None], packed[:, 3:], packed[:, 2])
    return (logits, *_row_stats(logits))


@dataclasses.dataclass
class _InFlight:
    """One enqueued, not yet synced decode launch.  ``rows`` snapshots
    (slot, request, position after the launch) at launch time; at sync a
    row whose slot holds another request (or none) was speculative and is
    skipped, unless its request was retired early (``_retiring``).
    ``nxt`` / ``fin`` / ``margin`` are the launch's own copies of the
    merged tokens, finite mask and margins (pinned host memory on the card,
    ready once ``ready`` has fired), ``probe`` its quant-probe rows
    (``QuantProbeRecorder.fetch``) or None.  ``faults``: slot → the
    injected fault of its row (rolled at launch deeper than depth 1)."""

    launch: int  # the engine launch index every booked token records
    tick: int  # the engine tick that launched it (fault seams key on it)
    rows: list
    nxt: torch.Tensor
    fin: torch.Tensor
    margin: torch.Tensor
    ready: Optional[object] = None  # torch.cuda.Event, None on the CPU
    probe: Optional[tuple] = None
    faults: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _PagedSlot:
    req: Optional[Request] = None
    pos: int = 0  # tokens currently in cache (next write position)
    admit_seq: int = 0  # admission order: preemption takes the youngest
    mode: str = "decode"  # 'decode' | 'prefill' (chunked admission in flight)
    pending: Optional[np.ndarray] = None  # full prompt while prefilling
    hashes: Optional[list] = None  # full-page chain hashes of ``pending``
    # a free slot held for a forking request's sibling (the parent's slot):
    # chunked admission claims the sibling slots up front, so the fork at
    # the end of the prompt, many ticks later, finds them
    reserved_by: Optional[int] = None


class PagedEngine:
    """Fixed-slot continuous batching over a shared paged KV pool."""

    # the page layout this engine serves (the audit and the telemetry
    # dispatch on it); StatePagedEngine's is "state"
    PAGE_LAYOUT = "kv"

    def __init__(self, api, params, n_slots: int, max_len: int, page_size: int = 16,
                 n_pages: Optional[int] = None, eos_id: int = -1, prefix_caching: bool = True,
                 watermark: Optional[int] = None, chunked_prefill: bool = False,
                 prefill_chunk: int = 16, profile_sync: bool = False, pipeline_depth: int = 1,
                 cuda_graphs: Optional[bool] = None, device="cuda", fault_injector=None,
                 strict: bool = False, nan_guard: bool = True, audit_every: int = 0,
                 max_queue: Optional[int] = None, shed_stuck: bool = True,
                 degrade_after: Optional[int] = None, recover_after: int = 16,
                 degraded_prefix_target: int = 0, host_pages: int = 0,
                 recompress_after: int = 0, telemetry: Optional[Telemetry] = None):
        """``pipeline_depth``: decode launches in flight after a step (1 syncs
        each launch in its own step; ``profile_sync`` forces 1).
        ``cuda_graphs``: the decode step as one CUDA graph per block-table
        width; on by default on a CUDA device, unavailable on the CPU.

        Containment, the reference's arguments and defaults:
        ``fault_injector`` (a ``serving.faults.FaultInjector``, None in
        production); ``strict`` re-raises contained faults and makes
        ``audit()`` raise; ``nan_guard`` quarantines a request whose
        logits are non-finite; ``audit_every`` runs ``audit()`` every N
        ticks; ``max_queue`` bounds the admission queue; ``shed_stuck``
        sheds a head-of-line request the pool can never admit (else
        ``run_to_completion`` raises); ``degrade_after`` /
        ``recover_after`` / ``degraded_prefix_target``: the degraded
        mode's hysteresis (off by default).  ``host_pages > 0``: a host
        tier of that many pages;
        ``recompress_after > 0``: the cold-page ladder after that many
        pressured ticks.  ``telemetry``: the registry, histograms,
        timelines and journal (a default-level ``Telemetry`` if None)."""
        # a model API states its layout (a VLM's is None); a bare stub of
        # the step functions is taken at its word
        if getattr(api, "paged_decode_fn", None) is None or (
                hasattr(api, "page_spec") and getattr(api.page_spec, "layout", None) != "kv_paged"):
            from repro_torch.models.zoo import UnsupportedModelError

            cfg = getattr(api, "cfg", None)
            raise UnsupportedModelError(
                getattr(cfg, "name", "?"), getattr(cfg, "family", "?"),
                reason="This engine serves kv_paged layouts; state-checkpoint families serve "
                       "through serving.state_engine.StatePagedEngine.")
        if chunked_prefill and prefill_chunk % page_size:
            raise ValueError("prefill_chunk must be a page multiple")
        self._init_shared(api, params, n_slots, max_len, page_size, eos_id, prefix_caching,
                          profile_sync, pipeline_depth, cuda_graphs, device, fault_injector,
                          strict, nan_guard, audit_every, max_queue, shed_stuck, degrade_after,
                          recover_after, degraded_prefix_target, host_pages, telemetry)
        self.recompress_after = recompress_after
        self.chunked = chunked_prefill
        self.prefill_chunk = prefill_chunk
        self.maxp = max_len // page_size
        # decode headroom kept free at admission: every active slot may
        # need one fresh page on any upcoming tick
        self.watermark = n_slots if watermark is None else watermark
        if n_pages is None:
            n_pages = 1 + n_slots * self.maxp  # null page + worst case
        self.pool_mgr = PagePool(n_pages)
        self.pool = api.pool_init(n_pages, page_size)
        self.slots = [_PagedSlot() for _ in range(n_slots)]
        self.tables = np.full((n_slots, self.maxp), NULL_PAGE, np.int32)
        self._packed = np.zeros((n_slots, 3 + self.tables.shape[1]), np.int32)
        if self._use_graphs:
            self._graphs = DecodeGraphs(self._decode_step, self._chain_tok, self._count_capture)

    def _init_shared(self, api, params, n_slots, max_len, page_size, eos_id, prefix_caching,
                     profile_sync, pipeline_depth, cuda_graphs, device, fault_injector, strict,
                     nan_guard, audit_every, max_queue, shed_stuck, degrade_after, recover_after,
                     degraded_prefix_target, host_pages, telemetry):
        """The layout-independent engine state (the reference's
        ``_init_shared``): the request lifecycle (queue, finished, the
        lifecycle guard's anchors), the telemetry counters, the containment
        settings, the host tier and the pipelined tick's machinery.  Shared
        by PagedEngine (the kv_paged layout) and StatePagedEngine (the
        state_checkpoint layout); what is layout-specific (the pool, the
        slot records, block tables, the decode graphs) is the concrete
        engine's.  ``_use_graphs`` says whether that engine builds its
        ``DecodeGraphs``."""
        self.device = resolve_device(device)
        if api.device != self.device:
            raise ValueError(f"model built for {api.device}, engine asked for {self.device}")
        if max_len % page_size:
            raise ValueError("page_size must divide max_len")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError("cuda_graphs needs a CUDA device")
        self.api = api
        self.params = decode_scales(params)  # each weight's scales decoded once
        self.n_slots = n_slots
        self.max_len = max_len
        self.ps = page_size
        self.eos = eos_id
        self.prefix_caching = prefix_caching
        # the prefix cache's parking lot: shared code (``_available_pages``,
        # ``_drop_page``, the degraded mode, the audit, the gauges) reads it;
        # a state-layout engine registers nothing in it
        self.prefix = PrefixCache()
        # a state-layout engine keeps these; PagedEngine sets its own
        self.chunked = False
        self.prefill_chunk = 0
        self.recompress_after = 0
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._next_tok = np.zeros((n_slots,), np.int32)
        self._admit_counter = 0
        self._launches = 0  # prefill + decode launches so far
        # the registry's counters; ``stats`` is a read-only view of the
        # pinned keys (peak_pages: the pool's high-water mark).  t_prefill_s:
        # host clock around each prefill launch up to its results (synced on
        # the card); t_decode_s: at depth 1 from a decode launch to its
        # synced results, deeper the launch's dispatch and, apart, the wait
        # at its sync
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        reg = self.telemetry.registry
        self._c = {k: reg.counter(k) for k in ENGINE_STAT_KEYS if k != "peak_pages"}
        self._c["t_prefill_s"].unit = self._c["t_decode_s"].unit = "s"
        self._c_syncs = reg.counter("device_syncs")  # one per wait for the device
        self._cr = {k: reg.counter(k) for k in ROBUSTNESS_STAT_KEYS}
        self._cs_swap = {k: reg.counter(k) for k in SWAP_STAT_KEYS}  # registered either way
        self._cs_swap["swap_bytes"].unit = "bytes"
        self.host_tier = pages_lib.HostPageTier(host_pages) if host_pages else None
        self._rc_pressure = 0  # consecutive pressured ticks (the ladder's clock)
        self._recompress_stage: dict[int, int] = {}  # pid → ladder stage of its bytes
        self.stats = StatsView(self)
        # the quant-error probe's recorder, if the model has one; launches'
        # rows wait in ``_probe_wait`` until every earlier launch was fed
        self._probe = getattr(api.rt, "quant_probe", None)
        self._probe_wait: dict[int, tuple] = {}
        self._probe_next = 0

        self.faults = fault_injector
        self.strict = strict
        self.nan_guard = nan_guard
        self.audit_every = audit_every
        self.max_queue = max_queue
        self.shed_stuck = shed_stuck
        self.degrade_after = degrade_after
        self.recover_after = recover_after
        self.degraded_prefix_target = degraded_prefix_target
        self.degraded = False
        self._tick = 0
        self._pressure_ticks = 0
        self._relief_ticks = 0
        self._last_audit: Optional[AuditReport] = None

        self.profile_sync = profile_sync
        self.pipeline_depth = 1 if profile_sync else pipeline_depth
        self._inflight: deque[_InFlight] = deque()
        self._chain_tok = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._chained = np.zeros((n_slots,), bool)
        # id(request) → launch of its final row, for requests whose slot was
        # freed before that row was synced (``_retire_early``)
        self._retiring: dict[int, int] = {}
        # the decode host gap: launch-to-launch wall clock less the sync
        # waits in between
        self._last_launch_end: Optional[float] = None
        self._gap_sync_s = 0.0
        self._quiet = False  # this step admitted and prefilled nothing
        # two pinned staging rows in turn; each event fires once the copy
        # that read its row has landed
        self._staging = [[None, None], [None, None]] if self.device.type == "cuda" else []
        self._trace_base = dict(api.trace_counts)
        self._graphs = None
        self._use_graphs = bool(cuda_graphs)
        if cuda_graphs and (api.rt.paged_kernel or api.rt.fused_linear):
            from repro_torch.kernels import build

            build.library()  # built and loaded before any capture

    # ------------------------------------------------------------ intake
    def submit(self, req: Request):
        """Queue a request, or finish it at once with a ``RequestError``
        when it cannot be served: ``n_samples`` outside [1, n_slots]
        (``invalid``), a slab prompt of at least ``max_len`` tokens
        (``too_long``), a request cancelled before it came (``cancelled``),
        a fork in degraded mode (``shed``).  A full bounded queue sheds the
        request with the least deadline slack, the newcomer on a tie."""
        now = time.perf_counter()
        if req._t_submit is None:
            req._t_submit = now
        req._progress_tick = self._tick
        kind = msg = None
        if not 1 <= req.n_samples <= self.n_slots:
            kind, msg = "invalid", f"n_samples={req.n_samples} outside [1, n_slots={self.n_slots}]"
        elif not self.chunked and len(req.prompt) >= self.max_len:
            kind, msg = "too_long", self._too_long_msg(len(req.prompt))
        elif req.cancelled:
            kind, msg = "cancelled", "cancelled before admission"
        elif self.degraded and req.n_samples > 1:
            kind, msg = "shed", (f"degraded mode rejects forking requests (n_samples="
                                 f"{req.n_samples}); resubmit with n_samples=1 or retry later")
        if kind is not None:
            self._finish_error(req, kind, msg)
            return
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            victim = self._shed_choice(req, now)
            full = f"admission queue full (max_queue={self.max_queue})"
            if victim is req:
                self._finish_error(req, "shed", full)
                return
            # by identity: ``deque.remove`` compares Requests by value, and
            # two with one rid would compare their numpy prompts
            del self.queue[next(k for k, r in enumerate(self.queue) if r is victim)]
            self._finish_error(victim, "shed", f"{full}; least deadline slack")
        self.telemetry.on_submit(req, now)
        self.queue.append(req)

    def _shed_choice(self, newcomer: Request, now: float) -> Request:
        """The queued request with the least deadline slack, unless the
        newcomer has no more (an unbounded request never outranks a
        bounded one; a tie sheds the newcomer)."""

        def slack(r: Request) -> float:
            if r.deadline_s is None or r._t_submit is None:
                return float("inf")
            return r.deadline_s - (now - r._t_submit)

        victim = min(self.queue, key=slack)
        return victim if slack(victim) < slack(newcomer) else newcomer

    # ------------------------------------------------------ containment
    def _finish_error(self, req: Request, kind: str, msg: str, slot: Optional[int] = None):
        """The end of every guard: free the request's slot if it holds one,
        stamp the typed error, count it, finish."""
        if slot is not None:
            self._free_slot(slot)
        self._release_carried(req)  # the host pages a queued resumed request holds
        req.error = RequestError(kind, msg)
        req.done = True
        if kind in self._cr:
            self._cr[kind].inc()
            self.telemetry.instant(kind, rid=int(req.rid))
        self.telemetry.on_finish(req, time.perf_counter())
        self.finished.append(req)

    def _quarantine(self, i: int, exc: BaseException):
        """Finish slot i's request with ``quarantined`` (its pages and
        reservations released); the tick goes on for everyone else."""
        if self.slots[i].req is not None:
            self._finish_error(self.slots[i].req, "quarantined",
                               f"{type(exc).__name__}: {exc}", slot=i)

    def _quarantine_row(self, i: int, req: Request, exc: BaseException):
        """``_quarantine`` at a decode sync: a request whose slot was freed
        when its row was launched (``_retiring``) has no slot to free."""
        if self._retiring.pop(id(req), None) is not None:
            self._finish_error(req, "quarantined", f"{type(exc).__name__}: {exc}")
        else:
            self._quarantine(i, exc)

    def _lifecycle_violation(self, req: Request, now: float) -> Optional[tuple]:
        """(kind, message) when the request must be torn down, else None."""
        if req.cancelled:
            return "cancelled", f"cancelled by caller after {len(req.out)} tokens"
        if req.deadline_s is not None and req._t_submit is not None \
                and now - req._t_submit > req.deadline_s:
            return "expired", (f"deadline_s={req.deadline_s} exceeded "
                               f"({now - req._t_submit:.3f}s since submit)")
        if req.max_output_stall_ticks is not None \
                and self._tick - req._progress_tick > req.max_output_stall_ticks:
            return "expired", (f"no token for {self._tick - req._progress_tick} ticks "
                               f"> max_output_stall_ticks={req.max_output_stall_ticks}")
        return None

    def _enforce_lifecycle(self):
        """The tick-boundary sweep of the queue and the slots: cancelled,
        over-deadline and stalled requests are torn down wherever they are.
        A slot with a launch in flight (depth 2) is drained first and judged
        again, so it is judged on the tokens depth 1 would have booked."""
        now = time.perf_counter()
        if self.queue:
            kept: deque[Request] = deque()
            for req in self.queue:
                why = self._lifecycle_violation(req, now)
                if why is None:
                    kept.append(req)
                else:
                    self._finish_error(req, *why)
            self.queue = kept
        due = [i for i, s in enumerate(self.slots)
               if s.req is not None and self._lifecycle_violation(s.req, now) is not None]
        if any(self._chained[i] for i in due) and self._inflight:
            self.drain()
        for i in due:
            req = self.slots[i].req
            why = None if req is None else self._lifecycle_violation(req, now)
            if why is not None:
                self._finish_error(req, *why, slot=i)

    def _update_pressure(self):
        """Degraded-mode hysteresis: ``degrade_after`` consecutive ticks at
        or below the admission watermark enter it, ``recover_after``
        relieved ticks leave it.  While degraded, parked prefix pages are
        evicted down to ``degraded_prefix_target`` (and ``submit`` refuses
        forks).  First, the cold-page ladder's tick."""
        self._recompress_tick()
        if self.degrade_after is None:
            return
        if self._available_pages() <= self.watermark:
            self._pressure_ticks += 1
            self._relief_ticks = 0
        else:
            self._relief_ticks += 1
            self._pressure_ticks = 0
        if not self.degraded and self._pressure_ticks >= self.degrade_after:
            self.degraded = True
            self.telemetry.instant("degraded_enter", tick=self._tick)
        elif self.degraded and self._relief_ticks >= self.recover_after:
            self.degraded = False
            self.telemetry.instant("degraded_exit", tick=self._tick)
        if self.degraded:
            self._cr["degraded_ticks"].inc()
            while self.prefix.reclaimable_count() > self.degraded_prefix_target:
                if self._evict_parked_page() is None:
                    break

    def _recompress_tick(self, budget: int = 2):
        """The cold-page ladder (``recompress_after`` > 0): after that many
        consecutive ticks at or below the admission watermark, requantize
        up to ``budget`` parked pages one stage down, coldest first, in
        place.  The stage sticks to the page's bytes: it survives a revival
        and travels through the host tier as the entry's meta."""
        if not self.recompress_after:
            return
        if self._available_pages() > self.watermark:
            self._rc_pressure = 0
            return
        self._rc_pressure += 1
        if self._rc_pressure < self.recompress_after:
            return
        top = len(pages_lib.RECOMPRESS_STAGES) - 1
        for pid in list(self.prefix.reclaimable):  # LRU order: coldest first
            if budget == 0:
                break
            stage = self._recompress_stage.get(pid, 0)
            if stage >= top:
                continue
            self._recompress_page(pid, pages_lib.RECOMPRESS_STAGES[stage + 1])
            self._recompress_stage[pid] = stage + 1
            self._cs_swap["recompressed_pages"].inc()
            self.telemetry.instant("recompress", page=int(pid),
                                   stage=pages_lib.RECOMPRESS_STAGES[stage + 1])
            budget -= 1

    def audit(self, strict: Optional[bool] = None) -> AuditReport:
        """The ``serving/audit.py`` sweep now; ``strict`` (the engine's by
        default) raises ``AuditError`` on a dirty report."""
        report = audit_engine(self)
        self._last_audit = report
        if not report.ok:
            self._cr["audit_failures"].inc()
            self.telemetry.instant("audit_fail", violations=len(report.violations))
        if self.strict if strict is None else strict:
            report.raise_if_dirty()
        return report

    def health(self) -> dict:
        """One JSON-able liveness and pressure summary, in the reference's
        shape; ``snapshot()`` is the full metrics dump."""
        return {
            "status": "degraded" if self.degraded else "ok",
            "degraded": self.degraded,
            "tick": self._tick,
            "pipeline_depth": self.pipeline_depth,
            "pipeline_inflight": len(self._inflight),
            "queue_depth": len(self.queue),
            "active_slots": len(self._active()),
            "watermark_headroom": self._available_pages() - self.watermark,
            "pressure_ticks": self._pressure_ticks,
            "relief_ticks": self._relief_ticks,
            "counters": {k: c.value for k, c in self._cr.items()},
            "host_tier": None if self.host_tier is None else self.host_tier.snapshot(),
            "swap": {k: c.value for k, c in self._cs_swap.items()},
            "last_audit": None if self._last_audit is None else self._last_audit.to_dict(),
            "faults_injected": None if self.faults is None else self.faults.counts(),
        }

    def _too_long_msg(self, plen: int) -> str:
        return (f"prompt of {plen} tokens does not fit the slab prefill (max_len="
                f"{self.max_len}); serve it with chunked_prefill=True")

    def _emit(self, req: Request, tok: int, margin: float, launch: int):
        req.out.append(tok)
        req.margins.append(margin)
        req.launch_ids.append(launch)

    def _next_launch(self) -> int:
        launch, self._launches = self._launches, self._launches + 1
        return launch

    # ------------------------------------------------------------ pages
    def _alloc_page(self, kind: str = pages_lib.KIND_KV) -> Optional[int]:
        """A free page of ``kind``, evicting parked prefix pages LRU-first
        (a freed pid comes back as any kind: one budget across kinds); None
        when neither is left (or the ``alloc`` seam fires)."""
        if self.faults is not None and self.faults.alloc_fails(self._tick):
            return None
        pid = self.pool_mgr.alloc(kind)
        while pid is None:
            if self._evict_parked_page() is None:
                return None
            pid = self.pool_mgr.alloc(kind)
        return pid

    def _evict_parked_page(self) -> Optional[int]:
        """Evict the least recently parked prefix page to the free list;
        with the host tier on, its bytes are demoted to host RAM first."""
        popped = self.prefix.pop_lru()
        if popped is None:
            return None
        h, victim = popped
        self._c["prefix_evictions"].inc()
        self.telemetry.instant("prefix_evict", page=int(victim))
        self._maybe_swap_out_parked(h, victim)
        self._recompress_stage.pop(victim, None)  # the pid goes back to the free list
        self.pool_mgr.release(victim)
        return victim

    def _maybe_swap_out_parked(self, h, pid: int) -> bool:
        """Demote an evicted parked page's bytes to the host tier under its
        chain hash.  A refusal (no tier, the ``swap_out`` seam, a tier full
        of carries) is a plain eviction: the caller frees the pid anyway."""
        tier = self.host_tier
        if tier is None or h is None:
            return False
        if self.pool_mgr.kind_of(pid) != self.HOST_SWAP_KIND:
            return False  # a kind the tier does not hold from this layout
        if self.faults is not None and self.faults.swap_out_fails(self._tick, key=int(pid)):
            self._cs_swap["swap_skips"].inc()
            return False
        if tier.full():
            ev = tier.evict_lru()
            if ev is None:
                self._cs_swap["swap_skips"].inc()
                return False  # every entry a carry: plain eviction
            self.prefix.host_forget(ev[0])
            self.telemetry.instant("host_evict")
        arrays = self._fetch_page_arrays(pid)
        stage = self._recompress_stage.get(pid, 0)
        handle = tier.put(arrays, self.HOST_SWAP_KIND, meta={"stage": stage} if stage else None)
        self.prefix.host_register(h, handle)
        self._cs_swap["swap_outs"].inc()
        self._cs_swap["swap_bytes"].inc(tier.entries[handle].nbytes)
        self.telemetry.instant("swap_out", page=int(pid))
        return True

    # ------------------------------------------------- layout hooks
    # the page kind the host tier holds from this layout
    HOST_SWAP_KIND = pages_lib.KIND_KV

    def _fetch_page_arrays(self, pid: int) -> list:
        """One page's per-page pool slices on the host (a swap-out)."""
        return pages_lib.kv_page_fetch(self.pool, pid)

    def _insert_page_arrays(self, pid: int, entry) -> None:
        """Write a verified host entry into pool page ``pid``, in place."""
        pages_lib.kv_page_insert(self.pool, entry.arrays, pid, flat=entry.flat)

    def _recompress_page(self, pid: int, stage: str) -> None:
        pages_lib.kv_page_recompress(self.pool, pid, stage)

    def _carry_resume_state(self, i: int, resumed: Request) -> None:
        """Preemption of slot i, before its teardown: with the host tier, a
        decoding victim's pages are snapshotted to pinned host entries and
        ``resumed`` carries their handles, so its re-admission streams them
        back and rejoins decode with no prefill.  A refusal (no tier, a
        prefilling or forking victim, the ``swap_out`` seam, no room for
        the carry) leaves plain recompute.  The slot is named by its index:
        ``slots.index`` would compare slots by value."""
        tier, slot = self.host_tier, self.slots[i]
        if tier is None or slot.mode != "decode" or slot.pos <= 0 or resumed.n_samples > 1:
            return
        pids = live_pages(self.tables[i])
        if not pids:
            return
        if self.faults is not None and self.faults.swap_out_fails(self._tick, key=int(resumed.rid)):
            self._cs_swap["swap_skips"].inc()
            return
        while tier.capacity - tier.used() < len(pids):
            ev = tier.evict_lru()
            if ev is None:
                self._cs_swap["swap_skips"].inc()
                return  # the carry does not fit: recompute
            self.prefix.host_forget(ev[0])
        handles, nbytes = [], 0
        for pid in pids:
            handles.append(tier.put(self._fetch_page_arrays(pid), self.HOST_SWAP_KIND,
                                    pinned=True, meta={"rid": int(resumed.rid)}))
            nbytes += tier.entries[handles[-1]].nbytes
        resumed._host_resume = (handles, slot.pos)
        self._cs_swap["swap_outs"].inc(len(pids))
        self._cs_swap["swap_bytes"].inc(nbytes)
        self.telemetry.instant("swap_out_preempt", rid=int(resumed.rid), pages=len(pids))

    def _release_carried(self, req: Request) -> None:
        """Drop the host entries a queued request carries."""
        if req._host_resume is not None:
            if self.host_tier is not None:
                for handle in req._host_resume[0]:
                    self.host_tier.drop(handle)
            req._host_resume = None

    def _drop_page(self, pid: int):
        """One owner lets go of ``pid``: a registered page is parked when
        its count reaches zero, any other page is freed."""
        if pid == NULL_PAGE:
            return
        if self.pool_mgr.deref(pid):
            if self.prefix.knows(pid):
                self.prefix.mark_reclaimable(pid)
            else:
                self.pool_mgr.release(pid)

    def _free_slot(self, i: int):
        """Release slot i: drop ONLY its own page references (forked
        siblings hold one each) and the sibling slots it had reserved."""
        for pid in self.tables[i]:
            self._drop_page(int(pid))
        self.tables[i] = NULL_PAGE
        self.slots[i] = _PagedSlot()
        self._chained[i] = False  # any in-flight row of slot i is now dead
        for s in self.slots:
            if s.reserved_by == i:
                s.reserved_by = None

    def _available_pages(self) -> int:
        return self.pool_mgr.available() + self.prefix.reclaimable_count()

    def _grow_tables(self, n_seq_pages: int):
        """Widen every block table to ≥ n_seq_pages columns, doubling
        (chunked mode only)."""
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
        """Tokens a sequence may hold: the block-table width (== max_len
        for a slab engine)."""
        return self.tables.shape[1] * self.ps

    # ------------------------------------------------------ prefix hits
    def _plan_prefix_hits(self, req: Request, prompt: np.ndarray):
        """(chain hashes of the prompt's full pages, the longest chain of
        pages that hit: a pid, or ``("host", handle)`` for a chunk the host
        tier holds).  A peek: moves no page and counts nothing, since a
        head-of-line request is planned again every tick; the hashes are
        memoized on the request."""
        if not self.prefix_caching:
            hashes = []
        elif req._hash_cache is not None and req._hash_cache[0] == self.ps:
            hashes = req._hash_cache[1]
        else:
            hashes = chunk_hashes(prompt, self.ps)
            req._hash_cache = (self.ps, hashes)
        hits = []
        for h in hashes:
            pid = self.prefix.peek(h)
            if pid is not None:
                hits.append(pid)
                continue
            if self.host_tier is not None:
                handle = self.prefix.host_peek(h)
                if handle is not None:  # still a hit: a swap-in into a fresh pid
                    hits.append(("host", handle))
                    continue
            break
        if hits and self.faults is not None and self.faults.drop_prefix_claim(
                self._tick, key=int(req.rid)):
            hits = []  # a racing eviction: the whole prompt recomputes
        return hashes, hits

    @staticmethod
    def _n_hbm_hits(hits) -> int:
        """Planned hits that hold an HBM pid (a host hit needs a fresh page)."""
        return sum(1 for hit in hits if not isinstance(hit, tuple))

    def _claim_hits(self, hashes, hits, n_cacheable: int, table: np.ndarray) -> int:
        """Take a reference on each planned hit page (reviving parked
        ones) into ``table``, a host hit swapped in to a fresh pid; count
        hits, and misses over the ``n_cacheable`` pages that could have
        hit.  The chain is truncated where a planned page is gone — a
        refused swap-in, or a parked page that an earlier swap-in's
        allocation evicted (the reference asserts there) — and the rest
        recomputes; a corrupt swap-in raises ``PageCorruptionError``.
        Returns the pages claimed."""
        claimed = 0
        for i, (h, hit) in enumerate(zip(hashes, hits)):
            if isinstance(hit, tuple):
                pid = self._swap_in_prefix_page(h)
                if pid is None:
                    break
            else:
                pid = hit
                if self.prefix.peek(h) != pid:
                    break
                self.prefix.lookup(h)
                if self.pool_mgr.refcount[pid] == 0:
                    self.pool_mgr.revive(pid)
                else:
                    self.pool_mgr.ref(pid)
            table[i] = pid
            claimed += 1
        self._c["prefix_hits"].inc(claimed)
        self._c["prefix_misses"].inc(max(0, n_cacheable - claimed))
        return claimed

    def _swap_in_prefix_page(self, h) -> Optional[int]:
        """Stream one host-resident prefix chunk back into a fresh pid:
        claim the handle, allocate, verify-take, insert, register the hash
        on the new pid.  None on a refusal (a miss), or raises
        ``PageCorruptionError`` (the entry is gone either way)."""
        tier = self.host_tier
        handle = self.prefix.host_peek(h)
        if tier is None or handle is None or not tier.has(handle):
            return None  # raced out since planning
        key = int(handle - pages_lib._HANDLE_BASE)
        if self.faults is not None and self.faults.swap_in_fails(self._tick, key=key):
            self.prefix.host_forget(handle)  # the entry is unusable
            tier.drop(handle)
            self._cs_swap["swap_skips"].inc()
            return None
        self.prefix.host_claim(h)
        tier.pin(handle)  # the allocation below may LRU-evict host entries
        pid = self._alloc_page()
        if pid is None:
            tier.pin(handle, False)
            self.prefix.host_register(h, handle)  # undo the claim
            return None
        if self.faults is not None and self.faults.swap_corrupts(self._tick, key=key):
            tier.corrupt(handle)
        self._cs_swap["swap_ins"].inc()
        try:
            entry = tier.take(handle, expect_kind=self.HOST_SWAP_KIND)
        except pages_lib.PageCorruptionError:
            self._cs_swap["corrupt_swapins"].inc()
            self.telemetry.instant("swap_corrupt", handle=key)
            self._drop_page(pid)  # fresh, not registered yet: freed
            raise
        self._cs_swap["verified_swapins"].inc()
        self._cs_swap["swap_bytes"].inc(entry.nbytes)
        self._insert_page_arrays(pid, entry)
        stage = entry.meta.get("stage", 0)
        if stage:
            self._recompress_stage[pid] = stage
        if self.prefix_caching:
            self.prefix.register(h, pid)
        self.telemetry.instant("swap_in", page=int(pid))
        return pid

    def _try_resume_from_host(self, req: Request, slot_idx: int, hr: tuple) -> Optional[bool]:
        """Re-admit a preemption victim from its carried host pages: each
        streamed back verified into a fresh pid, then decode rejoins at the
        carried position — no prefill, the same KV bytes.  True (admitted),
        False (waits for pages; the carry stays pinned), or None (fell back:
        the carry dropped, the caller admits by recompute)."""
        handles, pos = hr
        if pos != len(req.prompt) - 1:
            raise RuntimeError(f"a host carry at position {pos} for a {len(req.prompt)}-token "
                               "resumed prompt")
        tier = self.host_tier
        if (tier is None or any(not tier.has(h) for h in handles)
                # a slab recompute would raise the typed too-long error
                or (not self.chunked and len(req.prompt) >= self.max_len)):
            self._release_carried(req)
            return None
        if self.faults is not None and self.faults.swap_in_fails(self._tick, key=int(req.rid)):
            self._cs_swap["swap_skips"].inc()
            self._release_carried(req)
            return None
        need = len(handles)
        if self._available_pages() < need + self.watermark:
            return False
        if self.chunked:
            self._grow_tables(pages_needed(len(req.prompt) + req.max_new + 1, self.ps))
        # every destination page before any entry is consumed: a dry
        # allocator here (a flake) rolls back to recompute, which stays exact
        table = np.full((self.tables.shape[1],), NULL_PAGE, np.int32)
        for k in range(need):
            pid = self._alloc_page()
            if pid is None:
                for p in table:
                    self._drop_page(int(p))
                self._cs_swap["swap_skips"].inc()
                self._release_carried(req)
                return None
            table[k] = pid
        try:
            for k, handle in enumerate(handles):
                if self.faults is not None and self.faults.swap_corrupts(self._tick,
                                                                         key=int(req.rid)):
                    tier.corrupt(handle)
                self._cs_swap["swap_ins"].inc()
                entry = tier.take(handle, expect_kind=self.HOST_SWAP_KIND)
                self._cs_swap["verified_swapins"].inc()
                self._cs_swap["swap_bytes"].inc(entry.nbytes)
                self._insert_page_arrays(int(table[k]), entry)
        except pages_lib.PageCorruptionError:
            for pid in table:
                self._drop_page(int(pid))
            self._cs_swap["corrupt_swapins"].inc()
            self.telemetry.instant("swap_corrupt", rid=int(req.rid))
            self._release_carried(req)  # the entries not taken yet
            raise
        req._host_resume = None
        self.telemetry.on_admit(req, time.perf_counter())
        self.tables[slot_idx] = table
        self.slots[slot_idx] = _PagedSlot(req=req, pos=pos, admit_seq=self._admit_counter)
        self._admit_counter += 1
        # the cache holds pos tokens; the one it lacks is the resumed
        # prompt's last, which decode consumes next
        self._next_tok[slot_idx] = int(req.prompt[-1])
        self._chained[slot_idx] = False
        req._progress_tick = self._tick
        self.telemetry.instant("swap_resume", rid=int(req.rid), pages=need, pos=int(pos))
        self._finish_if_budget_spent(slot_idx)
        return True

    # -------------------------------------------------------- admission
    def _try_admit(self, req: Request, slot_idx: int) -> bool:
        if req._host_resume is not None:
            res = self._try_resume_from_host(req, slot_idx, req._host_resume)
            if res is not None:
                return res
        prompt = np.asarray(req.prompt, np.int64)
        plen = len(prompt)
        if self.chunked:
            return self._try_admit_chunked(req, prompt, plen, slot_idx)
        if plen >= self.max_len:
            raise PromptTooLongError(self._too_long_msg(plen))
        n_prompt_pages = pages_needed(plen, self.ps)
        n_full = plen // self.ps
        hashes, hits = self._plan_prefix_hits(req, prompt)
        need = n_prompt_pages - self._n_hbm_hits(hits)  # a host hit needs a fresh page
        if self._available_pages() < need + self.watermark:
            return False  # admission control: keep decode headroom

        table = np.full((self.tables.shape[1],), NULL_PAGE, np.int32)
        scatter_ids = np.full((self.maxp,), NULL_PAGE, np.int32)
        try:
            n_claimed = self._claim_hits(hashes, hits, n_full, table)
            for i in range(n_claimed, n_prompt_pages):
                pid = self._alloc_page()
                if pid is None:
                    raise PagePoolExhaustedError(
                        f"allocator dry mid-admission (watermark={self.watermark} "
                        f"should have reserved {need} pages)")
                table[i] = scatter_ids[i] = pid
            # the whole prompt over a max_len slab, then only the pages
            # that missed go into the pool; shared pages are never written
            if self.faults is not None:
                self.faults.delay_launch(self._tick, key=0)
            t0 = time.perf_counter()
            self.telemetry.on_admit(req, t0)
            if self._probe is not None:
                self._probe.begin()
            tokens = torch.from_numpy(prompt.astype(np.int32))[None].to(self.device)
            logits, cache1 = self.api.prefill_fn(self.params, {"tokens": tokens}, self.max_len)
            scatter_prefill_pages(self.pool, cache1, torch.from_numpy(scatter_ids).to(self.device))
            probed = None if self._probe is None else self._probe.fetch()
            nxt, fin, margin = _host_row_stats(logits)
            self._c_syncs.inc()
            t1 = time.perf_counter()
            self._c["t_prefill_s"].inc(t1 - t0)
            self._c["prefill_launches"].inc()
            self._c["prefill_tokens"].inc(plen)
            self.telemetry.prefill_launch(t0, t1, slots=1, tokens=plen)
            self.telemetry.on_chunk(req, t0, t1, plen)  # the whole prompt, one chunk
            launch = self._next_launch()
            self._probe_done(launch, probed)
            if self.prefix_caching:
                for i in range(n_claimed, n_full):
                    self.prefix.register(hashes[i], int(table[i]))
        except BaseException:
            for pid in table:  # the pages live only in the local table
                self._drop_page(int(pid))
            raise

        self.tables[slot_idx] = table
        self.slots[slot_idx] = _PagedSlot(req=req, pos=plen, admit_seq=self._admit_counter)
        self._admit_counter += 1
        try:
            self._start_decode(slot_idx, logits[0, -1], int(nxt[0]), bool(fin[0]), float(margin[0]),
                               launch)
        except Exception as exc:  # admitted: the slot is torn down, not rolled back
            if self.strict:
                raise
            self._quarantine(slot_idx, exc)
        return True

    def _try_admit_chunked(self, req: Request, prompt, plen: int, slot_idx: int) -> bool:
        """Plan-only admission: claim the prefix-hit pages and mark the slot
        ``prefill``; the chunk ticks run the rest of the prompt."""
        n_prompt_pages = pages_needed(plen, self.ps)
        hashes, hits = self._plan_prefix_hits(req, prompt)
        # keep ≥ 1 suffix token: the prompt's last-position logits (the
        # first generated token) come out of its final chunk
        hits = hits[: min(len(hits), (plen - 1) // self.ps)]
        need = n_prompt_pages - self._n_hbm_hits(hits)
        if self._available_pages() < need + self.watermark:
            return False  # the same memory policy; only compute is deferred

        self._grow_tables(pages_needed(plen + req.max_new + 1, self.ps))
        table = np.full((self.tables.shape[1],), NULL_PAGE, np.int32)
        try:
            # cacheable: the full pages, less the hit trimmed above
            n_claimed = self._claim_hits(hashes, hits, (plen - 1) // self.ps, table)
        except BaseException:
            for pid in table:  # a corrupt swap-in mid-claim: the pages live only here
                self._drop_page(int(pid))
            raise
        self._c["prefill_tokens_skipped"].inc(n_claimed * self.ps)
        self.telemetry.on_admit(req, time.perf_counter())
        self.tables[slot_idx] = table
        self.slots[slot_idx] = _PagedSlot(
            req=req, pos=n_claimed * self.ps, admit_seq=self._admit_counter,
            mode="prefill", pending=prompt, hashes=hashes,
        )
        self._admit_counter += 1
        if req.n_samples > 1:
            # hold the sibling slots until the fork; _free_slot releases
            # them if this parent is preempted before it forks
            others = [j for j, s in enumerate(self.slots)
                      if s.req is None and s.reserved_by is None and j != slot_idx]
            for j in others[: req.n_samples - 1]:
                self.slots[j].reserved_by = slot_idx
        return True

    def _admit(self) -> int:
        """Admit from the head of the queue while a slot (n sibling slots
        for a forking request) and the pages are there.  An admission that
        raises (its pages already rolled back) is retried from the head
        three times, then the request is quarantined; a corrupt swap-in
        quarantines it at once."""
        admitted = 0
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s.req is None and s.reserved_by is None]
            req = self.queue[0]
            if not free or req.n_samples > len(free):
                break
            try:
                ok = self._try_admit(req, free[0])
            except Exception as exc:
                if self.strict:
                    raise
                self.queue.popleft()
                if isinstance(exc, pages_lib.PageCorruptionError):
                    # no retry, which would recompute and mask the failure:
                    # only this request ever referenced the bad bytes
                    self._finish_error(req, "quarantined", f"swap-in integrity failure: {exc}")
                    break
                req._admit_retries += 1
                if req._admit_retries <= 3:
                    self.queue.appendleft(req)
                    self.telemetry.instant("admit_retry", rid=int(req.rid),
                                           attempt=req._admit_retries)
                else:
                    self._finish_error(req, "quarantined",
                                       f"admission failed after {req._admit_retries - 1} "
                                       f"retries: {type(exc).__name__}: {exc}")
                break
            if not ok:
                break  # head-of-line waits for pages
            self.queue.popleft()
            admitted += 1
        return admitted

    def _finish_if_budget_spent(self, i: int) -> bool:
        """Retire a slot whose first token already spent the budget (a
        recomputed request whose output had reached max_new).  No EOS check
        here, as in the reference."""
        req = self.slots[i].req
        if len(req.out) >= req.max_new + 1:
            req.done = True
            self.telemetry.on_finish(req, time.perf_counter())
            self.finished.append(req)
            self._free_slot(i)
            return True
        return False

    def _start_decode(self, i: int, row, greedy_tok: int, finite: bool, margin: float,
                      launch: int):
        """The prompt of slot i is done (``row``: its last-position logits
        (V,)): emit the first token(s).  A request with ``n_samples > 1``
        forks here into n sibling slots that share every prompt page by
        refcount; the submitted Request becomes sibling 0 with its
        ``n_samples`` demoted to 1, so a later preemption never re-forks
        it.  Non-finite logits raise (the caller quarantines slot i); a
        sampler fault quarantines only its sibling."""
        slot = self.slots[i]
        parent = slot.req
        now = time.perf_counter()
        if self.nan_guard:
            if self.faults is not None and self.faults.poison_logits(self._tick, i):
                finite = False
            if not finite:
                raise NonFiniteLogitsError(f"non-finite logits at prefill end (rid={parent.rid})")
        children = [(i, parent)]
        n = parent.n_samples
        if n > 1:
            res = [j for j, s in enumerate(self.slots) if s.req is None and s.reserved_by == i]
            free = [j for j, s in enumerate(self.slots)
                    if s.req is None and s.reserved_by is None and j != i]
            sibs = (res + free)[: n - 1]
            if len(sibs) != n - 1:
                raise RuntimeError("fork found too few sibling slots")
            shared = self._fork_shared_pages(i)
            parent.n_samples, parent.sample_idx = 1, 0
            for s_idx, j in enumerate(sibs, start=1):
                child = Request(rid=parent.rid, prompt=parent.prompt, max_new=parent.max_new,
                                frames=parent.frames, sampling=parent.sampling,
                                sample_idx=s_idx)
                self.telemetry.on_fork_child(parent, child, now)
                self._fork_sibling(i, j, child, shared)
                self._admit_counter += 1
                children.append((j, child))
            self._c["forks"].inc()
            self._c["shared_pages"].inc(len(shared) * (n - 1))
        # first tokens only once every sibling holds its references: a
        # sibling that retires (or is quarantined) here must not free pages
        # the others share
        for j, child in children:
            try:
                if self.faults is not None:
                    self.faults.sampler_raises(self._tick, j)
                tok, m = pick_token(row, greedy_tok, margin, child, self.slots[j].pos)
            except Exception as exc:
                if self.strict:
                    raise
                self._quarantine(j, exc)
                continue
            self._emit(child, tok, m, launch)
            self._next_tok[j] = tok
            self._chained[j] = False  # a host-known token: the prefill just set it
            child._progress_tick = self._tick
            self.telemetry.on_first_token(child, now)
            self._finish_if_budget_spent(j)

    def _fork_shared_pages(self, i: int) -> list:
        """The pages slot i's fork siblings share: its block table's."""
        return live_pages(self.tables[i])

    def _fork_sibling(self, i: int, j: int, child: Request, shared: list) -> None:
        """Slot j becomes fork sibling ``child`` of slot i: one reference per
        shared page and sibling, slot i's block table."""
        for pid in shared:
            self.pool_mgr.ref(pid)
        self.tables[j] = self.tables[i]
        self.slots[j] = _PagedSlot(req=child, pos=self.slots[i].pos, admit_seq=self._admit_counter)

    # ------------------------------------------------------- preemption
    def _preempt_one(self, exclude: Optional[int]) -> Optional[int]:
        """Requeue the youngest active sequence (≠ exclude if possible) at
        the head of the queue as prompt + the output not yet folded in.
        Returns the victim slot."""
        cands = [i for i, s in enumerate(self.slots) if s.req is not None and i != exclude]
        if not cands and exclude is not None and self.slots[exclude].req is not None:
            cands = [exclude]
        if not cands:
            return None
        victim = max(cands, key=lambda i: self.slots[i].admit_seq)
        req = self.slots[victim].req
        orig_plen = req._orig_plen if req._orig_plen is not None else len(req.prompt)
        folded = len(req.prompt) - orig_plen
        resumed = Request(
            rid=req.rid,
            prompt=np.concatenate([np.asarray(req.prompt, np.int64),
                                   np.asarray(req.out[folded:], np.int64)]),
            max_new=req.max_new, out=req.out, margins=req.margins, launch_ids=req.launch_ids,
            frames=req.frames, sampling=req.sampling, n_samples=req.n_samples,
            sample_idx=req.sample_idx, _orig_plen=orig_plen, _frames_digest=req._frames_digest,
            timeline=req.timeline,  # one timeline: one submit, an admit per admission
            # the lifecycle guard survives preemption: the original submit
            # anchors the deadline, a cancel still lands, the stall clock
            # and the admission retries go on
            deadline_s=req.deadline_s, max_output_stall_ticks=req.max_output_stall_ticks,
            cancelled=req.cancelled, _t_submit=req._t_submit,
            _progress_tick=req._progress_tick, _admit_retries=req._admit_retries,
        )
        req._resumed_as = resumed
        self._carry_resume_state(victim, resumed)  # before the teardown drops the pages
        self._free_slot(victim)
        self.queue.appendleft(resumed)
        self._c["preemptions"].inc()
        now = time.perf_counter()
        self.telemetry.on_preempt(resumed, now)
        self.telemetry.instant("preempt", now, rid=int(req.rid), slot=victim)
        return victim

    def _alloc_page_preempting(self, i: int) -> Optional[int]:
        """``_alloc_page``, preempting (youngest ≠ i first) while dry.
        None iff slot i itself was preempted or nothing is left.  In-flight
        launches are drained first: a preemption folds ``req.out`` into the
        requeued prompt, which must hold every launched token.  The pool is
        asked again after the drain only if the drain freed pages, so the
        ``alloc`` seam sees depth 1's sequence of queries."""
        pid = self._alloc_page()
        if pid is None and self._inflight:
            before = self._available_pages()
            self.drain()
            if self.slots[i].req is None:
                return None  # the drain retired slot i itself
            if self._available_pages() > before:
                pid = self._alloc_page()
        while pid is None:
            if self._preempt_one(exclude=i) is None or self.slots[i].req is None:
                return None
            pid = self._alloc_page()
        return pid

    def _ensure_tail_page(self, i: int) -> bool:
        """Give slot i's next write position a private page: a fresh one at
        a page boundary, a copy of a shared tail page (copy-on-write)."""
        slot = self.slots[i]
        if slot.req is None or slot.mode != "decode":
            return False  # preempted earlier in this sweep
        pi = slot.pos // self.ps
        pid = int(self.tables[i][pi])
        if slot.pos % self.ps == 0 and pid == NULL_PAGE:
            pid = self._alloc_page_preempting(i)
            if pid is None:
                return False
            self.tables[i][pi] = pid
            return True
        if pid != NULL_PAGE and self.pool_mgr.refcount[pid] > 1:
            new = self._alloc_page_preempting(i)
            if new is None:
                return False
            copy_page(self.pool, pid, new)
            self._c["cow_copies"].inc()
            self.telemetry.instant("cow_copy", src=int(pid), dst=int(new))
            self._drop_page(pid)
            self.tables[i][pi] = new
        return True

    # --------------------------------------------------- chunked prefill
    def _chunk_bucket(self, c: int) -> int:
        if c >= self.prefill_chunk:
            return self.prefill_chunk
        return _pow2_bucket(c, self.prefill_chunk)

    def _prefill_tick_all(self) -> int:
        """Advance every prefilling slot by one chunk in ONE launch.  Each
        slot's chunk pages are allocated first, preempting if dry (a slot
        preempted by a later slot's allocation drops out); the full pages
        a chunk completes are registered."""
        plans = {}
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.mode != "prefill":
                continue
            start = slot.pos  # page-aligned: chunks are page multiples
            c = min(self.prefill_chunk, len(slot.pending) - start)
            ids = np.full((pages_needed(c, self.ps),), NULL_PAGE, np.int32)
            for k in range(len(ids)):
                pid = self._alloc_page_preempting(i)
                if pid is None:
                    break  # slot i was preempted
                self.tables[i][start // self.ps + k] = ids[k] = pid
            else:
                plans[i] = (start, c, ids)
        batch = [i for i in plans
                 if self.slots[i].req is not None and self.slots[i].mode == "prefill"]
        if not batch:
            return 0
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
        if self.faults is not None:
            self.faults.delay_launch(self._tick, key=2)
        t0 = time.perf_counter()
        if self._probe is not None:
            self._probe.begin()
        dev = torch.from_numpy(packed).to(self.device)
        logits, _ = self.api.prefill_from_pages_fn(  # the pool is written in place
            self.params, dev[:, :c_bucket], self.pool, dev[:, c_bucket + 2 + n_cp :],
            dev[:, c_bucket], dev[:, c_bucket + 1 : c_bucket + 1 + n_cp],
            chunk_len=dev[:, c_bucket + 1 + n_cp],
        )
        probed = None if self._probe is None else self._probe.fetch()
        done = [i for i in batch if plans[i][0] + plans[i][1] == len(self.slots[i].pending)]
        # the results a finished prompt needs come in one fetch; otherwise the
        # card still waits (t_prefill_s is synced), the CPU under profile_sync
        if done:
            nxt, fin, margin = _host_row_stats(logits)
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if done or self.profile_sync or self.device.type == "cuda":
            self._c_syncs.inc()
        t1 = time.perf_counter()
        self._c["t_prefill_s"].inc(t1 - t0)
        self._c["prefill_launches"].inc()
        self.telemetry.prefill_launch(t0, t1, slots=len(batch),
                                      tokens=int(sum(plans[i][1] for i in batch)))
        launch = self._next_launch()
        self._probe_done(launch, probed)
        for r, i in enumerate(batch):
            start, c, _ = plans[i]
            slot = self.slots[i]
            slot.pos = start + c
            self._c["prefill_chunks"].inc()
            self._c["prefill_tokens"].inc(c)
            self.telemetry.on_chunk(slot.req, t0, t1, c)
            if self.prefix_caching:
                for p in range(start // self.ps, min(slot.pos // self.ps, len(slot.hashes))):
                    self.prefix.register(slot.hashes[p], int(self.tables[i][p]))
            if i in done:
                slot.mode, slot.pending, slot.hashes = "decode", None, None
                try:
                    self._start_decode(i, logits[r, -1], int(nxt[r]), bool(fin[r]),
                                       float(margin[r]), launch)
                except Exception as exc:
                    if self.strict:
                        raise
                    self._quarantine(i, exc)
        return len(batch)

    # ------------------------------------------------------------- ticks
    def _active(self):
        return [i for i, s in enumerate(self.slots) if s.req is not None]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device without waiting for the stream:
        through pinned memory on the card (the caching host allocator keeps
        the pinned block until the copy has landed)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _overlay_samples(self, logits, nxt, margin, rows: list):
        """Draw the sampled rows' tokens in one batched call and overlay
        them (and their margins) on the launch's greedy vectors, on the
        device.  A decode token is keyed at ``pos + 1``: the cache holds
        ``pos`` tokens and this tick writes the consumed one at ``pos``
        (keying it at ``pos`` would reuse the first token's key)."""
        meta = np.array([[i, r.sampling.seed, r.sample_idx, self.slots[i].pos + 1,
                          r.sampling.top_k] for i, r in rows], np.int64)
        temp = np.array([r.sampling.temperature for _, r in rows], np.float32)
        m = self._to_device(meta)
        tok, mg = sample_row(logits[m[:, 0], -1, :], sampling_keys(m[:, 1:4]),
                             self._to_device(temp), m[:, 4], k_max=int(meta[:, 4].max()))
        return (nxt.index_put((m[:, 0],), tok.to(nxt.dtype)),
                margin.index_put((m[:, 0],), mg.to(margin.dtype)))

    def trace_counts(self, since_init: bool = True) -> dict:
        """Captures of the serving step functions on this engine's api, by
        the reference's keys: ``decode`` counts the decode step's CUDA
        graphs (one per block-table width and engine); ``prefill`` and
        ``chunk`` stay 0, since the slab and chunk prefills run eagerly.
        ``since_init`` subtracts the counts seen when this engine was built."""
        counts = dict(self.api.trace_counts)
        if since_init:
            counts = {k: v - self._trace_base.get(k, 0) for k, v in counts.items()}
        return counts

    def _count_capture(self):
        self.api.trace_counts["decode"] += 1

    def _stage(self, pk: np.ndarray, key) -> torch.Tensor:
        """The packed row on the device: through one of two pinned rows in
        turn and a ``non_blocking`` copy on the card (into bucket ``key``'s
        static input with graphs on), a copy of it on the CPU."""
        if self.device.type != "cuda":
            return torch.from_numpy(pk.copy())
        slot = self._staging[0]
        self._staging.reverse()
        if slot[0] is None or slot[0].shape != pk.shape:
            slot[0] = torch.empty(pk.shape, dtype=torch.int32, pin_memory=True)
            slot[1] = torch.cuda.Event()
        slot[1].synchronize()  # the copy that last read this row has landed
        slot[0].numpy()[:] = pk
        if self._graphs is not None:
            dev = self._graphs.packed_input(key, pk.shape[1])
        else:
            dev = torch.empty(pk.shape, dtype=torch.int32, device=self.device)
        dev.copy_(slot[0], non_blocking=True)
        slot[1].record()
        return dev

    def _decode_step(self, key, packed: torch.Tensor, chain_tok: torch.Tensor):
        """``fused_decode`` on this engine's model and pool (what a graph
        captures; ``key``, the bucket's table width, is the packed row's);
        a probe's rows start over with it."""
        if self._probe is not None:
            self._probe.begin()
        return fused_decode(self.api.paged_decode_fn, self.params, self.pool, packed, chain_tok)

    def _run_decode(self, packed: torch.Tensor, key):
        """The fused decode step on the staged row of bucket ``key``: a graph
        replay (the bucket's first tick captures it) or an eager call."""
        if self._graphs is not None:
            return self._graphs.run(key)
        return self._decode_step(key, packed, self._chain_tok)

    def _probe_done(self, launch: int, fetched) -> None:
        """A launch's probe rows, ready after its sync: feed the sink, every
        launch in launch order (at depth 2 a prefill launch syncs before the
        decode launch in flight ahead of it)."""
        if fetched is None:
            return
        self._probe_wait[launch] = fetched
        while self._probe_next in self._probe_wait:
            self._probe.feed(self._probe_wait.pop(self._probe_next))
            self._probe_next += 1

    def _keep(self, launch: int, rows: list, nxt, fin, margin) -> _InFlight:
        """The launch's record with its own copies of the row results and
        probe rows: a ``non_blocking`` copy into pinned memory and an event
        on the card (a graph's outputs and the probe buffers are overwritten
        by the next launch)."""
        probe = None if self._probe is None else self._probe.fetch()
        if self.device.type != "cuda":
            return _InFlight(launch, self._tick, rows, nxt, fin, margin, probe=probe)
        host = []
        for t in (nxt, fin, margin):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        ready = torch.cuda.Event()
        ready.record()
        return _InFlight(launch, self._tick, rows, *host, ready=ready, probe=probe)

    def _roll_row_fault(self, rec: _InFlight, i: int, req: Request, finite: bool):
        """Consult the ``logits`` and ``sampler`` seams for slot i's row of
        ``rec`` at the launch's tick, in the reference's order (the logits
        seam first; the sampler only for a row still finite), and record
        the fault the row's sync will raise."""
        if self.nan_guard and self.faults.poison_logits(rec.tick, i):
            rec.faults[i] = NonFiniteLogitsError(
                f"non-finite decode logits (rid={req.rid}, slot={i})")
        elif finite or not self.nan_guard:
            try:
                self.faults.sampler_raises(rec.tick, i)
            except Exception as exc:
                rec.faults[i] = exc

    def _pack_decode(self, active: list):
        """The decode launch's packed host row and its bucket key: (next
        token, ``use_host``, kv length, block table) per slot, keyed by the
        table's width.  Rows not in ``active`` ride along at length 0 with
        NULL tables and their stale token, exactly as the reference stages
        them."""
        w = self.tables.shape[1]
        if self._packed.shape[1] != 3 + w:
            self._packed = np.zeros((self.n_slots, 3 + w), np.int32)
        pk = self._packed
        pk[:, 0] = self._next_tok
        pk[:, 1] = ~self._chained
        pk[:, 2] = 0
        pk[:, 3:] = NULL_PAGE  # rows not decoding write (and read) the null page
        for i in active:
            pk[i, 2] = self.slots[i].pos
            pk[i, 3:] = self.tables[i]
        return pk, w

    def _launch_decode(self, active: list) -> float:
        """Enqueue ONE fused decode launch over all n_slots rows
        (``_pack_decode``) and push its record; no host/device sync.  A slot
        takes its token from the host row when freshly (re)started, else
        from the device chain of its previous launch — the same value
        either way.  In a step that admitted and prefilled nothing
        (``_quiet``) the time since the last launch, less the sync waits,
        is pure host time: the decode host gap.  Returns the launch's start
        on the host clock."""
        pk, key = self._pack_decode(active)
        sampled = [(i, self.slots[i].req) for i in active if not self.slots[i].req.sampling.greedy]
        if self.faults is not None:
            self.faults.delay_launch(self._tick, key=1)
        t0 = time.perf_counter()
        if self._quiet and self._last_launch_end is not None:
            self.telemetry.decode_gap(max(0.0, t0 - self._last_launch_end - self._gap_sync_s))
        logits, nxt, fin, margin = self._run_decode(self._stage(pk, key), key)
        if sampled:  # keyed at launch time, on the same stream
            nxt, margin = self._overlay_samples(logits, nxt, margin, sampled)
        rows = []
        for i in active:
            slot = self.slots[i]
            slot.pos += 1  # the position advances at launch; tokens book at sync
            rows.append((i, slot.req, slot.pos))
            self._chained[i] = True
        rec = self._keep(self._next_launch(), rows, nxt, fin, margin)
        if self.faults is not None and self.pipeline_depth > 1:
            for i, req, _ in rows:  # rolled now: _retire_early frees a doomed row's slot
                self._roll_row_fault(rec, i, req, True)
        self._inflight.append(rec)
        self._chain_tok.copy_(nxt)
        self._c["decode_ticks"].inc()
        t1 = time.perf_counter()
        self.telemetry.pipeline_gauge(len(self._inflight))
        if self.pipeline_depth > 1:  # depth 1 times the launch with its sync
            self._c["t_decode_s"].inc(t1 - t0)
            self.telemetry.decode_tick(t0, t1, n_active=len(active))
        self._last_launch_end = t1
        self._gap_sync_s = 0.0
        return t0

    def _sync_one(self, merge_from: Optional[float] = None):
        """Sync the OLDEST in-flight launch and book its tokens: append,
        retire at a stop, skip a speculative row, or quarantine a row whose
        logits are non-finite or whose sampler raised (only that request;
        the sync goes on for the others).  ``merge_from`` (depth 1) times
        the launch and its sync as one span."""
        rec = self._inflight.popleft()
        t0 = time.perf_counter()
        if rec.ready is not None:
            rec.ready.synchronize()
        nxt, fin, margin = (t.numpy() for t in (rec.nxt, rec.fin, rec.margin))
        self._c_syncs.inc()
        t1 = time.perf_counter()
        self._gap_sync_s += t1 - t0
        if merge_from is not None:
            self._c["t_decode_s"].inc(t1 - merge_from)
            self.telemetry.decode_tick(merge_from, t1, n_active=len(rec.rows))
        else:
            self._c["t_decode_s"].inc(t1 - t0)
            self.telemetry.decode_sync(t0, t1, tick=rec.tick)
        self._probe_done(rec.launch, rec.probe)
        cap = self._seq_capacity()
        # slots with a NEWER launch in flight: their freshest token is on
        # the device, so booking this older one must not hand it to the host
        newer = {j for r in self._inflight for (j, rq, _) in r.rows if self.slots[j].req is rq}
        for i, req, pos in rec.rows:
            final = self._retiring.get(id(req))
            if req.done or (final is None and self.slots[i].req is not req):
                continue  # speculative: the slot retired or changed hands since
            try:
                if self.faults is not None and self.pipeline_depth == 1:
                    self._roll_row_fault(rec, i, req, bool(fin[i]))
                if self.nan_guard and not fin[i]:
                    raise NonFiniteLogitsError(
                        f"non-finite decode logits (rid={req.rid}, slot={i})")
                if i in rec.faults:
                    raise rec.faults[i]
            except Exception as exc:
                if self.strict:
                    raise
                self._quarantine_row(i, req, exc)
                continue
            tok = int(nxt[i])
            self._emit(req, tok, float(margin[i]), rec.launch)
            req._progress_tick = rec.tick  # the launch's tick, as depth 1 books it
            self.telemetry.on_token(req, t1)
            stop = sequence_finished(tok, len(req.out), req.max_new, pos, cap, self.eos)
            if final is not None:  # its slot was freed in the step that launched the row
                if stop or final == rec.launch:
                    del self._retiring[id(req)]
                    req.done = True
                    self.telemetry.on_finish(req, t1)
                    self.finished.append(req)
            elif stop:
                req.done = True
                self.telemetry.on_finish(req, t1)
                self.finished.append(req)
                self._free_slot(i)
            else:
                self._next_tok[i] = tok
                if i not in newer:
                    self._chained[i] = False

    def drain(self):
        """Sync and book every in-flight decode launch.  Callers reading
        ``req.out`` between manual ``step()`` calls on a deeper engine drain
        first (``run_to_completion`` drains on exit)."""
        while self._inflight:
            self._sync_one()
        self.telemetry.pipeline_gauge(0)

    def _retire_pending(self, i: int) -> bool:
        """True when slot i's in-flight launches are certain to retire it
        whatever tokens come back: the budget and capacity stops do not
        depend on the token (only EOS does)."""
        if not self._chained[i]:
            return False  # nothing in flight: the host state is current
        slot = self.slots[i]
        pending = sum(1 for r in self._inflight for (j, rq, _) in r.rows
                      if j == i and rq is slot.req)
        return (len(slot.req.out) + pending >= slot.req.max_new + 1
                or slot.pos >= self._seq_capacity() - 1)

    def _retire_early(self):
        """Free, at the end of the step that launched it, each slot whose
        newest in-flight row will retire it — where a depth-1 sync frees it
        — and finish its request when that row is synced."""
        rec = self._inflight[-1]
        for i, req, _ in rec.rows:
            doomed = i in rec.faults and not self.strict
            if self.slots[i].req is req and (doomed or self._retire_pending(i)):
                self._retiring[id(req)] = rec.launch
                self._free_slot(i)

    def step(self) -> int:
        """Admit, ONE chunk launch for every prefilling slot, ONE decode
        launch for every decoding slot.  Depth 1 syncs its launch before
        returning; depth 2 launches tick t, then syncs tick t−1.  A step
        with no decode launch drains.  Before the serving work: the
        lifecycle guard and the degraded mode's bookkeeping; after it, the
        periodic audit.  Returns the slots served (chunks and decode
        rows)."""
        self._tick += 1
        self._enforce_lifecycle()
        self._update_pressure()
        admitted = self._admit()
        served = self._prefill_tick_all()
        decoding = [i for i, s in enumerate(self.slots) if s.req is not None and s.mode == "decode"]
        active = [i for i in decoding if self._ensure_tail_page(i)]
        # a later slot's tail page may have preempted an earlier one
        active = [i for i in active if self.slots[i].req is not None]
        if active:
            self._quiet = served == 0 and admitted == 0
            t0 = self._launch_decode(active)
            while len(self._inflight) >= self.pipeline_depth:
                self._sync_one(t0 if len(self._inflight) == 1 else None)
            if self._inflight:
                self._retire_early()
        else:
            self.drain()
        if self.audit_every and self._tick % self.audit_every == 0:
            self.audit()
        return served + len(active)

    def run_to_completion(self, max_ticks: int = 10_000):
        """Tick until the queue and the slots drain, then drain the
        in-flight launches.  A head-of-line request the pool can never
        admit (a tick that served nothing, with nothing active) is shed
        once it stays so for two ticks without an injected fault, and the
        rest is served; ``shed_stuck=False`` raises
        PagePoolExhaustedError at the first such tick."""
        ticks = stuck = 0
        n_faults = len(self.faults.log) if self.faults is not None else 0
        while (self.queue or self._active()) and ticks < max_ticks:
            served = self.step()
            ticks += 1
            if self.faults is not None and len(self.faults.log) > n_faults:
                n_faults, stuck = len(self.faults.log), 0  # chaos, not a stuck request
                continue
            if served == 0 and self.queue and not self._active():
                head = self.queue[0]
                msg = (f"pool too small to admit a {len(head.prompt)}-token prompt "
                       f"(free={self._available_pages()}, watermark={self.watermark})")
                if not self.shed_stuck:
                    raise PagePoolExhaustedError(msg)
                stuck += 1
                if stuck >= 2:
                    self.queue.popleft()
                    self._finish_error(head, "shed", msg)
                    stuck = 0
            else:
                stuck = 0
        self.drain()
        return self.finished, ticks

    # ------------------------------------------------------------ metrics
    def snapshot(self) -> dict:
        """One JSON-able dump of what the engine knows about itself: registry
        counters, gauges and histograms, trace counts, the journal's health
        and the request timelines (the ``--metrics-json`` payload)."""
        return self.telemetry.snapshot(engine=self)

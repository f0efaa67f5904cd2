"""Serving telemetry: typed metrics registry, per-request latency
timelines, and online LO-BCQ quantization-error probes (a copy of
``repro/serving/telemetry.py`` — the same schema, bucket edges and key
tuples — plus the probes' device side, ``QuantProbeRecorder``).

Three layers, all host-side and sync-free at the default level:

* **MetricsRegistry** — typed counters / gauges / fixed-bucket histograms.
  The engine's ``stats`` is a read-only :class:`StatsView` over registry
  counters (the reference's pinned keys), while new consumers read the
  full ``snapshot()``.

* **RequestTimeline** — the lifecycle of one request: submit → (re)queue
  → admit → per-chunk prefill → first token → per-token decode →
  finish, with preemption/resubmission folded into the SAME timeline (a
  preempted-and-resumed request reports one submit, two admits, and a
  TTFT measured from its original submit).  Forked siblings get
  independent timelines that share the parent's prefill span list.
  Observations feed the TTFT / ITL (TPOT) / queue-time histograms.

* **QuantProbeSink** — opt-in (``Runtime.quant_probe``): the LO-BCQ
  activation-encode sites report per-site NMSE and codebook-selector
  occupancy; the sink attributes them to layers by arrival order (each
  site fires once per layer per launch, in layer order) and aggregates
  per (site, layer).  Where the reference fires an ordered host callback
  per site, the port's sites write into the device buffer of a
  :class:`QuantProbeRecorder` (a CUDA graph can capture that, not a
  callback), and the engine feeds the sink from it after each launch's
  sync, launches in their order.

Timestamps everywhere are ``time.perf_counter()`` seconds.  All
histogram bucket layouts are module-level constants — tests pin them, and
``docs/OBSERVABILITY.md`` catalogues them.
"""
from __future__ import annotations

import dataclasses
import json
from bisect import bisect_right
from collections import deque
from collections.abc import Mapping
from typing import Optional

import numpy as np

import torch

from repro_torch.core import bcq
from repro_torch.serving.events import TID_HOST, TraceJournal

SCHEMA_VERSION = 1

# ----------------------------------------------------- pinned bucket edges
# Upper bucket edges in seconds (one implicit +inf bucket past the last
# edge).  Pinned as constants: dashboards and the schema tests depend on
# the exact layout, so changing one is a schema version bump.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
               0.5, 1.0)
QUEUE_BUCKETS = (0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)
LAUNCH_BUCKETS = ITL_BUCKETS  # prefill-launch / decode-tick wall-clock
# activation-quant NMSE is dimensionless and spans decades → log-spaced
NMSE_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1,
                3e-1, 1.0)

# The engine counters of the pinned ``stats`` surface.  StatsView serves
# exactly these keys (peak_pages reads the PagePool's own high-water mark).
ENGINE_STAT_KEYS = (
    "prefix_hits", "prefix_misses", "preemptions", "prefix_evictions",
    "peak_pages", "decode_ticks", "prefill_chunks", "prefill_tokens",
    "prefill_tokens_skipped", "prefill_launches", "forks", "cow_copies",
    "shared_pages", "t_prefill_s", "t_decode_s",
)

# Fault-containment counters (docs/ROBUSTNESS.md).  Deliberately NOT part
# of ENGINE_STAT_KEYS: the legacy ``engine.stats`` Mapping is a pinned
# surface (tests snapshot/compare it), so robustness counters live only in
# the registry / snapshot() like every post-stats metric.  The first four
# mirror RequestError kinds one-to-one.
ROBUSTNESS_STAT_KEYS = (
    "quarantined", "shed", "expired", "cancelled", "audit_failures",
    "degraded_ticks",
)

# Host-tier swap counters (docs/ROBUSTNESS.md memory-tier table).  Also
# registry-only for the same reason as ROBUSTNESS_STAT_KEYS.  Always
# registered (zero with the tier off) so scrapers and
# tools/check_telemetry.py see a stable catalogue.  Accounting invariant
# checked by tools/check_chaos.py: swap_ins == verified_swapins +
# corrupt_swapins.
SWAP_STAT_KEYS = (
    "swap_outs", "swap_ins", "verified_swapins", "corrupt_swapins",
    "swap_bytes", "swap_skips", "recompressed_pages",
)


# ------------------------------------------------------------ instruments
class Counter:
    """Monotonically increasing value (int stays int until a float add)."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (set, not accumulated)."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``edges`` are upper bounds, plus one
    implicit +inf bucket.  Tracks count / sum / min / max alongside."""

    __slots__ = ("name", "unit", "edges", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, edges: tuple, unit: str = ""):
        assert tuple(edges) == tuple(sorted(edges)) and len(edges) > 0
        self.name = name
        self.unit = unit
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "unit": self.unit, "buckets": list(self.edges),
            "counts": list(self.counts), "count": self.count,
            "sum": self.sum, "mean": self.mean(),
            "min": self.min, "max": self.max,
        }


class MetricsRegistry:
    """Name → instrument store with get-or-create accessors."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str, unit: str = "") -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name, unit)
        return c

    def gauge(self, name: str, unit: str = "") -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name, unit)
        return g

    def histogram(self, name: str, edges: tuple, unit: str = "") -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, edges, unit)
        else:
            assert h.edges == tuple(float(e) for e in edges), (
                f"histogram {name!r} re-registered with different buckets"
            )
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {n: c.value for n, c in sorted(self.counters.items())},
            "gauges": {n: g.value for n, g in sorted(self.gauges.items())},
            "histograms": {
                n: h.snapshot() for n, h in sorted(self.histograms.items())
            },
        }


class StatsView(Mapping):
    """``engine.stats`` as a read-only view over the registry (plus the
    PagePool-owned ``peak_pages`` high-water mark).  ``dict(engine.stats)``,
    indexing, iteration, and equality behave like a dict's."""

    __slots__ = ("_engine",)

    def __init__(self, engine):
        self._engine = engine

    def __getitem__(self, key):
        if key not in ENGINE_STAT_KEYS:
            raise KeyError(key)
        if key == "peak_pages":
            return self._engine.pool_mgr.peak
        return self._engine.telemetry.registry.counter(key).value

    def __iter__(self):
        return iter(ENGINE_STAT_KEYS)

    def __len__(self):
        return len(ENGINE_STAT_KEYS)

    def __repr__(self):
        return f"StatsView({dict(self)!r})"


# ------------------------------------------------------ request timelines
@dataclasses.dataclass
class RequestTimeline:
    """Lifecycle timestamps of one request (perf_counter seconds).

    Preemption re-queues the request onto the SAME timeline (``admits``
    grows, ``t_submit`` stays), so derived TTFT spans the preemption.
    Forked siblings each get their own timeline; ``prefill_spans`` is the
    *shared* parent list (the siblings rode one prefill)."""

    rid: int
    sample_idx: int = 0
    t_submit: float = 0.0
    t_enqueued: float = 0.0  # last (re)enqueue — the queue-time anchor
    admits: list = dataclasses.field(default_factory=list)
    # (t_end, n_tokens) per prefill chunk this request advanced through
    chunks: list = dataclasses.field(default_factory=list)
    prefill_spans: list = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None
    t_last_tok: Optional[float] = None
    t_finish: Optional[float] = None
    n_tokens: int = 0
    preemptions: int = 0

    def ttft(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit

    def tpot(self) -> Optional[float]:
        """Mean inter-token latency after the first token."""
        end = self.t_finish if self.t_finish is not None else self.t_last_tok
        if self.t_first is None or end is None or self.n_tokens < 2:
            return None
        return (end - self.t_first) / (self.n_tokens - 1)

    def to_dict(self) -> dict:
        return {
            "rid": self.rid, "sample_idx": self.sample_idx,
            "t_submit": self.t_submit, "admits": list(self.admits),
            "n_chunks": len(self.chunks), "n_tokens": self.n_tokens,
            "preemptions": self.preemptions,
            "ttft_s": self.ttft(), "tpot_s": self.tpot(),
            "t_finish": self.t_finish,
        }


# --------------------------------------------------------------- telemetry
class Telemetry:
    """The engine-facing façade: registry + journal + timelines.

    Levels:
      * ``"counters"`` — registry counters/gauges only (the legacy stats
        surface); lifecycle hooks are no-ops, the journal is disabled.
        This is the bench's telemetry-off baseline.
      * ``"default"`` — counters + latency histograms + per-request
        timelines + the ring-buffer trace journal.  Still zero added
        device syncs: every timestamp is taken at a measurement point the
        engine already had.
    """

    LEVELS = ("counters", "default")

    def __init__(self, level: str = "default", trace_capacity: int = 8192,
                 max_timelines: int = 4096):
        assert level in self.LEVELS, f"level must be one of {self.LEVELS}"
        self.level = level
        self.detailed = level == "default"
        self.registry = MetricsRegistry()
        self.journal = TraceJournal(capacity=trace_capacity,
                                    enabled=self.detailed)
        self.timelines: deque = deque(maxlen=max_timelines)
        self._c_tl_dropped = self.registry.counter("timelines_dropped")
        self.h_ttft = self.registry.histogram("ttft_s", TTFT_BUCKETS, "s")
        self.h_itl = self.registry.histogram("itl_s", ITL_BUCKETS, "s")
        self.h_queue = self.registry.histogram("queue_time_s", QUEUE_BUCKETS, "s")
        self.h_prefill = self.registry.histogram(
            "prefill_launch_s", LAUNCH_BUCKETS, "s")
        self.h_decode = self.registry.histogram(
            "decode_tick_s", LAUNCH_BUCKETS, "s")
        # pipelined-engine split: launch span (decode_tick) vs the wait at
        # sync one tick later, plus the pure host gap between launches —
        # the device-bound criterion is host gap < decode span
        self.h_decode_sync = self.registry.histogram(
            "decode_sync_s", LAUNCH_BUCKETS, "s")
        self.h_host_gap = self.registry.histogram(
            "decode_host_gap_s", LAUNCH_BUCKETS, "s")
        self.g_inflight = self.registry.gauge(
            "pipeline_inflight", "launches")

    # ------------------------------------------------- request lifecycle
    def _timeline(self, req) -> Optional[RequestTimeline]:
        tl = getattr(req, "timeline", None)
        return tl if isinstance(tl, RequestTimeline) else None

    def on_submit(self, req, now: float) -> None:
        if not self.detailed:
            return
        if self._timeline(req) is None:
            req.timeline = RequestTimeline(
                rid=req.rid, sample_idx=req.sample_idx,
                t_submit=now, t_enqueued=now,
            )
            if len(self.timelines) == self.timelines.maxlen:
                self._c_tl_dropped.inc()
            self.timelines.append(req.timeline)

    def on_admit(self, req, now: float) -> None:
        tl = self._timeline(req)
        if tl is None:
            return
        tl.admits.append(now)
        self.h_queue.observe(now - tl.t_enqueued)

    def on_chunk(self, req, t0: float, t1: float, n_tokens: int) -> None:
        """One prefill chunk advanced this request (t0/t1 = the launch
        span it rode; non-chunked admission reports the whole prompt as
        one chunk)."""
        tl = self._timeline(req)
        if tl is None:
            return
        tl.chunks.append((t1, int(n_tokens)))
        tl.prefill_spans.append((t0, t1))

    def on_first_token(self, req, now: float) -> None:
        tl = self._timeline(req)
        if tl is None:
            return
        if tl.t_first is None:
            tl.t_first = now
            self.h_ttft.observe(now - tl.t_submit)
        elif tl.t_last_tok is not None:
            # resumed request: TTFT already credited, but the re-admission
            # prefill still emitted a real token — its gap (spanning the
            # preemption stall) is an honest inter-token latency
            self.h_itl.observe(now - tl.t_last_tok)
        tl.t_last_tok = now
        tl.n_tokens += 1

    def on_token(self, req, now: float) -> None:
        tl = self._timeline(req)
        if tl is None:
            return
        if tl.t_last_tok is not None:
            self.h_itl.observe(now - tl.t_last_tok)
        tl.t_last_tok = now
        tl.n_tokens += 1

    def on_finish(self, req, now: float) -> None:
        tl = self._timeline(req)
        if tl is not None:
            tl.t_finish = now

    def on_preempt(self, req, now: float) -> None:
        """Re-queue onto the same timeline: one submit, another admit
        later, queue time measured from this requeue."""
        tl = self._timeline(req)
        if tl is None:
            return
        tl.preemptions += 1
        tl.t_enqueued = now

    def on_fork_child(self, parent, child, now: float) -> None:
        """An independent timeline for a forked sibling: same submit /
        admit history (the sibling existed implicitly since submission),
        SHARED prefill-span list (one prefill served all siblings), own
        token timing from here on."""
        ptl = self._timeline(parent)
        if not self.detailed or ptl is None:
            return
        child.timeline = RequestTimeline(
            rid=child.rid, sample_idx=child.sample_idx,
            t_submit=ptl.t_submit, t_enqueued=ptl.t_enqueued,
            admits=list(ptl.admits), chunks=list(ptl.chunks),
            prefill_spans=ptl.prefill_spans,  # shared by design
        )
        if len(self.timelines) == self.timelines.maxlen:
            self._c_tl_dropped.inc()
        self.timelines.append(child.timeline)

    # ------------------------------------------------------- tick spans
    def prefill_launch(self, t0: float, t1: float, **args) -> None:
        if not self.detailed:
            return
        self.h_prefill.observe(t1 - t0)
        self.journal.span("prefill_launch", t0, t1, args=args or None)

    def decode_tick(self, t0: float, t1: float, **args) -> None:
        if not self.detailed:
            return
        self.h_decode.observe(t1 - t0)
        self.journal.span("decode_tick", t0, t1, args=args or None)

    def decode_sync(self, t0: float, t1: float, **args) -> None:
        """The sync-side wait of a pipelined decode launch (depth > 1):
        how long the host blocked for the oldest in-flight launch.  With
        ``profile_sync`` / depth 1 the wait is folded into ``decode_tick``
        instead (legacy attribution), so this histogram stays empty."""
        if not self.detailed:
            return
        self.h_decode_sync.observe(t1 - t0)
        self.journal.span("decode_sync", t0, t1, args=args or None)

    def decode_gap(self, gap: float) -> None:
        """Pure host time between consecutive steady-state decode
        launches (sync waits already subtracted by the engine)."""
        if not self.detailed:
            return
        self.h_host_gap.observe(gap)

    def pipeline_gauge(self, depth: int) -> None:
        self.g_inflight.set(int(depth))

    def instant(self, name: str, ts: Optional[float] = None, **args) -> None:
        self.journal.instant(name, ts, tid=TID_HOST, args=args or None)

    # -------------------------------------------------------- snapshots
    def observe_engine(self, engine) -> None:
        """Refresh the engine-state gauges (called at snapshot time, and
        cheap enough to call per tick if a scraper wants live values)."""
        g = self.registry.gauge
        g("pool_pages_used", "pages").set(engine.pool_mgr.used())
        g("pool_pages_free", "pages").set(engine.pool_mgr.available())
        g("pool_peak_pages", "pages").set(engine.pool_mgr.peak)
        prefix = engine.prefix.snapshot()
        g("prefix_reclaimable_pages", "pages").set(prefix["reclaimable_pages"])
        g("prefix_registered_pages", "pages").set(prefix["registered_pages"])
        g("prefix_host_pages", "pages").set(prefix.get("host_pages", 0))
        # host swap tier occupancy (zeros when the tier is disabled, so
        # the gauge catalogue is independent of configuration)
        tier = getattr(engine, "host_tier", None)
        g("host_pages_used", "pages").set(tier.used() if tier else 0)
        g("host_pages_capacity", "pages").set(tier.capacity if tier else 0)
        g("host_bytes_resident", "bytes").set(
            tier.bytes_resident if tier else 0)
        g("watermark_headroom", "pages").set(
            engine._available_pages() - engine.watermark)
        g("queue_depth", "requests").set(len(engine.queue))
        g("active_slots", "slots").set(len(engine._active()))
        g("degraded_mode").set(int(getattr(engine, "degraded", False)))
        # per-kind pool occupancy: one budget across heterogeneous page
        # kinds (kv / state / shared_ro), so capacity planning needs the
        # split, not just the total
        by_kind = engine.pool_mgr.used_by_kind()
        for kind, n in by_kind.items():
            g(f"pool_pages_{kind}", "pages").set(n)

    def snapshot(self, engine=None, probe_sink=None) -> dict:
        """One JSON-able dump of everything (the --metrics-json payload)."""
        if engine is not None:
            self.observe_engine(engine)
        snap = {"schema": SCHEMA_VERSION, "level": self.level}
        snap.update(self.registry.snapshot())
        if engine is not None:
            snap["trace_counts"] = engine.trace_counts()
        snap["journal"] = {
            "recorded": len(self.journal),
            "dropped": self.journal.dropped,
            "events": self.journal.counts(),
        }
        snap["timelines"] = {
            "count": len(self.timelines),
            "dropped": self._c_tl_dropped.value,
            # bounded detail: enough for offline TTFT/TPOT analysis
            "requests": [tl.to_dict() for tl in list(self.timelines)[:512]],
        }
        if probe_sink is not None:
            snap["quant_probes"] = probe_sink.report()
        return snap

    def dump_metrics(self, path: str, engine=None, probe_sink=None) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(engine=engine, probe_sink=probe_sink), f,
                      indent=1)

    def dump_trace(self, path: str) -> None:
        self.journal.dump(path)


# ------------------------------------------------------ quantization probes
class QuantProbeSink:
    """Aggregates LO-BCQ activation-quant probe emissions.

    The probe sites (``layers._emit_quant_probe``) report once per
    quantized GEMM site per launch: the site's static tag plus the
    (nmse, selector-occupancy) stats computed on the device, handed over
    by ``QuantProbeRecorder.feed`` in program order.  Every site fires
    exactly once per layer per launch, in layer order, so the sink
    attributes layer = arrival-count mod n_layers without threading
    indices through the layer loop.

    ``sample_every=k`` keeps one launch in k per site (the encode stats
    are still computed on device — sampling bounds *host* aggregation
    cost, and the whole probe path is opt-in anyway)."""

    def __init__(self, n_layers: int, registry: Optional[MetricsRegistry] = None,
                 sample_every: int = 1):
        assert n_layers >= 1 and sample_every >= 1
        self.n_layers = n_layers
        self.sample_every = sample_every
        self.registry = registry if registry is not None else MetricsRegistry()
        self._h_nmse = self.registry.histogram("act_quant_nmse", NMSE_BUCKETS)
        self._seen: dict[str, int] = {}  # site → total emissions
        self._agg: dict[tuple, dict] = {}  # (site, layer) → aggregate

    def __call__(self, site: str, nmse, occupancy) -> None:
        k = self._seen.get(site, 0)
        self._seen[site] = k + 1
        layer = k % self.n_layers
        if (k // self.n_layers) % self.sample_every:
            return  # decimated launch
        a = self._agg.get((site, layer))
        occ = np.asarray(occupancy, np.int64)
        if a is None:
            a = self._agg[(site, layer)] = {
                "count": 0, "nmse_sum": 0.0, "nmse_max": 0.0,
                "occupancy": np.zeros_like(occ),
            }
        v = float(nmse)
        a["count"] += 1
        a["nmse_sum"] += v
        a["nmse_max"] = max(a["nmse_max"], v)
        a["occupancy"] = a["occupancy"] + occ
        self._h_nmse.observe(v)

    @property
    def total_emissions(self) -> int:
        return sum(self._seen.values())

    def report(self) -> dict:
        """JSON-able per-(site, layer) summary."""
        sites: dict[str, dict] = {}
        for (site, layer), a in sorted(self._agg.items()):
            per = sites.setdefault(site, {})
            per[str(layer)] = {
                "count": a["count"],
                "nmse_mean": a["nmse_sum"] / max(a["count"], 1),
                "nmse_max": a["nmse_max"],
                "cluster_occupancy": [int(x) for x in a["occupancy"]],
            }
        return {
            "schema": SCHEMA_VERSION,
            "n_layers": self.n_layers,
            "sample_every": self.sample_every,
            "emissions": self.total_emissions,
            "nmse_histogram": self._h_nmse.snapshot(),
            "sites": sites,
        }


class QuantProbeRecorder:
    """The device side of the quant-error probe: what ``Runtime.quant_probe``
    holds.

    Each probe site of a launch (``layers._emit_quant_probe``) computes
    ``bcq.encode_stats`` of its activation on the device and writes the
    result IN PLACE into row k of two static buffers — ``nmse`` (rows,)
    f32 and ``occupancy`` (rows, N_c) int64 — k counting the launch's
    sites in program order from ``begin()``.  No host callback and no
    sync: a CUDA graph captures the writes, and each replay repeats them.
    Every launch of one model fires the same sites in the same order
    (``sites``, checked), so a launch's rows are ``len(sites)``.

    The engine takes a launch's rows with ``fetch()`` right after the
    launch (a copy into pinned host memory that the stream orders before
    the next launch's writes; a clone on the CPU) and hands them to
    ``feed`` after the launch's sync, which calls ``sink(site, nmse,
    occupancy)`` row by row."""

    def __init__(self, sink):
        self.sink = sink
        self.sites: list[str] = []
        self.nmse: Optional[torch.Tensor] = None
        self.occupancy: Optional[torch.Tensor] = None
        self._k = 0

    def begin(self) -> None:
        """A launch's forward starts: its first site writes row 0."""
        self._k = 0

    def record(self, site: str, x: torch.Tensor, codebooks: torch.Tensor,
               cfg: bcq.BCQConfig) -> None:
        """One site's emission: the encode stats of ``x`` (..., K) into the
        next row of the buffers."""
        nmse, occ = bcq.encode_stats(x, codebooks, cfg)
        k, self._k = self._k, self._k + 1
        if k < len(self.sites):
            if self.sites[k] != site:
                raise RuntimeError(f"probe site {k} is {site!r}, was {self.sites[k]!r}: every "
                                   "launch must fire the same sites in the same order")
        else:
            self.sites.append(site)
        if self.nmse is None or k >= self.nmse.shape[0]:
            self._grow(k + 1, x.device, occ.shape[0])
        self.nmse[k].copy_(nmse)
        self.occupancy[k].copy_(occ)

    def _grow(self, rows: int, device, n_codebooks: int) -> None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the probe buffers cannot be allocated inside a CUDA graph "
                               "capture: run a launch eagerly first")
        nmse = torch.zeros((max(rows, 2 * len(self.sites)),), dtype=torch.float32, device=device)
        occ = torch.zeros((nmse.shape[0], n_codebooks), dtype=torch.int64, device=device)
        if self.nmse is not None:
            nmse[: self.nmse.shape[0]] = self.nmse
            occ[: self.occupancy.shape[0]] = self.occupancy
        self.nmse, self.occupancy = nmse, occ

    def fetch(self) -> tuple:
        """The last launch's rows, taken before the next launch overwrites
        them: (sites, nmse, occupancy) on the host — pinned copies that land
        by the launch's sync on the card, clones on the CPU."""
        n = len(self.sites)
        nmse, occ = self.nmse[:n], self.occupancy[:n]
        if nmse.device.type != "cuda":
            return list(self.sites), nmse.clone(), occ.clone()
        out = []
        for t in (nmse, occ):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        return (list(self.sites), *out)

    def feed(self, fetched: tuple) -> None:
        """Hand a fetched launch to the sink, row by row (after its sync)."""
        sites, nmse, occ = fetched
        nmse, occ = nmse.numpy(), occ.numpy()
        for k, site in enumerate(sites):
            self.sink(site, float(nmse[k]), occ[k])

"""Tick-level event journal exported as Chrome-trace / Perfetto JSON (a copy
of ``repro/serving/events.py``: the port imports nothing of the reference).

The journal is a bounded ring buffer of **completed** spans and instant
markers.  Recording is a deque append of plain python values — no device
interaction, no syncs — so it can ride the serving hot path at the
default telemetry level.  Timestamps are ``time.perf_counter()`` floats
taken at the engine's *existing* measurement points (the perf_counter /
synchronization sites that already feed the latency split), so
enabling the journal adds zero device synchronizations.

Export follows the Chrome Trace Event Format (the subset Perfetto and
chrome://tracing both load): a ``traceEvents`` list of paired ``B``/``E``
duration events plus ``i`` instants, with microsecond ``ts`` relative to
the first recorded event.  Spans are grouped on synthetic threads
(tid 0 = host scheduling, tid 1 = device launches) named via ``M``
metadata events.

Ring-buffer semantics: the newest ``capacity`` records win; ``dropped``
counts what the ring has forgotten, so a consumer can tell a short trace
from a truncated one.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional

SCHEMA_VERSION = 1

# synthetic thread ids — one Perfetto track each
TID_HOST = 0  # scheduler / admission work and instant markers
TID_DEVICE = 1  # prefill / decode launch spans (wall-clock around launch)

_THREAD_NAMES = {TID_HOST: "host scheduling", TID_DEVICE: "device launches"}


class TraceJournal:
    """Bounded ring buffer of spans + instants with Chrome-trace export."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        assert capacity > 0
        self.capacity = capacity
        self.enabled = enabled
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0  # total records ever; also the stable sort tiebreak

    # ------------------------------------------------------------ recording
    def span(self, name: str, t0: float, t1: float, *, cat: str = "serving",
             tid: int = TID_DEVICE, args: Optional[dict] = None) -> None:
        """Record a completed [t0, t1] span (perf_counter seconds)."""
        if not self.enabled:
            return
        self._buf.append(("span", name, cat, tid, t0, max(t1, t0), args, self._seq))
        self._seq += 1

    def instant(self, name: str, ts: Optional[float] = None, *,
                cat: str = "serving", tid: int = TID_HOST,
                args: Optional[dict] = None) -> None:
        """Record a point event (defaults to 'now')."""
        if not self.enabled:
            return
        if ts is None:
            ts = time.perf_counter()
        self._buf.append(("instant", name, cat, tid, ts, ts, args, self._seq))
        self._seq += 1

    # ------------------------------------------------------------- introspect
    def __len__(self) -> int:
        return len(self._buf)

    @property
    def total(self) -> int:
        return self._seq

    @property
    def dropped(self) -> int:
        return self._seq - len(self._buf)

    def counts(self) -> dict:
        """Record count per event name (journal health / tests)."""
        out: dict[str, int] = {}
        for rec in self._buf:
            out[rec[1]] = out.get(rec[1], 0) + 1
        return out

    def clear(self) -> None:
        self._buf.clear()

    # ---------------------------------------------------------------- export
    def to_chrome_trace(self, pid: int = 1) -> dict:
        """The journal as a Chrome Trace Event Format object.

        Spans become paired B/E events; both phases of one span share the
        record's sequence number, so the stable (ts, seq, phase-order)
        sort keeps every pair matched and ``ts`` monotonic even when two
        records share a float timestamp."""
        base = min((rec[4] for rec in self._buf), default=0.0)

        def us(t: float) -> float:
            return round((t - base) * 1e6, 3)

        raw = []  # (ts_us, seq, phase_rank, event)
        for kind, name, cat, tid, t0, t1, args, seq in self._buf:
            common = {"name": name, "cat": cat, "pid": pid, "tid": tid}
            if args:
                common["args"] = dict(args)
            if kind == "span":
                raw.append((us(t0), seq, 0, {**common, "ph": "B", "ts": us(t0)}))
                raw.append((us(t1), seq, 1, {**common, "ph": "E", "ts": us(t1)}))
            else:
                raw.append((us(t0), seq, 0,
                            {**common, "ph": "i", "ts": us(t0), "s": "t"}))
        raw.sort(key=lambda r: (r[0], r[1], r[2]))

        meta = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "paged-engine"}},
        ] + [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(_THREAD_NAMES.items())
        ]
        return {
            "traceEvents": meta + [r[3] for r in raw],
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": SCHEMA_VERSION,
                "recorded": len(self._buf),
                "dropped": self.dropped,
            },
        }

    def dump(self, path: str, pid: int = 1) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(pid=pid), f)
